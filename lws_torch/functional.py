"""Free-function phase recovery with the reference signatures.

Counterpart of lws_tpu's extspec / batch_lws / nofuture_lws / online_lws
(python/lws.pyx:146-375): each takes a host complex spectrogram and the
weight tensors `W` (Qprime, Q, L+1) of `create_weights`, and returns a
host complex array. The extra keywords `device` and `backend` place the
work: CUDA by default, as every entry point of the port; device="cpu"
runs the plain PyTorch versions. backend="auto" (the default) sends CUDA
data to the hand-written float32 kernels; backend="torch" runs the plain
versions on any device.

The dtype rule: complex64 input runs in float32 and returns complex64. A
complex128 input (numpy's default) runs in float64 and returns
complex128 on the CPU and with backend="torch"; on CUDA with
backend="auto" it runs in float32 through the kernels and returns
complex64, as lws_tpu does on its chip, where JAX without x64 computes
complex128 input in float32.

The sweeps run one jacobi in-frame pass, as lws_tpu's free functions do
(the processor's per-Q in-frame defaults are not applied here). `order`
("gs", "jacobi", "jacobi_mxu") is lws_tpu's: "gs" goes to the sweep kernel
(or its plain version), the Jacobi orders to their plain whole-grid sweeps
on every device, their banded matmuls in full float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.batch import ORDERS, lws_sweeps
from .core.stencil import freq_extend, make_stencil, make_time_halos, merge, split, time_extend
from .ops.lws_sweeps import tiled_lws_sweeps
from .ops.online import packed_rtisi_la
from .weights import build_stencil

__all__ = ["extspec", "batch_lws", "nofuture_lws", "online_lws"]


def _stencil_from_W(W, n_bins, v, dtype, device):
    W = np.asarray(W)
    Q, L = W.shape[1], W.shape[2] - 1
    return make_stencil(build_stencil(W, n_bins), Q, L, v=v, device=device, dtype=dtype)


def _check_backend(backend):
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")


def _work_dtype(dtype, device, backend) -> torch.dtype:
    """The module's dtype rule: float64 for complex128 input unless the
    kernels run it (CUDA, backend="auto"), float32 otherwise."""
    kernels = device.type == "cuda" and backend == "auto"
    return torch.float64 if dtype == np.complex128 and not kernels else torch.float32


def _split_in(S, device, backend="auto"):
    """Host complex array -> pair on `device` + real dtype (_work_dtype)."""
    S = np.asarray(S)
    if S.shape[-1] % 2 == 0:
        raise ValueError("Please only include non-negative frequencies in the input spectrogram.")
    rdtype = _work_dtype(S.dtype, device, backend)
    return split(S, dtype=rdtype, device=device), rdtype


def _thr(thresholds, rdtype, device):
    return torch.as_tensor(np.asarray(thresholds, dtype=np.float64)).to(device, rdtype)


def extspec(S, L, Q, device=None):
    """Hermitian / edge-replicated extended spectrogram (python/lws.pyx:146-157):
    (..., T, F) -> (..., T + 2(Q-1), F + 2L)."""
    dev = resolve_device(device)
    (sr, si), _ = _split_in(S, dev, backend="torch")  # no kernel: the input dtype
    er, ei = freq_extend(sr, si, L)
    top_r, bot_r = make_time_halos(er, Q)
    top_i, bot_i = make_time_halos(ei, Q)
    return merge(time_extend(er, top_r, bot_r), time_extend(ei, top_i, bot_i))


def _sweeps(S, W, thresholds, order, device, backend, v):
    """Sweeps of the stencil of W at visibility v (None: the batch one)."""
    if order not in ORDERS:
        raise ValueError(f"lws_torch: order must be one of {ORDERS}, got {order!r}")
    _check_backend(backend)
    dev = resolve_device(device)
    pair, rdtype = _split_in(S, dev, backend)
    thr = _thr(thresholds, rdtype, dev)
    if thr.shape[0] == 0:
        return merge(*pair)
    Q = np.asarray(W).shape[1]
    st = _stencil_from_W(W, pair[0].shape[-1], Q - 1 if v is None else v, rdtype, dev)
    if order != "gs":
        return merge(*lws_sweeps(*pair, st=st, thresholds=thr, order=order))
    return merge(*tiled_lws_sweeps(*pair, st=st, thresholds=thr, backend=backend))


def batch_lws(S, W, thresholds, use_simplifications=True, order="gs", device=None,
              backend="auto"):
    """Batch-mode LWS phase reconstruction (python/lws.pyx:209-258).
    `use_simplifications` is accepted for signature parity: W's first axis
    (Qprime) already encodes summarized vs fractional weights."""
    del use_simplifications
    return _sweeps(S, W, thresholds, order, device, backend, v=None)


def nofuture_lws(S, W, thresholds, use_simplifications=True, order="gs", device=None,
                 backend="auto"):
    """No-future LWS initialisation pass (python/lws.pyx:261-311)."""
    del use_simplifications
    return _sweeps(S, W, thresholds, order, device, backend, v=-1)


def online_lws(S, W, W_ai, W_af, thresholds, LA, fshift=None, use_simplifications=True,
               device=None, backend="auto"):
    """Online-mode LWS phase reconstruction (python/lws.pyx:314-375).
    `fshift` is accepted for signature parity: the reference uses it only
    for the dead update_type == 1 self-term (python/lws.pyx:339, 363)."""
    del use_simplifications, fshift
    _check_backend(backend)
    dev = resolve_device(device)
    pair, rdtype = _split_in(S, dev, backend)
    thr = _thr(thresholds, rdtype, dev)
    if thr.shape[0] == 0:
        return merge(*pair)
    F = pair[0].shape[-1]
    Q = np.asarray(W).shape[1]
    st_ai = _stencil_from_W(W_ai, F, -1, rdtype, dev)
    st_af = _stencil_from_W(W_af, F, 0, rdtype, dev)
    st_la = [_stencil_from_W(W, F, min(d, Q - 1), rdtype, dev) for d in range(1, LA + 1)]
    return merge(*packed_rtisi_la(*pair, st_la=st_la, st_ai=st_ai, st_af=st_af,
                                  thresholds=thr, backend=backend))
