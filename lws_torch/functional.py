"""Free-function phase recovery with the reference signatures.

Counterpart of lws_tpu's extspec / batch_lws / nofuture_lws / online_lws
(python/lws.pyx:146-375): each takes a host complex spectrogram and the
weight tensors `W` (Qprime, Q, L+1) of `create_weights`, and returns a
host complex array. A complex128 input runs in float64, anything else in
float32, as in lws_tpu. The extra keyword `device` places the work: CUDA
by default, as every entry point of the port, where float32 runs through
the hand-written kernels; device="cpu" runs the plain PyTorch versions.

The sweeps run one jacobi in-frame pass, as lws_tpu's free functions do
(the processor's per-Q in-frame defaults are not applied here).
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.stencil import freq_extend, make_stencil, make_time_halos, merge, split, time_extend
from .ops.lws_sweeps import tiled_lws_sweeps
from .ops.online import packed_rtisi_la
from .weights import build_stencil

__all__ = ["extspec", "batch_lws", "nofuture_lws", "online_lws"]


def _stencil_from_W(W, n_bins, v, dtype, device):
    W = np.asarray(W)
    Q, L = W.shape[1], W.shape[2] - 1
    return make_stencil(build_stencil(W, n_bins), Q, L, v=v, device=device, dtype=dtype)


def _split_in(S, device):
    """Host complex array -> pair on `device` + real dtype (complex128 in,
    float64 planes out; float32 otherwise)."""
    S = np.asarray(S)
    if S.shape[-1] % 2 == 0:
        raise ValueError("Please only include non-negative frequencies in the input spectrogram.")
    rdtype = torch.float64 if S.dtype == np.complex128 else torch.float32
    return split(S, dtype=rdtype, device=device), rdtype


def _thr(thresholds, rdtype, device):
    return torch.as_tensor(np.asarray(thresholds, dtype=np.float64)).to(device, rdtype)


def extspec(S, L, Q, device=None):
    """Hermitian / edge-replicated extended spectrogram (python/lws.pyx:146-157):
    (..., T, F) -> (..., T + 2(Q-1), F + 2L)."""
    dev = resolve_device(device)
    (sr, si), _ = _split_in(S, dev)
    er, ei = freq_extend(sr, si, L)
    top_r, bot_r = make_time_halos(er, Q)
    top_i, bot_i = make_time_halos(ei, Q)
    return merge(time_extend(er, top_r, bot_r), time_extend(ei, top_i, bot_i))


def _sweeps(S, W, thresholds, order, device, v):
    """Sweeps of the stencil of W at visibility v (None: the batch one)."""
    if order != "gs":
        raise NotImplementedError(
            f"lws_torch: order={order!r} is not ported yet (ROADMAP A12)")
    dev = resolve_device(device)
    pair, rdtype = _split_in(S, dev)
    thr = _thr(thresholds, rdtype, dev)
    if thr.shape[0] == 0:
        return merge(*pair)
    Q = np.asarray(W).shape[1]
    st = _stencil_from_W(W, pair[0].shape[-1], Q - 1 if v is None else v, rdtype, dev)
    return merge(*tiled_lws_sweeps(*pair, st=st, thresholds=thr))


def batch_lws(S, W, thresholds, use_simplifications=True, order="gs", device=None):
    """Batch-mode LWS phase reconstruction (python/lws.pyx:209-258).
    `use_simplifications` is accepted for signature parity: W's first axis
    (Qprime) already encodes summarized vs fractional weights."""
    del use_simplifications
    return _sweeps(S, W, thresholds, order, device, v=None)


def nofuture_lws(S, W, thresholds, use_simplifications=True, order="gs", device=None):
    """No-future LWS initialisation pass (python/lws.pyx:261-311)."""
    del use_simplifications
    return _sweeps(S, W, thresholds, order, device, v=-1)


def online_lws(S, W, W_ai, W_af, thresholds, LA, fshift=None, use_simplifications=True,
               device=None):
    """Online-mode LWS phase reconstruction (python/lws.pyx:314-375).
    `fshift` is accepted for signature parity: the reference uses it only
    for the dead update_type == 1 self-term (python/lws.pyx:339, 363)."""
    del use_simplifications, fshift
    dev = resolve_device(device)
    pair, rdtype = _split_in(S, dev)
    thr = _thr(thresholds, rdtype, dev)
    if thr.shape[0] == 0:
        return merge(*pair)
    F = pair[0].shape[-1]
    Q = np.asarray(W).shape[1]
    st_ai = _stencil_from_W(W_ai, F, -1, rdtype, dev)
    st_af = _stencil_from_W(W_af, F, 0, rdtype, dev)
    st_la = [_stencil_from_W(W, F, min(d, Q - 1), rdtype, dev) for d in range(1, LA + 1)]
    return merge(*packed_rtisi_la(*pair, st_la=st_la, st_ai=st_ai, st_af=st_af,
                                  thresholds=thr))
