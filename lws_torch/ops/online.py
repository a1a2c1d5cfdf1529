"""Wrapper of the CUDA online kernel (lws_torch/csrc/lws_online.cu).

Counterpart of the host half of lws_tpu.ops.pallas_packed.packed_rtisi_la
and of its fit gate `online_supported`, without the TPU launch plan: there
are no sublane packs, lane padding or VMEM budget, and the lane skip is not
carried over (it raises). The wrapper

  - checks device, dtype and shapes;
  - computes amp = |S| and the per-item thresholds thr[b, h] =
    thresholds[h] * mean amp[b] in torch, as the plain version does;
  - stacks the 2+LA weight sets [st_ai, st_af, *st_la] and lists each set's
    live taps from the host `nz` masks;
  - allocates a separate output and launches the kernel once, counting the
    launch.

CPU tensors, and backend="torch", take the plain version
(lws_torch.core.online.rtisi_la). A CUDA tensor the kernel does not take
(float64, a window too wide for shared memory, look_ahead > MAX_LA) raises
a ValueError; nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.online import rtisi_la as plain_rtisi_la
from ..core.stencil import Stencil, _parse_colors
from . import _build
from .lws_sweeps import MAX_Q

__all__ = ["packed_rtisi_la", "online_supported", "online_weight_sets",
           "online_smem_bytes", "MAX_LA", "LAUNCHES"]

# Longest look-ahead the kernel takes (the JAX kernel's limit).
MAX_LA = 8

# Shared memory one block may use on sm_90 (the kernel's kSmemLimit).
SMEM_LIMIT = 232448

# Kernel launches so far; the main path's run is read as a difference.
LAUNCHES = 0

_LIB = "lws_online"


def _library():
    lib = _build.load(_LIB)
    if lib.lws_online_launch.argtypes is None:
        lib.lws_online_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.lws_online_launch.restype = ctypes.c_int
        lib.lws_online_error_string.argtypes = [ctypes.c_int]
        lib.lws_online_error_string.restype = ctypes.c_char_p
    return lib


def online_smem_bytes(F: int, Q: int, L: int, LA: int) -> int:
    """Shared memory of one block: the (LA+Q)-row ring (re, im), six F-rows
    of scratch, and the tap lists (the kernel's lws_online_smem_bytes)."""
    S = 2 + LA
    return 4 * (2 * (LA + Q) + 6) * F + 4 * (S * (2 * Q - 1) * (2 * L + 1) + 2 * S)


def online_supported(F: int, Q: int, L: int, LA: int) -> bool:
    """Whether the online kernel takes this geometry."""
    return (1 <= Q <= MAX_Q and 0 <= LA <= MAX_LA and F >= L + 1
            and online_smem_bytes(F, Q, L, LA) <= SMEM_LIMIT)


def online_weight_sets(st_la: list[Stencil], st_ai: Stencil, st_af: Stencil):
    """(wr, wi, taps, counts): the weight sets [st_ai, st_af, *st_la]
    stacked (S, 2Q-1, 2L+1, F), and for each set the indices dr*(2L+1)+dk
    of its live off-centre taps then of its live centre taps (S, R*K, zero
    padded), with their counts (S, 2), from the host nz masks."""
    sets = [st_ai, st_af, *st_la]
    Q, L = st_af.Q, st_af.L
    R, K, c = 2 * Q - 1, 2 * L + 1, Q - 1
    taps = np.zeros((len(sets), R * K), dtype=np.int32)
    counts = np.zeros((len(sets), 2), dtype=np.int32)
    for s, st in enumerate(sets):
        off = [dr * K + dk for dr in range(R) for dk in range(K)
               if dr != c and st.nz[dr, dk]]
        cen = [c * K + dk for dk in range(K) if st.nz[c, dk]]
        taps[s, :len(off) + len(cen)] = off + cen
        counts[s] = len(off), len(cen)
    wr = torch.stack([st.Wr for st in sets]).contiguous()
    wi = torch.stack([st.Wi for st in sets]).contiguous()
    return wr, wi, taps, counts


def packed_rtisi_la(
    sr: torch.Tensor,
    si: torch.Tensor,
    st_la: list[Stencil],
    st_ai: Stencil,
    st_af: Stencil,
    thresholds,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    backend: str = "auto",
    *,
    lane_skip: bool = False,
):
    """Online RTISI-LA over (..., T, F), len(thresholds) rounds per frame.

    backend="auto" launches the kernel for CUDA float32 tensors and runs the
    plain version for CPU tensors; backend="torch" runs the plain version
    anywhere. `inner_passes` / `inner_scheme` follow lws_tpu's rtisi_la (the
    frame scan), which the kernel and the plain version both take.
    """
    if lane_skip:
        raise ValueError("lws_torch: lane_skip is a TPU launch knob of "
                         "lws_tpu.ops.packed_rtisi_la and is not carried to the port")
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")
    if backend == "torch" or sr.device.type == "cpu":
        return plain_rtisi_la(sr, si, st_la, st_ai, st_af, thresholds,
                              inner_passes=inner_passes, inner_scheme=inner_scheme)
    if sr.device.type != "cuda":
        raise ValueError(f"lws_torch: the online kernel runs on CUDA, got {sr.device}")
    return _launch(sr, si, st_la, st_ai, st_af, thresholds, inner_passes, inner_scheme)


def _launch(sr, si, st_la, st_ai, st_af, thresholds, inner_passes, inner_scheme):
    global LAUNCHES
    dev = sr.device
    sets = [st_ai, st_af, *st_la]
    tensors = [("sr", sr), ("si", si)] + [(f"weight set {k}", t) for k, st in
                                          enumerate(sets) for t in (st.Wr, st.Wi)]
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(
                f"lws_torch: the CUDA online kernel takes float32, {name} is "
                f"{t.dtype}; use backend='torch' for the plain version")
        if t.device != dev:
            raise ValueError(f"lws_torch: {name} is on {t.device}, sr on {dev}")
    if si.shape != sr.shape or sr.ndim < 2:
        raise ValueError(f"lws_torch: sr {tuple(sr.shape)} / si {tuple(si.shape)}")
    Q, L, LA = st_af.Q, st_af.L, len(st_la)
    shape = sr.shape
    T, F = shape[-2:]
    for st in sets:
        if (st.Q, st.L) != (Q, L) or tuple(st.Wr.shape) != (2 * Q - 1, 2 * L + 1, F):
            raise ValueError(f"lws_torch: stencil {tuple(st.Wr.shape)} (Q={st.Q}, "
                             f"L={st.L}) does not fit Q={Q}, L={L}, F={F}")
    if not online_supported(F, Q, L, LA):
        raise ValueError(
            f"lws_torch: the online kernel does not take F={F}, Q={Q}, L={L}, "
            f"look_ahead={LA} (Q <= {MAX_Q}, look_ahead <= {MAX_LA}, and "
            f"{online_smem_bytes(F, Q, L, LA)} B of shared memory against "
            f"{SMEM_LIMIT}); use backend='torch' for the plain version")
    thresholds = torch.as_tensor(thresholds, device=dev).to(torch.float32)
    iters = int(thresholds.shape[0])
    if iters == 0:
        return sr, si

    B = sr.numel() // (T * F)
    sr3 = sr.reshape(B, T, F).contiguous()
    si3 = si.reshape(B, T, F).contiguous()
    amp = torch.sqrt(sr3 * sr3 + si3 * si3)
    thr = (thresholds[None, :] * amp.mean(dim=(-2, -1))[:, None]).contiguous()
    wr, wi, taps, counts = online_weight_sets(st_la, st_ai, st_af)
    taps = torch.as_tensor(taps, device=dev)
    counts = torch.as_tensor(counts, device=dev)
    out_r = torch.empty_like(sr3)
    out_i = torch.empty_like(si3)
    # per set, the kernel runs the colors or the passes only where the set
    # has centre taps, as update_frame does
    if inner_scheme == "jacobi":
        passes, color_k, rounds = max(1, int(inner_passes)), 0, 1
    else:
        (color_k, rounds), passes = _parse_colors(inner_scheme), 1

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lws_online_launch(
        sr3.data_ptr(), si3.data_ptr(), amp.data_ptr(), out_r.data_ptr(),
        out_i.data_ptr(), wr.data_ptr(), wi.data_ptr(), taps.data_ptr(),
        counts.data_ptr(), thr.data_ptr(), B, T, F, Q, L, LA, iters, passes,
        color_k, rounds, stream)
    if err != 0:
        msg = lib.lws_online_error_string(err).decode()
        raise RuntimeError(f"lws_torch: lws_online launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out_r.reshape(shape), out_i.reshape(shape)
