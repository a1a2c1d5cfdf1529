"""Wrappers of the CUDA online kernels (lws_torch/csrc/lws_online.cu).

Counterparts of the host halves of lws_tpu.ops.pallas_packed's
packed_rtisi_la (kernel K3) and online_chunk / online_chunk_init (K4, the
chunked stream step), and of their fit gate `online_supported`, without the
TPU launch plan: there are no sublane packs, lane padding or VMEM budget,
and the lane skip is not carried over (it raises). Each wrapper

  - checks device, dtype and shapes;
  - computes amp = |S| and the thresholds in torch: thr[b, h] =
    thresholds[h] * mean amp[b] for K3, thr[b, m, h] = thresholds[h] *
    means[b, m] for K4, as the plain versions do;
  - stacks the 2+LA weight sets [st_ai, st_af, *st_la] and lists each set's
    live taps from the host `nz` masks;
  - allocates separate outputs (K4: a new state too) and launches its
    kernel once, counting the launch (LAUNCHES, CHUNK_LAUNCHES).

CPU tensors, and backend="torch", take the plain versions
(lws_torch.core.online.rtisi_la / online_chunk). A CUDA tensor a kernel does
not take (float64, a window too wide for shared memory, look_ahead >
MAX_LA) raises a ValueError that names backend="torch"; nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.online import ChunkState, online_chunk_init
from ..core.online import online_chunk as plain_online_chunk
from ..core.online import rtisi_la as plain_rtisi_la
from ..core.stencil import Stencil, _parse_colors
from . import _build
from .lws_sweeps import MAX_Q, SMEM_LIMIT

__all__ = ["packed_rtisi_la", "online_chunk", "online_chunk_init", "ChunkState",
           "online_supported", "online_weight_sets", "device_weight_sets", "online_smem_bytes",
           "check_online", "MAX_LA", "LAUNCHES", "CHUNK_LAUNCHES"]

# Longest look-ahead the kernel takes (the JAX kernel's limit).
MAX_LA = 8

# Kernel launches so far (K3, K4); a path's run is read as a difference.
LAUNCHES = 0
CHUNK_LAUNCHES = 0

_LIB = "lws_online"


def _library():
    lib = _build.load(_LIB)
    if lib.lws_online_launch.argtypes is None:
        lib.lws_online_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.lws_online_launch.restype = ctypes.c_int
        lib.lws_online_chunk_launch.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.lws_online_chunk_launch.restype = ctypes.c_int
        lib.lws_online_error_string.argtypes = [ctypes.c_int]
        lib.lws_online_error_string.restype = ctypes.c_char_p
    return lib


def online_smem_bytes(F: int, Q: int, L: int, LA: int, chunk: bool = False) -> int:
    """Shared memory of one block: the (LA+Q)-row ring (re, im), six F-rows
    of scratch, the tap lists, and for K4 (chunk=True) the LA+1 amp rows
    (the kernels' lws_online_smem_bytes / lws_online_chunk_smem_bytes)."""
    S = 2 + LA
    amp_rows = LA + 1 if chunk else 0
    return (4 * (2 * (LA + Q) + 6 + amp_rows) * F
            + 4 * (S * (2 * Q - 1) * (2 * L + 1) + 2 * S))


def online_supported(F: int, Q: int, L: int, LA: int, chunk: bool = False) -> bool:
    """Whether the online kernel (chunk=True: K4) takes this geometry."""
    return (1 <= Q <= MAX_Q and 0 <= LA <= MAX_LA and F >= L + 1
            and online_smem_bytes(F, Q, L, LA, chunk) <= SMEM_LIMIT)


def check_online(F: int, Q: int, L: int, LA: int, dtype, chunk: bool = False) -> None:
    """Raise a ValueError naming backend='torch' unless the online kernel
    (chunk=True: K4) takes `dtype` data of this geometry. StreamingLWS
    calls it at construction, the wrappers before each launch."""
    if dtype != torch.float32:
        raise ValueError(f"lws_torch: the CUDA online kernels take float32, got {dtype}; "
                         "use backend='torch' for the plain version")
    if not online_supported(F, Q, L, LA, chunk):
        raise ValueError(
            f"lws_torch: the {'chunked ' if chunk else ''}online kernel does not take "
            f"F={F}, Q={Q}, L={L}, look_ahead={LA} (Q <= {MAX_Q}, look_ahead <= "
            f"{MAX_LA}, and {online_smem_bytes(F, Q, L, LA, chunk)} B of shared memory "
            f"against {SMEM_LIMIT}); use backend='torch' for the plain version")


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


def _check(sr, si, st_la, st_ai, st_af, tensors, chunk):
    """Device, dtype and shape checks shared by the two kernels' wrappers
    (`tensors`: more (name, tensor) pairs to hold to sr's dtype and device)."""
    dev = sr.device
    sets = [st_ai, st_af, *st_la]
    tensors = [("sr", sr), ("si", si)] + tensors + [
        (f"weight set {k}", t) for k, st in enumerate(sets) for t in (st.Wr, st.Wi)]
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(
                f"lws_torch: the CUDA online kernels take float32, {name} is "
                f"{t.dtype}; use backend='torch' for the plain version")
        if t.device != dev:
            raise ValueError(f"lws_torch: {name} is on {t.device}, sr on {dev}")
    if si.shape != sr.shape or sr.ndim < 2:
        raise ValueError(f"lws_torch: sr {tuple(sr.shape)} / si {tuple(si.shape)}")
    Q, L, LA = st_af.Q, st_af.L, len(st_la)
    F = sr.shape[-1]
    for st in sets:
        if (st.Q, st.L) != (Q, L) or tuple(st.Wr.shape) != (2 * Q - 1, 2 * L + 1, F):
            raise ValueError(f"lws_torch: stencil {tuple(st.Wr.shape)} (Q={st.Q}, "
                             f"L={st.L}) does not fit Q={Q}, L={L}, F={F}")
    check_online(F, Q, L, LA, torch.float32, chunk)


def _scheme(inner_passes, inner_scheme):
    """(passes, color_k, rounds): per set, the kernels run the colors or
    the passes only where the set has centre taps, as update_frame does."""
    if inner_scheme == "jacobi":
        return max(1, int(inner_passes)), 0, 1
    (color_k, rounds), passes = _parse_colors(inner_scheme), 1
    return passes, color_k, rounds


def _launch(sr, si, st_la, st_ai, st_af, thresholds, inner_passes, inner_scheme):
    global LAUNCHES
    _check(sr, si, st_la, st_ai, st_af, [], chunk=False)
    dev = sr.device
    Q, L, LA = st_af.Q, st_af.L, len(st_la)
    shape = sr.shape
    T, F = shape[-2:]
    thresholds = torch.as_tensor(thresholds, device=dev).to(torch.float32)
    iters = int(thresholds.shape[0])
    if iters == 0:
        return sr, si

    B = sr.numel() // (T * F)
    sr3 = sr.reshape(B, T, F).contiguous()
    si3 = si.reshape(B, T, F).contiguous()
    amp = torch.sqrt(sr3 * sr3 + si3 * si3)
    thr = (thresholds[None, :] * amp.mean(dim=(-2, -1))[:, None]).contiguous()
    wr, wi, taps, counts = device_weight_sets(st_la, st_ai, st_af)
    out_r = torch.empty_like(sr3)
    out_i = torch.empty_like(si3)
    passes, color_k, rounds = _scheme(inner_passes, inner_scheme)

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lws_online_launch(
        sr3.data_ptr(), si3.data_ptr(), amp.data_ptr(), out_r.data_ptr(),
        out_i.data_ptr(), wr.data_ptr(), wi.data_ptr(), taps.data_ptr(),
        counts.data_ptr(), thr.data_ptr(), B, T, F, Q, L, LA, iters, passes,
        color_k, rounds, stream)
    _raise_on(lib, err)
    LAUNCHES += 1
    return out_r.reshape(shape), out_i.reshape(shape)


def _raise_on(lib, err):
    if err != 0:
        msg = lib.lws_online_error_string(err).decode()
        raise RuntimeError(f"lws_torch: lws_online launch failed: {msg} ({err})")


def online_chunk(
    sr: torch.Tensor,
    si: torch.Tensor,
    state: ChunkState,
    means: torch.Tensor,
    st_la: list[Stencil],
    st_ai: Stencil,
    st_af: Stencil,
    thresholds,
    n_live=None,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    backend: str = "auto",
    *,
    weights=None,
    lane_skip: bool = False,
):
    """Advance B streams by the N frames (sr, si) of shape (B, N, F) from
    `state` (online_chunk_init or a previous call), with the threshold
    scale means (B, N) at each frame; steps m >= n_live are drain steps.

    Returns (committed_r, committed_i, new_state), row m holding the final
    value of absolute frame state.seen + m - LA (lws_torch.core.online.
    online_chunk). backend="auto" launches K4 for CUDA float32 tensors and
    runs the plain version for CPU tensors; backend="torch" runs the plain
    version anywhere. `state` is not modified. `weights`: what
    device_weight_sets returns for these stencils, for a caller that
    launches often (StreamingLWS): without it each launch builds the weight
    sets and copies the tap lists to the card, a host sync.
    """
    if lane_skip:
        raise ValueError("lws_torch: lane_skip is a TPU launch knob of "
                         "lws_tpu.ops.online_chunk and is not carried to the port")
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")
    if backend == "torch" or sr.device.type == "cpu":
        return plain_online_chunk(sr, si, state, means, st_la, st_ai, st_af, thresholds,
                                  n_live, inner_passes, inner_scheme)
    if sr.device.type != "cuda":
        raise ValueError(f"lws_torch: the online kernel runs on CUDA, got {sr.device}")
    return _launch_chunk(sr, si, state, means, st_la, st_ai, st_af, thresholds, n_live,
                         inner_passes, inner_scheme, weights)


def device_weight_sets(st_la: list[Stencil], st_ai: Stencil, st_af: Stencil):
    """online_weight_sets with the tap lists and counts on the stencils'
    device: (wr, wi, taps, counts), all tensors."""
    wr, wi, taps, counts = online_weight_sets(st_la, st_ai, st_af)
    return wr, wi, torch.as_tensor(taps, device=wr.device), torch.as_tensor(counts,
                                                                            device=wr.device)


def _launch_chunk(sr, si, state, means, st_la, st_ai, st_af, thresholds, n_live,
                  inner_passes, inner_scheme, weights=None):
    global CHUNK_LAUNCHES
    _check(sr, si, st_la, st_ai, st_af,
           [("means", means), ("state ring_r", state.ring_r), ("state ring_i", state.ring_i),
            ("state amp", state.amp)], chunk=True)
    dev = sr.device
    Q, L, LA = st_af.Q, st_af.L, len(st_la)
    if sr.ndim != 3:
        raise ValueError(f"lws_torch: online_chunk takes (B, N, F), got {tuple(sr.shape)}")
    B, N, F = sr.shape
    W, WA = LA + Q, LA + 1
    expect = {"means": (means, (B, N)), "state ring_r": (state.ring_r, (B, W, F)),
              "state ring_i": (state.ring_i, (B, W, F)), "state amp": (state.amp, (B, WA, F))}
    for name, (t, want) in expect.items():
        if tuple(t.shape) != want:
            raise ValueError(f"lws_torch: {name} is {tuple(t.shape)}, expected {want}")
    n_live = N if n_live is None else int(n_live)
    thresholds = torch.as_tensor(thresholds, device=dev).to(torch.float32)
    iters = int(thresholds.shape[0])
    if iters == 0 or not 0 <= n_live <= N or state.seen < 0:
        raise ValueError(f"lws_torch: online_chunk needs rounds >= 1, 0 <= n_live <= N "
                         f"and seen >= 0 (rounds {iters}, n_live {n_live}, N {N}, "
                         f"seen {state.seen})")

    sr, si = sr.contiguous(), si.contiguous()
    ins = [t.contiguous() for t in (state.ring_r, state.ring_i, state.amp)]
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, None, :] * means[:, :, None]).contiguous()
    wr, wi, taps, counts = weights or device_weight_sets(st_la, st_ai, st_af)
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    outs = [torch.empty_like(t) for t in ins]
    passes, color_k, rounds = _scheme(inner_passes, inner_scheme)

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (sr, si, amp, thr, *ins, *outs, out_r, out_i, wr, wi,
                                   taps, counts)]
    err = lib.lws_online_chunk_launch(*ptrs, B, N, F, Q, L, LA, iters, passes, color_k,
                                      rounds, int(state.seen), n_live, stream)
    _raise_on(lib, err)
    CHUNK_LAUNCHES += 1
    return out_r, out_i, ChunkState(*outs, int(state.seen) + N)
