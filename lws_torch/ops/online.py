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
  - takes the weight table of the 2+LA sets [st_ai, st_af, *st_la]
    (`online_weights`: the live taps by P columns, P = Q for summarized
    weights, with their tap lists), built once per set of stencils and
    cached with them;
  - allocates separate outputs (K4: a new state too; K3: the ring's scratch
    where the plan keeps it in device memory) and launches its kernel once,
    counting the launch (LAUNCHES, CHUNK_LAUNCHES).

`online_plan` mirrors the kernels' launch plan (threads, bins per thread,
whether the ring, the table and K4's amp rows sit in shared memory, bytes;
csrc/lws_online.cu::online_plan). Any Q, L and look-ahead run, F up to
16384. CPU tensors, and backend="torch", take the plain versions
(lws_torch.core.online.rtisi_la / online_chunk). A CUDA tensor the kernels
do not take (float64), or one that requires grad (the kernels have no
backward), raises a ValueError that names backend="torch"; nothing falls
back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.online import ChunkState, online_chunk_init
from ..core.online import online_chunk as plain_online_chunk
from ..core.online import rtisi_la as plain_rtisi_la
from ..core.stencil import Stencil, _parse_colors
from . import _build
from .lws_sweeps import SMEM_LIMIT, refuse_grad

__all__ = ["packed_rtisi_la", "online_chunk", "online_chunk_init", "ChunkState",
           "online_supported", "online_weight_sets", "online_weights", "weight_table",
           "OnlineWeights", "online_plan", "OnlinePlan", "check_online", "LAUNCHES",
           "CHUNK_LAUNCHES"]

# Kernel launches so far (K3, K4); a path's run is read as a difference.
LAUNCHES = 0
CHUNK_LAUNCHES = 0

_LIB = "lws_online"
_MAX_THREADS = 1024
_MAX_BINS = 16  # bins per thread of the run-time kernels
_FIXED_THREADS = 768  # the compile-time kernels' launch bound


def _library():
    lib = _build.load(_LIB)
    if lib.lws_online_launch.argtypes is None:
        lib.lws_online_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.lws_online_launch.restype = ctypes.c_int
        lib.lws_online_chunk_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 12
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.lws_online_chunk_launch.restype = ctypes.c_int
        lib.lws_online_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.lws_online_plan.restype = ctypes.c_int
        lib.lws_online_error_string.argtypes = [ctypes.c_int]
        lib.lws_online_error_string.restype = ctypes.c_char_p
    return lib


class OnlinePlan(NamedTuple):
    """K3's / K4's launch plan for one geometry and weight table."""
    bins: int      # bins per thread, strided: tid, tid + threads, ...
    threads: int   # threads per block
    width: int     # (re, im) pairs per ring row: F and L margin bins each side
    ring: bool     # the LA+Q-row ring in shared memory (else device memory)
    table: bool    # the weight table in shared memory (else device memory)
    amp: bool      # K4's LA+1 amp rows in shared memory (K3: False)
    fixed: bool    # the compile-time kernel: (Q, L) = (4, 5), P = Q, 1-3 bins on
                   # at most 768 threads, ring and table in shared memory
    bytes: int     # dynamic shared memory per block

    @property
    def fits(self) -> bool:
        return self.bytes <= SMEM_LIMIT and self.bins <= _MAX_BINS


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def online_plan(F: int, Q: int, L: int, LA: int, chunk: bool = False, taps: int | None = None,
                period: int | None = None) -> OnlinePlan:
    """The online kernels' launch plan (csrc/lws_online.cu::online_plan,
    exported as lws_online_plan) for F bins, (Q, L), look-ahead LA, K4 when
    `chunk`, and a weight table of `taps` live taps by `period` columns
    (default: every tap of the 2+LA sets live, P = Q; the wrappers pass
    their table's). bins = ceil(F / 1024) strided bins per thread on
    round_up(ceil(F / bins), 32) threads. Shared memory holds one
    centre-row copy and the tap lists, then the ring (LA+Q rows of
    `width` (re, im) pairs), the table (8 bytes per tap and column) and
    K4's amp rows, each where it still fits, in that order."""
    F, Q, L, LA = int(F), int(Q), int(L), int(LA)
    S, R = 2 + LA, 2 * Q - 1
    G = S * R * (2 * L + 1) if taps is None else int(taps)
    P = Q if period is None else int(period)
    bins = _ceil_div(F, _MAX_THREADS)
    threads = _ceil_div(_ceil_div(F, bins), 32) * 32
    width = F + 2 * L
    used = 8 * width + 4 * (3 * S * R + G)
    ring = used + (LA + Q) * 8 * width <= SMEM_LIMIT
    used += (LA + Q) * 8 * width if ring else 0
    table = used + 8 * G * P <= SMEM_LIMIT
    used += 8 * G * P if table else 0
    amp = bool(chunk) and used + 4 * (LA + 1) * F <= SMEM_LIMIT
    used += 4 * (LA + 1) * F if amp else 0
    fixed = (Q == 4 and L == 5 and P == Q and ring and table and bins <= 3
             and threads <= _FIXED_THREADS)
    return OnlinePlan(bins, threads, width, ring, table, amp, fixed, used)


def kernel_plan(F: int, Q: int, L: int, LA: int, chunk: bool = False, taps: int | None = None,
                period: int | None = None) -> OnlinePlan:
    """The plan the built library computes (lws_online_plan), to hold the
    mirror to; builds csrc/lws_online.cu on first use."""
    S, R = 2 + LA, 2 * Q - 1
    G = S * R * (2 * L + 1) if taps is None else int(taps)
    P = Q if period is None else int(period)
    out = (ctypes.c_longlong * 8)()
    _library().lws_online_plan(int(F), int(Q), int(L), int(LA), int(bool(chunk)), G, P,
                               ctypes.addressof(out))
    v = list(out)
    return OnlinePlan(v[0], v[1], v[2], bool(v[3]), bool(v[4]), bool(v[5]), bool(v[6]), v[7])


def online_supported(F: int, Q: int, L: int, LA: int, chunk: bool = False) -> bool:
    """Whether the online kernel (chunk=True: K4) takes this geometry: its
    plan fits one block with every tap live (where the ring, the table or
    the amp rows do not fit shared memory they sit in device memory)."""
    return (Q >= 1 and L >= 0 and LA >= 0 and F >= L + 1
            and online_plan(F, Q, L, LA, chunk).fits)


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
            f"F={F}, Q={Q}, L={L}, look_ahead={LA} (F from L + 1 to "
            f"{_MAX_BINS * _MAX_THREADS}); use backend='torch' for the plain version")


class OnlineWeights(NamedTuple):
    """The weights of S stencil sets as the kernels read them (the online
    kernels: the 2+LA sets [st_ai, st_af, *st_la]; K5: one)."""
    table: torch.Tensor  # (G, P, 2), the stencils' dtype: (re, im) of live tap g at column p
    rows: torch.Tensor   # (S, 2Q-1, 3) int32: per set and row of taps, the bit mask
                         # of its live dk (0 where 2L+1 > 31), the index of its first
                         # live tap in the table, and its count
    dks: torch.Tensor    # (G,) int32: the dk of each live tap
    period: int          # P: bin n reads column n mod P
    counts: np.ndarray   # (S, 2) host: live off-centre and centre taps per set


def weight_table(sets: list[Stencil]) -> OnlineWeights:
    """The weight table of the stencil sets `sets` (one Q, L and F) on their
    device, as the kernels read it: each set's live off-centre taps in (dr,
    dk) order, then its live centre taps (from the host nz masks), by P
    columns, P = Q when every set's weights repeat with period Q in the bin
    index (Stencil.period), else F. Column p of tap (dr, dk) holds W[dr, dk,
    p], the same values bin n reads at W[dr, dk, n] for n = p mod P. The
    online kernels take the 2+LA sets (online_weight_sets), the grouped
    sweep kernel K5 one (ops/packed.py::packed_weights)."""
    Q, L, F = sets[0].Q, sets[0].L, sets[0].n_bins
    R, K, c = 2 * Q - 1, 2 * L + 1, Q - 1
    P = Q if all(st.period == Q for st in sets) else F
    rows = np.zeros((len(sets), R, 3), dtype=np.int32)
    counts = np.zeros((len(sets), 2), dtype=np.int32)
    which, drs, dks = [], [], []
    for s, st in enumerate(sets):
        for dr in [r for r in range(R) if r != c] + [c]:
            live = [dk for dk in range(K) if st.nz[dr, dk]]
            mask = sum(1 << dk for dk in live) if K <= 31 else 0
            rows[s, dr] = mask, len(dks), len(live)
            which += [s] * len(live)
            drs += [dr] * len(live)
            dks += live
        counts[s] = int(st.nz.sum() - st.nz[c].sum()), int(st.nz[c].sum())
    dev = sets[0].Wr.device
    idx = [torch.as_tensor(v, dtype=torch.long, device=dev) for v in (which, drs, dks)]
    cols = torch.arange(P, device=dev)
    planes = []
    for part in ("Wr", "Wi"):
        w = torch.stack([getattr(st, part) for st in sets])
        planes.append(w[idx[0], idx[1], idx[2]][:, cols])
    table = torch.stack(planes, dim=-1).contiguous()
    return OnlineWeights(table, torch.as_tensor(rows, device=dev),
                         torch.as_tensor(np.asarray(dks, np.int32), device=dev), P, counts)


def online_weight_sets(st_la: list[Stencil], st_ai: Stencil, st_af: Stencil) -> OnlineWeights:
    """The weight table of the online kernels' sets [st_ai, st_af, *st_la]
    (weight_table)."""
    return weight_table([st_ai, st_af, *st_la])


def online_weights(st_la: list[Stencil], st_ai: Stencil, st_af: Stencil) -> OnlineWeights:
    """online_weight_sets for these stencils, built at the first call and
    cached with st_af (the stencils are immutable), so a launch copies
    nothing to the card."""
    sets = (st_ai, st_af, *st_la)
    cache = st_af.__dict__.setdefault("_online_weights", {})
    key = tuple(map(id, sets))
    hit = cache.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], sets)):
        hit = cache[key] = (sets, online_weight_sets(st_la, st_ai, st_af))
    return hit[1]


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
    (`tensors`: more (name, tensor) pairs to hold to sr's dtype and device).
    Refuses tensors that require grad: the kernels have no backward."""
    dev = sr.device
    sets = [st_ai, st_af, *st_la]
    tensors = [("sr", sr), ("si", si)] + tensors + [
        (f"weight set {k}", t) for k, st in enumerate(sets) for t in (st.Wr, st.Wi)]
    refuse_grad("lws_online_chunk_launch" if chunk else "lws_online_launch",
                *(t for _, t in tensors))
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
    wt = online_weights(st_la, st_ai, st_af)
    out_r = torch.empty_like(sr3)
    out_i = torch.empty_like(si3)
    passes, color_k, rounds = _scheme(inner_passes, inner_scheme)
    plan = online_plan(F, Q, L, LA, taps=wt.dks.numel(), period=wt.period)
    ring = [None, None]
    if not plan.ring:  # the ring's scratch in device memory
        ring = [torch.empty((B, LA + Q, F), dtype=torch.float32, device=dev) for _ in ring]

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [None if t is None else t.data_ptr()
            for t in (sr3, si3, amp, out_r, out_i, wt.table, wt.rows, wt.dks, thr, *ring)]
    err = lib.lws_online_launch(*ptrs, B, T, F, Q, L, LA, iters, passes, color_k, rounds,
                                wt.dks.numel(), wt.period, stream)
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
    lane_skip: bool = False,
):
    """Advance B streams by the N frames (sr, si) of shape (B, N, F) from
    `state` (online_chunk_init or a previous call), with the threshold
    scale means (B, N) at each frame; steps m >= n_live are drain steps.

    Returns (committed_r, committed_i, new_state), row m holding the final
    value of absolute frame state.seen + m - LA (lws_torch.core.online.
    online_chunk). backend="auto" launches K4 for CUDA float32 tensors and
    runs the plain version for CPU tensors; backend="torch" runs the plain
    version anywhere. `state` is not modified.
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
                         inner_passes, inner_scheme)


def _launch_chunk(sr, si, state, means, st_la, st_ai, st_af, thresholds, n_live,
                  inner_passes, inner_scheme):
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
    wt = online_weights(st_la, st_ai, st_af)
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    outs = [torch.empty_like(t) for t in ins]
    passes, color_k, rounds = _scheme(inner_passes, inner_scheme)

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (sr, si, amp, thr, *ins, *outs, out_r, out_i, wt.table,
                                   wt.rows, wt.dks)]
    err = lib.lws_online_chunk_launch(*ptrs, B, N, F, Q, L, LA, iters, passes, color_k,
                                      rounds, wt.dks.numel(), wt.period, int(state.seen),
                                      n_live, stream)
    _raise_on(lib, err)
    CHUNK_LAUNCHES += 1
    return out_r, out_i, ChunkState(*outs, int(state.seen) + N)
