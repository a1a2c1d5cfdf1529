"""Wrapper of the CUDA sweep kernel (lws_torch/csrc/lws_sweeps.cu).

Counterpart of lws_tpu.ops.pallas_packed.tiled_lws_sweeps, without its
TPU launch plan: there are no time tiles, sublane packs or lane folds, so
bf16 storage, lane folding, tap chunks and the lane skip are not carried
over and raise. `micro` is part of what lws_tpu computes, not a tile knob:
at micro > 1 its tiled kernel runs block-Jacobi groups of `micro` frames,
the grouped sweeps, which here run on the grouped sweep kernel K5
(ops/packed.py, counted in its LAUNCHES) or, for CPU tensors and
backend="torch", on their plain version (core.batch.packed_sweeps). At
micro = 1 the wrapper

  - checks device, dtype, shapes and the stencil;
  - builds the padded state (B, T + 2(Q-1), F) whose Q-1 frozen halo rows
    at each end are edge replicas of the input or the caller's `halo=`;
  - computes amp = |S|, the per-item mean (or the caller's `mean_amp=`),
    the scaled thresholds thr[b, it] = thresholds[it] * mean[b] and the
    exact dead-sweep flags live[b, it] = max amp[b] > thr[b, it] in torch,
    as the JAX package does outside its pallas_call;
  - launches the kernel once for all sweeps and counts the launch.

`sweep_plan` mirrors the kernel's launch plan (bins per thread, threads,
the shared-memory window ring, the tap planes staged in shared memory or
the period-Q weight table, bytes; csrc/lws_sweeps.cu::sweep_plan): any Q
and L whose plan fits one block run. Where the plan picks the table kernel
((Q, L) = (8, 5), weights of period Q, 1-2 bins per thread), the launch
passes the stencil's weight table (ops/packed.py::packed_weights, cached
with the stencil) in place of the tap planes, and counts it in
TABLE_LAUNCHES too. CPU tensors, and backend="torch", take the plain version
(lws_torch.core.batch.lws_sweeps). A CUDA tensor the kernel does not take
(float64, a plan past 227 KB of shared memory) raises; nothing falls back.
The kernels have no backward (lws_tpu's Pallas kernels have no custom_vjp
either), so a CUDA tensor that requires grad raises too (`refuse_grad`):
autograd differentiates the plain version, backend="torch".
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.batch import lws_sweeps as plain_lws_sweeps
from ..core.batch import packed_sweeps as plain_packed_sweeps
from ..core.stencil import Stencil, _parse_colors
from . import _build

__all__ = ["tiled_lws_sweeps", "sweep_schedule", "sweep_plan", "SweepPlan", "MAX_Q",
           "LAUNCHES", "TABLE_LAUNCHES"]

# Largest overlap factor of the online kernels and the grouped sweep kernel
# K5 (the JAX kernels' MAX_Q); K1 takes any Q its shared-memory plan fits.
MAX_Q = 16

# Per-block opt-in shared memory on sm_90 (csrc/lws_common.cuh kSmemLimit).
SMEM_LIMIT = 232448
_MAX_THREADS = 1024
_MAX_BINS = 16  # bins per thread of the kernel's run-time path
_FIXED_THREADS = 768  # the compile-time kernels' launch bound

# Kernel launches so far; the main path's run is read as a difference.
LAUNCHES = 0
# Of those, the launches of the table kernel (weights from the period-Q table).
TABLE_LAUNCHES = 0

_LIB = "lws_sweeps"


class SweepPlan(NamedTuple):
    """K1's launch plan for one (F, Q, L)."""
    bins: int      # bins per thread, strided: tid, tid + threads, ...
    threads: int   # threads per block
    width: int     # floats per buffered row: F and L margin bins each side
    ring: bool     # the 2Q-row window in shared memory (else read from device memory)
    staged: int    # tap planes staged in shared memory: whole rows, centre row first
    taps: int      # (2Q - 1)(2L + 1)
    fixed: bool    # a compile-time kernel: (Q, L) in {(4, 5), (2, 5)}, 1-3 bins on
                   # at most 768 threads, ring; or the table kernel
    table: bool    # the table kernel: (Q, L) = (8, 5), period Q, 1-2 bins on at most
                   # 768 threads, the weight table and tap lists beside the ring
    bytes: int     # dynamic shared memory per block

    @property
    def fits(self) -> bool:
        return self.bytes <= SMEM_LIMIT and self.bins <= _MAX_BINS


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _taps_period(F: int, Q: int, L: int, period, taps) -> tuple[int, int]:
    """(G, P): `taps` live taps (default every tap) and `period` (default F)."""
    return ((2 * Q - 1) * (2 * L + 1) if taps is None else int(taps),
            F if period is None else int(period))


def sweep_plan(F: int, Q: int, L: int, period: int | None = None,
               taps: int | None = None) -> SweepPlan:
    """K1's launch plan (csrc/lws_sweeps.cu::sweep_plan, exported as
    lws_sweeps_plan) for a stencil of `taps` live taps (default all) whose
    weights repeat with `period` in the bin index (default F: they do not):
    bins = ceil(F / 1024) strided bins per thread on round_up(ceil(F /
    bins), 32) threads; two ping-pong centre rows and, when it fits beside
    them, the 2Q-row ring of the window, each row (re, im) of `width`
    floats. At (Q, L) = (8, 5) with period Q, 1-2 bins on at most 768
    threads and the ring, the table kernel: the weight table (8 bytes per
    live tap and column) and its tap lists (4 bytes per row field and live
    tap) beside the ring, where they fit. Otherwise as many rows of taps
    (2L + 1 (re, im) planes of F floats) as the rest of the 227 KB holds."""
    F, Q, L = int(F), int(Q), int(L)
    K = 2 * L + 1
    G, P = _taps_period(F, Q, L, period, taps)
    bins = _ceil_div(F, _MAX_THREADS)
    threads = _ceil_div(_ceil_div(F, bins), 32) * 32
    width = F + 2 * L
    row = 2 * width * 4
    pingpong, ring_b = 2 * row, 2 * Q * row
    ring = pingpong + ring_b <= SMEM_LIMIT
    used = pingpong + (ring_b if ring else 0)
    table_b = 8 * G * P + 4 * (3 * (2 * Q - 1) + G)
    if (ring and (Q, L) == (8, 5) and P == Q and bins <= 2 and threads <= _FIXED_THREADS
            and used + table_b <= SMEM_LIMIT):
        return SweepPlan(bins, threads, width, ring, 0, (2 * Q - 1) * K, True, True,
                         used + table_b)
    tap_plane = 2 * F * 4
    rows = max(0, SMEM_LIMIT - used) // (K * tap_plane)
    staged = min(2 * Q - 1, rows) * K
    fixed = ring and L == 5 and Q in (4, 2) and bins <= 3 and threads <= _FIXED_THREADS
    return SweepPlan(bins, threads, width, ring, staged, (2 * Q - 1) * K, fixed, False,
                     used + staged * tap_plane)


def stencil_plan(F: int, st: Stencil) -> SweepPlan:
    """sweep_plan for the stencil `st` on F bins: its period and live taps."""
    return sweep_plan(F, st.Q, st.L, st.period, int(st.nz.sum()))


def _library():
    lib = _build.load(_LIB)
    if lib.lws_sweeps_launch.argtypes is None:
        lib.lws_sweeps_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.lws_sweeps_launch.restype = ctypes.c_int
        lib.lws_sweeps_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lws_sweeps_plan.restype = ctypes.c_int
        lib.lws_sweeps_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lws_sweeps_occupancy.restype = ctypes.c_int
        lib.lws_packed_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.lws_packed_launch.restype = ctypes.c_int
        lib.lws_packed_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.lws_packed_plan.restype = ctypes.c_int
        lib.lws_sweeps_error_string.argtypes = [ctypes.c_int]
        lib.lws_sweeps_error_string.restype = ctypes.c_char_p
    return lib


def sweep_schedule(sr, si, thresholds, mean_amp=None):
    """(amp, thr, live) for (B, T, F) planes: thr[b, it] =
    thresholds[it] * mean[b] and live[b, it] = any amp[b] > thr[b, it].
    A sweep with live == 0 changes nothing, so the kernel skips it."""
    amp = torch.sqrt(sr * sr + si * si)
    if mean_amp is None:
        mean = amp.mean(dim=(-2, -1))
    else:
        mean = torch.as_tensor(mean_amp, device=sr.device).reshape(-1).to(amp.dtype)
    thr = thresholds.to(amp.dtype)[None, :] * mean[:, None]
    live = (amp.amax(dim=(-2, -1))[:, None] > thr).to(torch.int32)
    return amp, thr, live


def refuse_grad(entry: str, *tensors, reason: str | None = None) -> None:
    """Raise a ValueError when grad mode is on and any of `tensors` (tensors,
    or tuples of them, or None) requires grad: a CUDA kernel's output has no
    grad_fn, so the gradient would be lost without a word. The message
    names `entry` and `reason` (default: the kernel, and backend='torch')."""
    if not torch.is_grad_enabled():
        return
    flat = [t for x in tensors for t in (x if isinstance(x, (tuple, list)) else (x,))]
    if any(torch.is_tensor(t) and t.requires_grad for t in flat):
        reason = reason or (
            "launches a CUDA kernel, which has no backward; use backend='torch' for the "
            "plain PyTorch version, which autograd differentiates")
        raise ValueError(f"lws_torch: {entry} refuses a tensor that requires grad: it {reason}")


def _schedule_args(st: Stencil, inner_passes: int, inner_scheme: str):
    """(passes, color_k, color_rounds, has_centre) for the launch."""
    has_centre = st.has_centre
    if has_centre and inner_scheme != "jacobi":
        k, rounds = _parse_colors(inner_scheme)
        return 1, k, rounds, 1
    return max(1, int(inner_passes)), 0, 1, int(has_centre)


def reject_tpu_knobs(entry: str, defaults: dict, **knobs):
    """Raise for any of lws_tpu's TPU launch knobs given at other than its
    default: they have no meaning on this card."""
    asked = sorted(k for k, v in knobs.items() if v != defaults[k])
    if asked:
        raise ValueError(
            f"lws_torch: {asked} are TPU launch knobs of lws_tpu.ops.{entry} "
            "and are not carried to the port")


def tiled_lws_sweeps(
    sr: torch.Tensor,
    si: torch.Tensor,
    st: Stencil,
    thresholds,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    halo: tuple | None = None,
    mean_amp: torch.Tensor | None = None,
    backend: str = "auto",
    *,
    storage=None,
    micro: int = 1,
    lane_fold: int = 1,
    tap_chunks: int = 1,
    lane_skip: bool = False,
):
    """len(thresholds) thresholded Gauss-Seidel sweeps over (..., T, F).

    `halo` (top_r, top_i, bot_r, bot_i), each (..., Q-1, F), replaces the
    edge-replica time halos; `mean_amp` (...,) replaces the per-item mean
    magnitude (the same contract as lws_tpu's kernels). `micro` > 1 runs
    lws_tpu's grouped sweeps (block-Jacobi groups of `micro` frames, jacobi
    in-frame passes whatever `inner_scheme` says) on the grouped sweep
    kernel K5. backend="auto" launches the kernel for CUDA float32 tensors
    and runs the plain version for CPU tensors; backend="torch" runs the
    plain version anywhere.
    """
    reject_tpu_knobs("tiled_lws_sweeps",
                     dict(storage=None, lane_fold=1, tap_chunks=1, lane_skip=False),
                     storage=storage, lane_fold=lane_fold, tap_chunks=tap_chunks,
                     lane_skip=lane_skip)
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")
    micro = max(1, int(micro))
    if backend == "torch" or sr.device.type == "cpu":
        if micro > 1:
            return plain_packed_sweeps(sr, si, st, thresholds, micro, inner_passes,
                                       inner_scheme, halo, mean_amp)
        return plain_lws_sweeps(sr, si, st, thresholds, order="gs",
                                inner_passes=inner_passes,
                                inner_scheme=inner_scheme, halo=halo,
                                mean_amp=mean_amp)
    if sr.device.type != "cuda":
        raise ValueError(f"lws_torch: the sweep kernel runs on CUDA, got {sr.device}")
    if micro > 1:
        from . import packed  # packed imports this module
        return packed.launch_grouped(sr, si, st, thresholds, micro, inner_passes, halo,
                                     mean_amp)
    return _launch(sr, si, st, thresholds, inner_passes, inner_scheme, halo,
                   mean_amp)


def _launch(sr, si, st, thresholds, inner_passes, inner_scheme, halo, mean_amp):
    global LAUNCHES, TABLE_LAUNCHES
    F = sr.shape[-1]
    plan = stencil_plan(F, st)
    if not plan.fits:
        raise ValueError(
            f"lws_torch: the sweep kernel's shared-memory plan does not fit one block at "
            f"F={F}, Q={st.Q}, L={st.L} ({plan.bytes} B against {SMEM_LIMIT}); "
            "use backend='torch' for the plain version")
    if plan.table:
        from .packed import packed_weights  # packed imports this module
        wt = packed_weights(st)
        weights = (None, None, wt.table, wt.rows, wt.dks)
    else:
        weights = (st.Wr, st.Wi, None, None, None)
    out, launched = launch_padded(
        "lws_sweeps_launch", sr, si, st, thresholds, halo, mean_amp, weights,
        (*_schedule_args(st, inner_passes, inner_scheme), int(st.nz.sum()), st.period))
    LAUNCHES += launched
    TABLE_LAUNCHES += int(launched and plan.table)
    return out


def kernel_plan(F: int, Q: int, L: int, period: int | None = None,
                taps: int | None = None) -> SweepPlan:
    """The plan the built kernel computes (lws_sweeps_plan), to hold the
    mirror to (sweep_plan's arguments); builds csrc/lws_sweeps.cu on first
    use."""
    G, P = _taps_period(F, Q, L, period, taps)
    out = (ctypes.c_longlong * 9)()
    _library().lws_sweeps_plan(int(F), int(Q), int(L), G, P, ctypes.addressof(out))
    v = list(out)
    return SweepPlan(*v[:3], bool(v[3]), v[4], v[5], bool(v[6]), bool(v[7]), v[8])


def kernel_occupancy(F: int, Q: int, L: int, period: int | None = None,
                     taps: int | None = None) -> int:
    """Blocks of the kernel K1 launches for (F, Q, L) and a stencil of
    `taps` live taps of `period` (sweep_plan's arguments) that one SM of the
    current CUDA device holds at once, as the CUDA runtime's occupancy
    query counts them (lws_sweeps_occupancy); builds csrc/lws_sweeps.cu on
    first use."""
    G, P = _taps_period(F, Q, L, period, taps)
    lib = _library()
    blocks = ctypes.c_int(0)
    err = lib.lws_sweeps_occupancy(int(F), int(Q), int(L), G, P, ctypes.byref(blocks))
    if err != 0:
        msg = lib.lws_sweeps_error_string(err).decode()
        raise RuntimeError(f"lws_torch: lws_sweeps_occupancy failed: {msg} ({err})")
    return blocks.value


def launch_padded(entry, sr, si, st, thresholds, halo, mean_amp, weights, schedule,
                  scratch=None):
    """Check the inputs, build the padded state and the schedule, and run
    csrc/lws_sweeps.cu's `entry` (lws_sweeps_launch or lws_packed_launch)
    once with the pointers of `weights` after amp (K1: st.Wr, st.Wi and the
    weight table and tap lists, None for those its plan does not read; K5:
    its weight table and tap lists) and `schedule` (its int arguments after
    `iters`). `scratch`, for K5: the float2 each CTA keeps in device memory
    (its plan's), allocated here and passed after the thresholds' live
    flags (null when 0). Returns the output pair and whether a kernel was
    launched (not for zero sweeps). The callers check the geometry each
    kernel takes (K1: sweep_plan; K5: packed_plan). Refuses tensors that
    require grad (`refuse_grad`)."""
    refuse_grad(entry, sr, si, st.Wr, st.Wi, thresholds, halo, mean_amp)
    dev = sr.device
    for name, t in (("sr", sr), ("si", si), ("st.Wr", st.Wr), ("st.Wi", st.Wi)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"lws_torch: the CUDA sweep kernels take float32, {name} is "
                f"{t.dtype}; use backend='torch' for the plain version")
        if t.device != dev:
            raise ValueError(f"lws_torch: {name} is on {t.device}, sr on {dev}")
    if si.shape != sr.shape or sr.ndim < 2:
        raise ValueError(f"lws_torch: sr {tuple(sr.shape)} / si {tuple(si.shape)}")
    Q, L = st.Q, st.L
    shape = sr.shape
    T, F = shape[-2:]
    if st.n_bins != F or tuple(st.Wr.shape) != (2 * Q - 1, 2 * L + 1, F):
        raise ValueError(f"lws_torch: stencil {tuple(st.Wr.shape)} does not fit F={F}")
    if F < L + 1:
        raise ValueError(f"lws_torch: F={F} is too narrow for L={L}")
    thresholds = torch.as_tensor(thresholds, device=dev).to(torch.float32)
    iters = int(thresholds.shape[0])
    if iters == 0:
        return (sr, si), False

    B = sr.numel() // (T * F)
    sr3 = sr.reshape(B, T, F)
    si3 = si.reshape(B, T, F)
    amp, thr, live = sweep_schedule(sr3, si3, thresholds, mean_amp)
    Q1 = Q - 1
    xr = torch.empty((B, T + 2 * Q1, F), dtype=torch.float32, device=dev)
    xi = torch.empty_like(xr)
    for x, s, h_top, h_bot in ((xr, sr3, 0, 2), (xi, si3, 1, 3)):
        x[:, Q1:Q1 + T] = s
        if halo is None:
            x[:, :Q1] = s[:, :1]
            x[:, Q1 + T:] = s[:, -1:]
        else:
            x[:, :Q1] = halo[h_top].reshape(B, Q1, F)
            x[:, Q1 + T:] = halo[h_bot].reshape(B, Q1, F)
    weights = [None if w is None else w.contiguous() for w in weights]
    thr = thr.contiguous()
    live = live.contiguous()
    extra = []
    if scratch is not None:
        buf = (torch.empty((B, int(scratch), 2), dtype=torch.float32, device=dev)
               if scratch else None)
        extra = [None if buf is None else buf.data_ptr()]

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(
        xr.data_ptr(), xi.data_ptr(), amp.data_ptr(),
        *(None if w is None else w.data_ptr() for w in weights),
        thr.data_ptr(), live.data_ptr(), *extra, B, T, F, Q, L, iters, *schedule, stream)
    if err != 0:
        msg = lib.lws_sweeps_error_string(err).decode()
        raise RuntimeError(f"lws_torch: {entry} failed: {msg} ({err})")
    return (xr[:, Q1:Q1 + T].reshape(shape), xi[:, Q1:Q1 + T].reshape(shape)), True
