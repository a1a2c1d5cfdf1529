"""Wrapper of the grouped sweep kernel K5 (lws_packed_kernel in
lws_torch/csrc/lws_sweeps.cu).

Counterpart of lws_tpu.ops.pallas_packed.packed_lws_sweeps: K1's sweeps
with frames updated `micro` at a time, each group from the state as it was
before it. micro = 1 is K1's Gauss-Seidel order, and the wrapper hands it
to K1's wrapper (ops/lws_sweeps.tiled_lws_sweeps, which counts its own
launches); micro > 1 is lws_tpu's block-Jacobi group update, whose in-frame
passes are jacobi passes whatever `inner_scheme` says, on K5. As lws_tpu's
wrapper: edge-replica halos, the per-item mean magnitude, and the dtype
rules of K1's wrapper. K5 also serves tiled_lws_sweeps and
segmented_lws_sweeps at micro > 1 (`launch_grouped`, which takes their
`halo=` and `mean_amp=`). At micro > 1 the wrapper builds the same padded
state and dead-sweep flags as K1's (ops/lws_sweeps.launch_padded), the
weight table of the stencil (`packed_weights`: its live taps by P columns,
ops/online.py::weight_table, cached with the stencil), and launches K5
once for all sweeps, counting the launch in LAUNCHES.

`packed_plan` mirrors K5's launch plan (elements per thread, threads, the
ring, table, centre buffers and sums in shared memory or a device-memory
scratch, the compile-time kernel, bytes; csrc/lws_sweeps.cu::packed_plan,
exported as lws_packed_plan). The TPU launch knobs (pack, storage,
frame_unroll, window_carry, lane_skip, tap_chunks, interpret) raise when
not at lws_tpu's defaults. `packed_supported` answers from the plans: Q up
to MAX_Q, any micro, F up to 16384. CPU tensors, and backend="torch", take
the plain version (lws_torch.core.batch.packed_sweeps); nothing falls back:
a CUDA tensor K5 does not take raises a ValueError naming backend="torch".
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.batch import packed_sweeps as plain_packed_sweeps
from ..core.stencil import Stencil
from .lws_sweeps import (MAX_Q, SMEM_LIMIT, _library, launch_padded, reject_tpu_knobs,
                         sweep_plan, tiled_lws_sweeps)
from .online import OnlineWeights, weight_table

__all__ = ["packed_lws_sweeps", "packed_supported", "packed_plan", "PackedPlan",
           "packed_weights", "launch_grouped", "LAUNCHES"]

# K5 launches so far (micro > 1); the main path's run is read as a difference.
LAUNCHES = 0

_TPU_KNOBS = dict(pack=4, storage=None, frame_unroll=1, window_carry="stack",
                  lane_skip=False, tap_chunks=1, interpret=False)
_THREADS = 768  # the most threads a group's elements are spread over
_MAX_F = 16384


class PackedPlan(NamedTuple):
    """K5's launch plan for one geometry and weight table."""
    bins: int      # elements (frame, bin) of a group per thread, strided by `stride`
    threads: int   # threads per block
    stride: int    # threads, or H F with H = ceil(micro / bins) where a thread's
                   # elements share their bin (shared)
    width: int     # (re, im) pairs per ring or centre row: F and L margin bins each side
    slots: int     # ring rows: 2 micro + 2(Q-1)
    ring: bool     # the ring in shared memory (else in the device-memory scratch)
    table: bool    # the weight table in shared memory (else read where it is)
    centre: bool   # the two centre buffers of micro rows in shared memory
    sums: bool     # the run-time kernel's off-centre sums in shared memory
    fixed: bool    # the compile-time kernel: (Q, L) = (4, 5), P = Q, at most 3
                   # elements per thread, ring, centre buffers and table in shared memory
    shared: bool   # (fixed) a thread's elements are frames h, h + H, ... of one bin
    bytes: int     # dynamic shared memory per block
    scratch: int   # (re, im) pairs per block in device memory

    @property
    def fits(self) -> bool:
        return self.bytes <= SMEM_LIMIT


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def packed_plan(F: int, Q: int, L: int, micro: int, taps: int | None = None,
                period: int | None = None) -> PackedPlan:
    """K5's launch plan (csrc/lws_sweeps.cu::packed_plan, exported as
    lws_packed_plan) for F bins, (Q, L), `micro` frames a group (the launch
    takes min(micro, T)) and a weight table of `taps` live taps by `period`
    columns (default: every tap live, P = Q). The micro x F elements of a
    group go to bins = ceil(micro F / 768) strided elements per thread on
    round_up(ceil(micro F / bins), 32) threads; the compile-time kernel
    strides them by H F instead, H = ceil(micro / bins), where those H F
    threads fit the 768 (a thread's elements then share their bin and
    weights). Shared memory holds the tap
    lists; the compile-time kernel also the ring (2 micro + 2(Q-1) rows of
    `width` (re, im) pairs), the two centre buffers (micro rows each) and
    the table (8 bytes per tap and column), and keeps the off-centre sums in
    registers; the run-time kernel puts the ring, the table, the centre
    buffers and the sums (8 bytes per element) in shared memory where each
    still fits, in that order, the rest but the table in a device-memory
    scratch."""
    F, Q, L, micro = int(F), int(Q), int(L), int(micro)
    G = (2 * Q - 1) * (2 * L + 1) if taps is None else int(taps)
    P = Q if period is None else int(period)
    E = micro * F
    bins = _ceil_div(E, _THREADS)
    threads = _ceil_div(_ceil_div(E, bins), 32) * 32
    width = F + 2 * L
    slots = 2 * micro + 2 * (Q - 1)
    ring_b, centre_b, table_b, sums_b = 8 * slots * width, 16 * micro * width, 8 * G * P, 8 * E
    used = 4 * (3 * (2 * Q - 1) + G)
    fixed = (Q == 4 and L == 5 and P == Q and bins <= 3
             and used + ring_b + centre_b + table_b <= SMEM_LIMIT)
    stride, shared = threads, False
    if fixed:
        ring = table = centre = True
        sums = False
        used += ring_b + centre_b + table_b
        H = _ceil_div(micro, bins)
        shared = bins > 1 and H * F <= _THREADS
        if shared:
            stride = H * F
            threads = _ceil_div(stride, 32) * 32
    else:
        ring = used + ring_b <= SMEM_LIMIT
        used += ring_b if ring else 0
        table = used + table_b <= SMEM_LIMIT
        used += table_b if table else 0
        centre = used + centre_b <= SMEM_LIMIT
        used += centre_b if centre else 0
        sums = used + sums_b <= SMEM_LIMIT
        used += sums_b if sums else 0
    scratch = ((0 if ring else ring_b) + (0 if centre else centre_b)
               + (0 if fixed or sums else sums_b)) // 8
    return PackedPlan(bins, threads, stride, width, slots, ring, table, centre, sums, fixed,
                      shared, used, scratch)


def kernel_plan(F: int, Q: int, L: int, micro: int, taps: int | None = None,
                period: int | None = None) -> PackedPlan:
    """The plan the built library computes (lws_packed_plan), to hold the
    mirror to; builds csrc/lws_sweeps.cu on first use."""
    G = (2 * Q - 1) * (2 * L + 1) if taps is None else int(taps)
    P = Q if period is None else int(period)
    out = (ctypes.c_longlong * 13)()
    _library().lws_packed_plan(int(F), int(Q), int(L), int(micro), G, P,
                               ctypes.addressof(out))
    v = list(out)
    return PackedPlan(*v[:5], *(bool(x) for x in v[5:11]), v[11], v[12])


def packed_supported(T: int, F: int, Q: int, L: int, micro: int = 1) -> bool:
    """Whether the grouped sweeps run on the card at (T, F) planes, overlap
    Q, L and `micro`: Q within MAX_Q (lws_tpu's cap), F from L + 1 to 16384
    bins, and the plan fitting one CTA: K1's at micro = 1, K5's with every
    tap live otherwise (what does not fit shared memory sits in device
    memory, so T and micro do not limit it)."""
    T, F, Q, L, micro = int(T), int(F), int(Q), int(L), int(micro)
    if T < 1 or not 1 <= Q <= MAX_Q or L < 0 or not L + 1 <= F <= _MAX_F or micro < 1:
        return False
    if micro == 1:
        return sweep_plan(F, Q, L).fits
    return packed_plan(F, Q, L, min(micro, T)).fits


def packed_weights(st: Stencil) -> OnlineWeights:
    """The weight table of `st` as K5 reads it (weight_table([st])), built
    at the first call and cached with the stencil (it is immutable), so a
    launch copies nothing to the card."""
    hit = st.__dict__.get("_packed_weights")
    if hit is None:
        hit = st.__dict__["_packed_weights"] = weight_table([st])
    return hit


def packed_lws_sweeps(
    sr: torch.Tensor,
    si: torch.Tensor,
    st,
    thresholds,
    micro: int = 1,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    backend: str = "auto",
    *,
    pack: int = 4,
    storage=None,
    interpret: bool = False,
    frame_unroll: int = 1,
    window_carry: str = "stack",
    lane_skip: bool = False,
    tap_chunks: int = 1,
):
    """len(thresholds) sweeps over (..., T, F) in groups of `micro` frames.
    backend="auto" launches K5 (K1 at micro = 1) for CUDA float32 tensors and
    runs the plain version for CPU tensors; backend="torch" runs the plain
    version anywhere."""
    reject_tpu_knobs("packed_lws_sweeps", _TPU_KNOBS, pack=pack, storage=storage,
                     interpret=interpret, frame_unroll=frame_unroll,
                     window_carry=window_carry, lane_skip=lane_skip, tap_chunks=tap_chunks)
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")
    micro = max(1, int(micro))
    if st.Q > MAX_Q:
        raise ValueError(f"lws_torch: packed_lws_sweeps takes Q <= {MAX_Q}, got Q={st.Q}")
    if backend == "torch" or sr.device.type == "cpu":
        return plain_packed_sweeps(sr, si, st, thresholds, micro, inner_passes, inner_scheme)
    if sr.device.type != "cuda":
        raise ValueError(f"lws_torch: the sweep kernels run on CUDA, got {sr.device}")
    if micro == 1:
        return tiled_lws_sweeps(sr, si, st, thresholds, inner_passes, inner_scheme)
    return launch_grouped(sr, si, st, thresholds, micro, inner_passes)


def launch_grouped(sr, si, st, thresholds, micro, inner_passes, halo=None, mean_amp=None):
    """Launch K5 once over CUDA (..., T, F) planes at micro > 1 (jacobi
    passes), with `halo` / `mean_amp` as K1's wrapper takes them; counts
    the launch. Raises a ValueError naming backend='torch' for a geometry K5
    does not take."""
    global LAUNCHES
    T, F = sr.shape[-2:]
    if not packed_supported(T, F, st.Q, st.L, micro):
        raise ValueError(
            f"lws_torch: K5 does not take F={F}, Q={st.Q}, L={st.L}, micro={micro} "
            f"(Q up to {MAX_Q}, F from L + 1 to {_MAX_F}); use backend='torch' for the "
            "plain version")
    wt = packed_weights(st)
    G = int(wt.dks.numel())
    plan = packed_plan(F, st.Q, st.L, min(int(micro), int(T)), G, wt.period)
    passes = max(1, int(inner_passes)) if st.has_centre else 1
    out, launched = launch_padded(
        "lws_packed_launch", sr, si, st, thresholds, halo, mean_amp,
        (wt.table, wt.rows, wt.dks), (int(micro), passes, int(st.has_centre), G, wt.period),
        scratch=plan.scratch)
    LAUNCHES += launched
    return out
