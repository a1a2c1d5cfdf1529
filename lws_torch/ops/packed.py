"""Wrapper of the grouped sweep kernel K5 (lws_packed_kernel in
lws_torch/csrc/lws_sweeps.cu).

Counterpart of lws_tpu.ops.pallas_packed.packed_lws_sweeps: K1's sweeps
with frames updated `micro` at a time, each group from the state as it was
before it. micro = 1 is K1's Gauss-Seidel order, and the wrapper hands it
to K1's wrapper (ops/lws_sweeps.tiled_lws_sweeps, which counts its own
launches); micro > 1 is lws_tpu's block-Jacobi group update, whose in-frame
passes are jacobi passes whatever `inner_scheme` says, on K5. As lws_tpu's
wrapper: edge-replica halos, the per-item mean magnitude, and the dtype
rules of K1's wrapper. At micro > 1 the wrapper builds the same padded
state and dead-sweep flags as K1's (ops/lws_sweeps.launch_padded) and
launches K5 once for all sweeps, counting the launch in LAUNCHES.

The TPU launch knobs (pack, storage, frame_unroll, window_carry,
lane_skip, tap_chunks, interpret) raise when not at lws_tpu's defaults.
`packed_supported` answers whether K5's shared-memory plan fits one CTA
(this card's question, not lws_tpu's VMEM budget: the state lives in
device memory, so T does not enter); the wrapper raises where it does not.
CPU tensors, and backend="torch", take the plain version
(lws_torch.core.batch.packed_sweeps); nothing falls back.
"""
from __future__ import annotations

import torch

from ..core.batch import packed_sweeps as plain_packed_sweeps
from .lws_sweeps import MAX_Q, SMEM_LIMIT, launch_padded, reject_tpu_knobs, tiled_lws_sweeps

__all__ = ["packed_lws_sweeps", "packed_supported", "LAUNCHES"]

# K5 launches so far (micro > 1); the main path's run is read as a difference.
LAUNCHES = 0

_TPU_KNOBS = dict(pack=4, storage=None, frame_unroll=1, window_carry="stack",
                  lane_skip=False, tap_chunks=1, interpret=False)


def packed_supported(T: int, F: int, Q: int, L: int, micro: int = 1) -> bool:
    """Whether K5 takes (T, F) planes at overlap Q, L and `micro`: Q within
    MAX_Q, F of at least L + 1 bins, and its shared memory (the off-centre
    sums and two ping-pong centre rows of `micro` rows, 6 x micro x F
    floats) within one CTA's 227 KB. The weights go to shared memory only
    when they fit beside it; the state stays in device memory."""
    micro = int(micro)
    return (int(T) >= 1 and 1 <= Q <= MAX_Q and F >= L + 1 and micro >= 1
            and 6 * micro * F * 4 <= SMEM_LIMIT)


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
    T, F = sr.shape[-2:]
    if not packed_supported(T, F, st.Q, st.L, micro):
        raise ValueError(
            f"lws_torch: K5's shared-memory plan does not fit one CTA at F={F}, "
            f"micro={micro} (packed_supported); use backend='torch'")
    return _launch(sr, si, st, thresholds, micro, inner_passes, inner_scheme)


def _launch(sr, si, st, thresholds, micro, inner_passes, inner_scheme):
    global LAUNCHES
    if micro == 1:
        return tiled_lws_sweeps(sr, si, st, thresholds, inner_passes, inner_scheme)
    # lws_tpu's group update runs jacobi passes whatever the scheme
    passes = max(1, int(inner_passes)) if st.has_centre else 1
    out, launched = launch_padded("lws_packed_launch", sr, si, st, thresholds, None, None,
                                  (micro, passes, int(st.has_centre)))
    LAUNCHES += launched
    return out
