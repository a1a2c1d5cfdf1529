"""Wrapper of the CUDA sweep kernel (lws_torch/csrc/lws_sweeps.cu).

Counterpart of lws_tpu.ops.pallas_packed.tiled_lws_sweeps, without its
TPU launch plan: there are no time tiles, sublane packs or lane folds, so
bf16 storage, lane folding, tap chunks, micro > 1 and the lane skip are not
carried over and raise. The wrapper

  - checks device, dtype, shapes and the stencil;
  - builds the padded state (B, T + 2(Q-1), F) whose Q-1 frozen halo rows
    at each end are edge replicas of the input or the caller's `halo=`;
  - computes amp = |S|, the per-item mean (or the caller's `mean_amp=`),
    the scaled thresholds thr[b, it] = thresholds[it] * mean[b] and the
    exact dead-sweep flags live[b, it] = max amp[b] > thr[b, it] in torch,
    as the JAX package does outside its pallas_call;
  - launches the kernel once for all sweeps and counts the launch.

CPU tensors, and backend="torch", take the plain version
(lws_torch.core.batch.lws_sweeps). A CUDA tensor the kernel does not take
(float64, Q > MAX_Q, ...) raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.batch import lws_sweeps as plain_lws_sweeps
from ..core.stencil import Stencil, _parse_colors
from . import _build

__all__ = ["tiled_lws_sweeps", "sweep_schedule", "MAX_Q", "LAUNCHES"]

# Largest overlap factor the kernel takes (the JAX kernels' MAX_Q).
MAX_Q = 16

# Kernel launches so far; the main path's run is read as a difference.
LAUNCHES = 0

_LIB = "lws_sweeps"


def _library():
    lib = _build.load(_LIB)
    if lib.lws_sweeps_launch.argtypes is None:
        lib.lws_sweeps_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.lws_sweeps_launch.restype = ctypes.c_int
        lib.lws_packed_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.lws_packed_launch.restype = ctypes.c_int
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
    magnitude (the same contract as lws_tpu's kernels). backend="auto"
    launches the kernel for CUDA float32 tensors and runs the plain version
    for CPU tensors; backend="torch" runs the plain version anywhere.
    """
    reject_tpu_knobs("tiled_lws_sweeps",
                     dict(storage=None, micro=1, lane_fold=1, tap_chunks=1, lane_skip=False),
                     storage=storage, micro=micro, lane_fold=lane_fold,
                     tap_chunks=tap_chunks, lane_skip=lane_skip)
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")
    if backend == "torch" or sr.device.type == "cpu":
        return plain_lws_sweeps(sr, si, st, thresholds, order="gs",
                                inner_passes=inner_passes,
                                inner_scheme=inner_scheme, halo=halo,
                                mean_amp=mean_amp)
    if sr.device.type != "cuda":
        raise ValueError(f"lws_torch: the sweep kernel runs on CUDA, got {sr.device}")
    return _launch(sr, si, st, thresholds, inner_passes, inner_scheme, halo,
                   mean_amp)


def _launch(sr, si, st, thresholds, inner_passes, inner_scheme, halo, mean_amp):
    global LAUNCHES
    out, launched = launch_padded(
        "lws_sweeps_launch", sr, si, st, thresholds, halo, mean_amp,
        _schedule_args(st, inner_passes, inner_scheme))
    LAUNCHES += launched
    return out


def launch_padded(entry, sr, si, st, thresholds, halo, mean_amp, schedule):
    """Check the inputs, build the padded state and the schedule, and run
    csrc/lws_sweeps.cu's `entry` (lws_sweeps_launch or lws_packed_launch)
    once with `schedule` (its int arguments after `iters`). Returns the
    output pair and whether a kernel was launched (not for zero sweeps)."""
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
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"lws_torch: the sweep kernels take Q <= {MAX_Q}, got Q={Q}")
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
    wr = st.Wr.contiguous()
    wi = st.Wi.contiguous()
    thr = thr.contiguous()
    live = live.contiguous()

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(
        xr.data_ptr(), xi.data_ptr(), amp.data_ptr(), wr.data_ptr(),
        wi.data_ptr(), thr.data_ptr(), live.data_ptr(),
        B, T, F, Q, L, iters, *schedule, stream)
    if err != 0:
        msg = lib.lws_sweeps_error_string(err).decode()
        raise RuntimeError(f"lws_torch: {entry} failed: {msg} ({err})")
    return (xr[:, Q1:Q1 + T].reshape(shape), xi[:, Q1:Q1 + T].reshape(shape)), True
