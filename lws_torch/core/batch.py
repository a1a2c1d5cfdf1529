"""Batch-mode LWS sweeps (batch and no-future schedules), plain PyTorch.

Counterpart of lws_tpu/core/batch.py, order "gs" only: iterate thresholded
phase-update sweeps over the whole spectrogram, frame after frame in the
reference's order (frame m reads frames m-Q+1..m-1 from this sweep and
m+1..m+Q-1 from the previous one). The no-future schedule is the same
sweep with a v = -1 stencil built from the asymmetric-init weights.

This is the plain version of the CUDA sweep kernel
(lws_torch/ops/lws_sweeps.py, lws_torch/csrc/lws_sweeps.cu); the kernel's
wrapper takes it for CPU tensors or backend="torch".
"""
from __future__ import annotations

import torch

from .stencil import (
    Stencil,
    freq_extend,
    make_time_halos,
    time_extend,
    update_frame,
)


def lws_sweeps(
    sr: torch.Tensor,
    si: torch.Tensor,
    st: Stencil,
    thresholds,
    order: str = "gs",
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    halo: tuple | None = None,
    mean_amp: torch.Tensor | None = None,
):
    """Run len(thresholds) LWS sweeps over (sr, si) of shape (..., T, F).

    Target magnitudes are fixed to |S| at entry (lwslib.cpp:59-65);
    thresholds are scaled by the per-item mean input magnitude
    (python/lws.pyx:240-245).

    `halo` is (top_r, top_i, bot_r, bot_i) of shape (..., Q-1, F): explicit
    frozen time-halo frames used instead of the default edge replicas, and
    `mean_amp` (...,) overrides the locally computed mean magnitude — the
    same contract as lws_tpu's lws_sweeps and its kernels.

    A sweep in which no bin of any item exceeds its threshold leaves every
    value as it was, so it is skipped; the skip is exact.
    """
    if order != "gs":
        raise NotImplementedError(
            f"lws_torch: order={order!r} is not ported yet; only 'gs' is "
            "(the Jacobi orders are ROADMAP A12)")
    thresholds = torch.as_tensor(thresholds, dtype=sr.dtype, device=sr.device)
    if thresholds.shape[0] == 0:
        return sr, si
    Q, L = st.Q, st.L
    T, F = sr.shape[-2:]
    amp = torch.sqrt(sr * sr + si * si)
    if mean_amp is None:
        mean_amp = amp.mean(dim=(-2, -1), keepdim=True)
    else:
        mean_amp = torch.as_tensor(mean_amp, device=sr.device)[..., None, None].to(amp.dtype)
    amax = amp.amax(dim=(-2, -1), keepdim=True)

    xr0, xi0 = freq_extend(sr, si, L)
    if halo is None:
        top_r, bot_r = make_time_halos(xr0, Q)
        top_i, bot_i = make_time_halos(xi0, Q)
    else:
        top_r, top_i = freq_extend(halo[0], halo[1], L)
        bot_r, bot_i = freq_extend(halo[2], halo[3], L)
    # the extended state is evolved in place: each frame update re-extends
    # its row, so at the end of a sweep the margins equal freq_extend of the
    # interior, as if re-extended at the start of the next sweep
    xr = time_extend(xr0, top_r, bot_r)
    xi = time_extend(xi0, top_i, bot_i)

    for it in range(thresholds.shape[0]):
        thr = thresholds[it] * mean_amp  # (..., 1, 1)
        if not bool((amax > thr).any()):
            continue
        thr_m = thr[..., 0, :]  # (..., 1), broadcasts against (..., F)
        for m in range(T):
            update_frame(xr, xi, m, amp[..., m, :], st, thr_m, inner_passes,
                         inner_scheme)
    return (xr[..., Q - 1:Q - 1 + T, L:L + F].contiguous(),
            xi[..., Q - 1:Q - 1 + T, L:L + F].contiguous())
