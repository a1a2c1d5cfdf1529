"""Batch-mode LWS sweeps (batch and no-future schedules), plain PyTorch.

Counterpart of lws_tpu/core/batch.py: iterate thresholded phase-update
sweeps over the whole spectrogram. order "gs" updates frame after frame in
the reference's order (frame m reads frames m-Q+1..m-1 from this sweep and
m+1..m+Q-1 from the previous one); "jacobi" and "jacobi_mxu" update the
whole grid from the previous sweep at once, the latter with the tap sums
as banded matrix products. The no-future schedule is the same sweep with a
v = -1 stencil built from the asymmetric-init weights.

`lws_sweeps` at order "gs" is the plain version of the CUDA sweep kernel
(lws_torch/ops/lws_sweeps.py, lws_torch/csrc/lws_sweeps.cu) and
`packed_sweeps` that of the grouped sweep kernel (lws_torch/ops/packed.py,
the same source); each wrapper takes its plain version for CPU tensors or
backend="torch". The Jacobi orders have no kernel: lws_tpu runs them in
XLA, and the processor runs them here on every device. Autograd
differentiates every order (amp through `safe_sqrt`).
"""
from __future__ import annotations

import torch

from .stencil import (
    Stencil,
    _taps,
    apply_stencil,
    apply_stencil_mxu,
    freq_extend,
    make_time_halos,
    phase_update,
    safe_sqrt,
    time_extend,
    update_frame,
)

ORDERS = ("gs", "jacobi", "jacobi_mxu")


def _live(amp, thresholds, mean_amp):
    """Per sweep, whether any bin of any item exceeds its threshold
    thresholds[it] * mean_amp; a sweep no bin passes changes nothing. One
    host read for all sweeps."""
    amax = amp.amax(dim=(-2, -1), keepdim=True)
    thr = thresholds.reshape((-1,) + (1,) * amax.ndim) * mean_amp
    return (amax > thr).flatten(1).any(dim=1).tolist()


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
    precision=None,
):
    """Run len(thresholds) LWS sweeps over (sr, si) of shape (..., T, F).

    Target magnitudes are fixed to |S| at entry (lwslib.cpp:59-65);
    thresholds are scaled by the per-item mean input magnitude
    (python/lws.pyx:240-245). `order` is "gs" (frame-sequential
    Gauss-Seidel, the reference's order), "jacobi" (whole-grid sweeps) or
    "jacobi_mxu" (the same Jacobi sweeps with the tap sums as banded matrix
    products; `precision` sets their float32 precision on CUDA, see
    core.stencil.matmul_precision). The Jacobi orders ignore the in-frame
    `inner_passes` / `inner_scheme`, as lws_tpu's do.

    `halo` is (top_r, top_i, bot_r, bot_i) of shape (..., Q-1, F): explicit
    frozen time-halo frames used instead of the default edge replicas, and
    `mean_amp` (...,) overrides the locally computed mean magnitude — the
    same contract as lws_tpu's lws_sweeps and its kernels.

    A sweep in which no bin of any item exceeds its threshold leaves every
    value as it was, so it is skipped; the skip is exact in every order.
    """
    if order not in ORDERS:
        raise ValueError(f"unknown sweep order: {order!r}")
    thresholds = torch.as_tensor(thresholds, dtype=sr.dtype, device=sr.device)
    if thresholds.shape[0] == 0:
        return sr, si
    Q, L = st.Q, st.L
    T, F = sr.shape[-2:]
    # safe_sqrt: zero bins (silence, padding) would put d(sqrt)/dx = inf on
    # the backward path; the forward is torch.sqrt
    amp = safe_sqrt(sr * sr + si * si)
    if mean_amp is None:
        mean_amp = amp.mean(dim=(-2, -1), keepdim=True)
    else:
        mean_amp = torch.as_tensor(mean_amp, device=sr.device)[..., None, None].to(amp.dtype)
    live = _live(amp, thresholds, mean_amp)

    xr0, xi0 = freq_extend(sr, si, L)
    if halo is None:
        top_r, bot_r = make_time_halos(xr0, Q)
        top_i, bot_i = make_time_halos(xi0, Q)
    else:
        top_r, top_i = freq_extend(halo[0], halo[1], L)
        bot_r, bot_i = freq_extend(halo[2], halo[3], L)

    if order != "gs":
        cr, ci = sr, si
        for it in range(thresholds.shape[0]):
            if not live[it]:
                continue
            er, ei = freq_extend(cr, ci, L)
            xr = time_extend(er, top_r, bot_r)
            xi = time_extend(ei, top_i, bot_i)
            if order == "jacobi_mxu":
                tr, ti = apply_stencil_mxu(xr, xi, st, precision=precision)
            else:
                tr, ti = apply_stencil(xr, xi, st)
            cr, ci = phase_update(tr, ti, amp, cr, ci, thresholds[it] * mean_amp)
        return cr, ci

    # the extended state is evolved in place: each frame update re-extends
    # its row, so at the end of a sweep the margins equal freq_extend of the
    # interior, as if re-extended at the start of the next sweep
    xr = time_extend(xr0, top_r, bot_r)
    xi = time_extend(xi0, top_i, bot_i)

    for it in range(thresholds.shape[0]):
        thr = thresholds[it] * mean_amp  # (..., 1, 1)
        if not live[it]:
            continue
        thr_m = thr[..., 0, :]  # (..., 1), broadcasts against (..., F)
        for m in range(T):
            update_frame(xr, xi, m, amp[..., m, :], st, thr_m, inner_passes,
                         inner_scheme)
    return (xr[..., Q - 1:Q - 1 + T, L:L + F].contiguous(),
            xi[..., Q - 1:Q - 1 + T, L:L + F].contiguous())


def packed_sweeps(
    sr: torch.Tensor,
    si: torch.Tensor,
    st: Stencil,
    thresholds,
    micro: int = 1,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    halo: tuple | None = None,
    mean_amp: torch.Tensor | None = None,
):
    """len(thresholds) sweeps over (..., T, F) in groups of `micro` frames:
    the plain version of lws_tpu's grouped sweeps (packed_lws_sweeps'
    _sweeps_kernel, and tiled_lws_sweeps' group update at micro > 1).

    micro = 1 is the frame-by-frame Gauss-Seidel sweep, `lws_sweeps`.
    micro > 1 updates frames [g*micro, (g+1)*micro) together, each from the
    state as it was before the group (block Jacobi inside a group, so an
    off-centre tap on a frame of the same group reads its old value). The
    in-frame passes run over the group's centre rows and are always jacobi
    passes (fallback: the original centre row), whatever `inner_scheme`
    says, as lws_tpu's group update does (pallas_packed.py:646-665);
    `inner_passes` counts only where the stencil has a centre row. The last
    group stops at frame T-1 (the `valid` mask). `halo` (top_r, top_i,
    bot_r, bot_i), each (..., Q-1, F), replaces the edge-replica time halos
    and `mean_amp` (...,) the per-item mean magnitude, as in `lws_sweeps`
    and lws_tpu's tiled_lws_sweeps. A sweep no bin passes is skipped; the
    skip is exact.
    """
    micro = max(1, int(micro))
    if micro == 1:
        return lws_sweeps(sr, si, st, thresholds, order="gs", inner_passes=inner_passes,
                          inner_scheme=inner_scheme, halo=halo, mean_amp=mean_amp)
    thresholds = torch.as_tensor(thresholds, dtype=sr.dtype, device=sr.device)
    if thresholds.shape[0] == 0:
        return sr, si
    Q, L = st.Q, st.L
    Q1 = Q - 1
    T, F = sr.shape[-2:]
    amp = safe_sqrt(sr * sr + si * si)
    if mean_amp is None:
        mean_amp = amp.mean(dim=(-2, -1), keepdim=True)
    else:
        mean_amp = torch.as_tensor(mean_amp, device=sr.device)[..., None, None].to(amp.dtype)
    live = _live(amp, thresholds, mean_amp)
    xr0, xi0 = freq_extend(sr, si, L)
    if halo is None:
        top_r, bot_r = make_time_halos(xr0, Q)
        top_i, bot_i = make_time_halos(xi0, Q)
    else:
        top_r, top_i = freq_extend(halo[0], halo[1], L)
        bot_r, bot_i = freq_extend(halo[2], halo[3], L)
    xr = time_extend(xr0, top_r, bot_r)
    xi = time_extend(xi0, top_i, bot_i)

    idx, wr_off, wi_off = st._off_centre
    wr_c, wi_c = st.Wr[Q1][None], st.Wi[Q1][None]
    has_centre = st.has_centre
    for it in range(thresholds.shape[0]):
        thr = thresholds[it] * mean_amp  # (..., 1, 1)
        if not live[it]:
            continue
        for start in range(0, T, micro):
            g = min(micro, T - start)
            # (..., g, 2Q-1, F+2L): the rows each frame of the group reads,
            # all from the state before the group
            win = torch.stack([xr[..., start + j:start + j + 2 * Q1 + 1, :]
                               for j in range(g)], dim=-3)
            wii = torch.stack([xi[..., start + j:start + j + 2 * Q1 + 1, :]
                               for j in range(g)], dim=-3)
            tr, ti = _taps(win.index_select(-2, idx), wii.index_select(-2, idx),
                           wr_off, wi_off, F)
            amp_g = amp[..., start:start + g, :]
            row_r, row_i = win[..., Q1, :], wii[..., Q1, :]
            old_r, old_i = row_r[..., L:L + F], row_i[..., L:L + F]
            for _ in range(inner_passes if has_centre else 1):
                fr, fi = tr, ti
                if has_centre:
                    cr, ci = _taps(row_r[..., None, :], row_i[..., None, :], wr_c, wi_c, F)
                    fr, fi = tr + cr, ti + ci
                new_r, new_i = phase_update(fr, fi, amp_g, old_r, old_i, thr)
                row_r, row_i = freq_extend(new_r, new_i, L)
            xr[..., Q1 + start:Q1 + start + g, :] = row_r
            xi[..., Q1 + start:Q1 + start + g, :] = row_i
    return (xr[..., Q1:Q1 + T, L:L + F].contiguous(),
            xi[..., Q1:Q1 + T, L:L + F].contiguous())
