"""Online LWS: TF-domain RTISI-LA as a frame-commit loop, plain PyTorch.

Counterpart of lws_tpu/core/online.py (the reference driver TF_RTISI_LA,
lwslib/lwslib.cpp:1424-1492). For each newest frame m, left to right:

  1. initialise its phase from strictly-past frames with the asymmetric-init
     weights at threshold 0                           -> st_ai (v = -1)
  2. for each of the `iterations` rounds h:
     a. re-update the look-ahead frames m-d, d = LA..1 (ascending frame
        order; frames before the start are skipped) with the normal
        weights, a frame d behind the newest seeing at most min(d, Q-1)
        future frames                                 -> st_la[d-1]
     b. re-update the newest frame with the asymmetric-full weights
                                                      -> st_af (v = 0)

No update reads a frame after m, so the frames past m keep the stage input
until their turn. Thresholds are thresholds[h] * mean |S| per item, over
the stage input; the frozen time halos are edge replicas.

This is the plain version of the online kernel (lws_torch/csrc/lws_online.cu,
wrapped by lws_torch/ops/online.py); the wrapper takes it for CPU tensors
or backend="torch".
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


def rtisi_la(
    sr: torch.Tensor,
    si: torch.Tensor,
    st_la: list[Stencil],
    st_ai: Stencil,
    st_af: Stencil,
    thresholds,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
):
    """Run online (RTISI-LA) phase recovery over (sr, si) of shape (..., T, F).

    st_la[d-1] is the batch stencil at visibility min(d, Q-1), d = 1..LA.
    `inner_passes` / `inner_scheme` apply to the look-ahead and newest-frame
    updates, as in lws_tpu's rtisi_la; the initialisation has no centre taps.
    """
    thresholds = torch.as_tensor(thresholds, dtype=sr.dtype, device=sr.device)
    iters = int(thresholds.shape[0])
    if iters == 0:
        return sr, si
    Q, L = st_af.Q, st_af.L
    LA = len(st_la)
    T, F = sr.shape[-2:]

    amp = torch.sqrt(sr * sr + si * si)
    mean_amp = amp.mean(dim=(-2, -1))[..., None]  # (..., 1)

    er, ei = freq_extend(sr, si, L)
    top_r, bot_r = make_time_halos(er, Q)
    top_i, bot_i = make_time_halos(ei, Q)
    xr = time_extend(er, top_r, bot_r)
    xi = time_extend(ei, top_i, bot_i)

    for m in range(T):
        amp_m = amp[..., m, :]
        update_frame(xr, xi, m, amp_m, st_ai, torch.zeros_like(amp_m))
        for h in range(iters):
            thr = thresholds[h] * mean_amp
            for d in range(LA, 0, -1):
                f = m - d
                if f >= 0:
                    update_frame(xr, xi, f, amp[..., f, :], st_la[d - 1], thr,
                                 inner_passes, inner_scheme)
            update_frame(xr, xi, m, amp_m, st_af, thr, inner_passes, inner_scheme)
    return (xr[..., Q - 1:Q - 1 + T, L:L + F].contiguous(),
            xi[..., Q - 1:Q - 1 + T, L:L + F].contiguous())
