"""Time-segmented sweeps (K2): one long utterance as S virtual utterances.

Counterpart of lws_tpu.ops.pallas_packed.segmented_lws_sweeps, which has
no kernel of its own: it runs the sweep kernel (here K1,
lws_torch/csrc/lws_sweeps.cu through ops/lws_sweeps.py) on blocks of
`sweeps_per_exchange` sweeps, and between blocks it hands each segment the
current (Q-1) edge frames of its neighbours as frozen halos. One utterance
alone fills one CTA of the card's 132 SMs; S segments fill S. Seams behave
like block-Jacobi seams refreshed once per block; the true edges of each
utterance keep their frozen stage-entry halos.

Line for line as lws_tpu's wrapper: T is padded to a multiple of S with
replicas of the last frame (they update like ordinary frames and are
dropped on return), the threshold scale is the whole utterance's mean
magnitude (or the caller's `mean_amp`) repeated per segment, the true
edges take the caller's `halo` when given, halos are exchanged before
every block and never across utterances, and `iters % sweeps_per_exchange`
sweeps run as a last, shorter block. Each block is one launch of K1
(`tiled_lws_sweeps` with `halo=` and `mean_amp=`); the exchange is torch
indexing on the device. CPU tensors and backend="torch" run the same
blocks through the plain sweeps.
"""
from __future__ import annotations

import torch

from . import lws_sweeps as _k1

__all__ = ["segmented_lws_sweeps"]

_TPU_KNOBS = dict(pack=16, storage=None, frame_unroll=1, window_carry="stack",
                  lane_skip=False, tap_chunks=1, interpret=False)


def segmented_lws_sweeps(
    sr: torch.Tensor,
    si: torch.Tensor,
    st,
    thresholds,
    segments: int = 8,
    sweeps_per_exchange: int = 1,
    micro: int = 1,
    inner_passes: int = 1,
    inner_scheme: str = "jacobi",
    halo: tuple | None = None,
    mean_amp: torch.Tensor | None = None,
    backend: str = "auto",
    *,
    pack: int = 16,
    storage=None,
    frame_unroll: int = 1,
    window_carry: str = "stack",
    lane_skip: bool = False,
    tap_chunks: int = 1,
    interpret: bool = False,
):
    """len(thresholds) sweeps over (..., T, F) with each utterance's time
    axis split into `segments` segments, halos exchanged before every block
    of `sweeps_per_exchange` sweeps.

    `halo` (top_r, top_i, bot_r, bot_i), each (..., Q-1, F), replaces the
    edge-replica halos at the true edges; `mean_amp` (...,) replaces the
    whole-utterance mean magnitude. `micro` is passed to the sweep wrapper,
    which takes only 1.
    """
    _k1.reject_tpu_knobs("segmented_lws_sweeps", _TPU_KNOBS, pack=pack, storage=storage,
                         frame_unroll=frame_unroll, window_carry=window_carry,
                         lane_skip=lane_skip, tap_chunks=tap_chunks, interpret=interpret)
    thresholds = torch.as_tensor(thresholds, device=sr.device)
    if thresholds.shape[0] == 0:
        return sr, si
    shape = sr.shape
    T, F = shape[-2:]
    B = sr.numel() // (T * F)
    sr, si = sr.reshape(B, T, F), si.reshape(B, T, F)
    Q1 = st.Q - 1
    S = max(1, int(segments))
    Tseg = -(-T // S)
    if Tseg < max(Q1, 1) * 2:
        raise ValueError(f"segments={S} leaves {Tseg} frames/segment; need >= {2 * Q1}")
    iters = int(thresholds.shape[0])
    s_ex = max(1, int(sweeps_per_exchange))
    rounds, rem = divmod(iters, s_ex)

    t_pad = S * Tseg - T
    if t_pad:
        sr = torch.cat([sr, sr[:, -1:].expand(B, t_pad, F)], dim=1)
        si = torch.cat([si, si[:, -1:].expand(B, t_pad, F)], dim=1)

    if mean_amp is None:
        amp_mean = torch.sqrt(sr[:, :T] ** 2 + si[:, :T] ** 2).mean(dim=(-2, -1))
    else:
        amp_mean = torch.as_tensor(mean_amp, device=sr.device).reshape(B).to(sr.dtype)
    mean_seg = amp_mean.repeat_interleave(S)  # (B*S,): the whole utterance's mean

    seg_r = sr.reshape(B * S, Tseg, F)
    seg_i = si.reshape(B * S, Tseg, F)

    # frozen stage-entry halos of each utterance's true edges
    if halo is None:
        frozen = [x.expand(B, Q1, F) for x in
                  (sr[:, :1], si[:, :1], sr[:, -1:], si[:, -1:])]
    else:
        frozen = [torch.as_tensor(h, device=sr.device).reshape(B, Q1, F).to(sr.dtype)
                  for h in halo]
    frozen = [h.repeat_interleave(S, dim=0) for h in frozen]  # (B*S, Q1, F)
    seg_id = torch.arange(B * S, device=sr.device) % S
    first = (seg_id == 0)[:, None, None]
    last = (seg_id == S - 1)[:, None, None]

    def exchange(cr, ci):
        # each segment's neighbours' current edge frames; the roll wraps
        # across utterances only where first / last select the frozen halos
        return (torch.where(first, frozen[0], torch.roll(cr[:, Tseg - Q1:], 1, dims=0)),
                torch.where(first, frozen[1], torch.roll(ci[:, Tseg - Q1:], 1, dims=0)),
                torch.where(last, frozen[2], torch.roll(cr[:, :Q1], -1, dims=0)),
                torch.where(last, frozen[3], torch.roll(ci[:, :Q1], -1, dims=0)))

    def run_block(cr, ci, thr_block):
        return _k1.tiled_lws_sweeps(cr, ci, st, thr_block, inner_passes, inner_scheme,
                                    halo=exchange(cr, ci), mean_amp=mean_seg,
                                    backend=backend, micro=micro)

    cr, ci = seg_r.contiguous(), seg_i.contiguous()
    for r in range(rounds):
        cr, ci = run_block(cr, ci, thresholds[r * s_ex:(r + 1) * s_ex])
    if rem:
        cr, ci = run_block(cr, ci, thresholds[rounds * s_ex:])

    osr = cr.reshape(B, S * Tseg, F)[:, :T]
    osi = ci.reshape(B, S * Tseg, F)[:, :T]
    return osr.reshape(shape), osi.reshape(shape)
