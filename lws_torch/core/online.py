"""Online LWS: TF-domain RTISI-LA as a frame-commit loop, plain PyTorch.

Counterpart of lws_tpu/core/online.py (the reference driver TF_RTISI_LA,
lwslib/lwslib.cpp:1424-1492) and of the per-frame step of
lws_tpu/streaming.py. For each newest frame m, left to right:

  1. initialise its phase from strictly-past frames with the asymmetric-init
     weights at threshold 0                           -> st_ai (v = -1)
  2. for each of the `iterations` rounds h:
     a. re-update the look-ahead frames m-d, d = LA..1 (ascending frame
        order; frames before the start are skipped) with the normal
        weights, a frame d behind the newest seeing at most min(d, Q-1)
        future frames                                 -> st_la[d-1]
     b. re-update the newest frame with the asymmetric-full weights
                                                      -> st_af (v = 0)
  3. frame m-LA leaves the look-ahead window: it is final (committed).

No update reads a frame after m, so the frames past m keep the stage input
until their turn. Frames before the start are frozen edge replicas of
frame 0 and are never updated.

`online_chunk` runs that loop over a chunk of N frames from a carried
state, the way a stream advances (lws_tpu.ops.pallas_packed.online_chunk);
`rtisi_la` is the whole spectrogram as one chunk plus LA drain steps, with
the threshold scale mean |S| per item.

This is the plain version of the online kernels (lws_torch/csrc/lws_online.cu,
wrapped by lws_torch/ops/online.py); the wrappers take it for CPU tensors
or backend="torch". Autograd differentiates it: the magnitudes go through
`safe_sqrt`, and nothing that autograd saved is written in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .stencil import Stencil, freq_extend, safe_sqrt, update_frame


class ChunkState(NamedTuple):
    """What a stream carries from one chunk to the next, per stream b.

    ring_r / ring_i (B, LA+Q, F): the last LA+Q frames as they stand,
    un-extended, frame f in slot f mod (LA+Q); amp (B, LA+1, F): the target
    magnitudes of the last LA+1 frames, frame f in slot f mod (LA+1) (zero
    for drain frames); seen: the absolute index of the chunk's first frame.
    The kernel (lws_online.cu) keeps the same slots in shared memory.
    """

    ring_r: torch.Tensor
    ring_i: torch.Tensor
    amp: torch.Tensor
    seen: int


def _slots(first: int, count: int, mod: int, device) -> torch.Tensor:
    """Ring slots of the absolute frames first .. first+count-1."""
    return torch.arange(first, first + count, device=device) % mod


def online_chunk_init(st_la: list[Stencil], st_af: Stencil, fr0: torch.Tensor,
                      fi0: torch.Tensor) -> ChunkState:
    """The state before frame 0 of each stream, from that frame (B, F):
    every ring slot holds it (the frozen edge replicas the frames before the
    start keep), the amp rows are zero (frames before the start are never
    updated)."""
    W = len(st_la) + st_af.Q
    ring_r = fr0[:, None, :].repeat(1, W, 1).contiguous()
    ring_i = fi0[:, None, :].repeat(1, W, 1).contiguous()
    amp = fr0.new_zeros((fr0.shape[0], len(st_la) + 1, fr0.shape[-1]))
    return ChunkState(ring_r, ring_i, amp, 0)


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
):
    """Advance B streams by the N frames (sr, si) of shape (B, N, F).

    means (B, N) is the threshold scale at each frame: the round-h threshold
    of step m is thresholds[h] * means[b, m]. Steps m >= n_live are drain
    steps: the frame enters the window, nothing is updated, and the pipeline
    still commits. Returns (committed_r, committed_i, new_state): row m holds
    the final value of absolute frame state.seen + m - LA (rows before the
    stream start hold frame 0's replica; the caller drops them).
    """
    thresholds = torch.as_tensor(thresholds, dtype=sr.dtype, device=sr.device)
    iters = int(thresholds.shape[0])
    Q, L = st_af.Q, st_af.L
    LA = len(st_la)
    W, WA = LA + Q, LA + 1
    B, N, F = sr.shape
    n_live = N if n_live is None else int(n_live)
    seen = int(state.seen)
    dev = sr.device

    # frames seen-(W-1) .. seen+N-1 in order: the W-1 the first step reads
    # from the ring, then the chunk; buffer row H+m holds chunk frame m
    H = W - 1
    hist = _slots(seen - H, H, W, dev)
    xr, xi = freq_extend(torch.cat([state.ring_r.index_select(1, hist), sr], dim=1),
                         torch.cat([state.ring_i.index_select(1, hist), si], dim=1), L)
    xr, xi = xr.contiguous(), xi.contiguous()
    amp = safe_sqrt(sr * sr + si * si)
    if n_live < N:  # drain steps update nothing: their target magnitude is 0
        amp = torch.cat([amp[:, :n_live], torch.zeros_like(amp[:, n_live:])], dim=1)
    ahist = _slots(seen - LA, LA, WA, dev)
    amps = torch.cat([state.amp.index_select(1, ahist), amp], dim=1)  # row LA+m: frame m

    # update_frame's index t reads buffer rows t..t+2Q-2 around row t+Q-1,
    # so chunk frame m is t = LA+m
    for m in range(n_live):
        amp_m = amps[:, LA + m]
        update_frame(xr, xi, LA + m, amp_m, st_ai, torch.zeros_like(amp_m))
        for h in range(iters):
            thr = thresholds[h] * means[:, m:m + 1]
            for d in range(LA, 0, -1):
                if seen + m - d >= 0:
                    update_frame(xr, xi, LA + m - d, amps[:, LA + m - d], st_la[d - 1],
                                 thr, inner_passes, inner_scheme)
            update_frame(xr, xi, LA + m, amp_m, st_af, thr, inner_passes, inner_scheme)

    # step m commits frame m-LA (buffer row Q-1+m), which no later step of
    # the chunk updates
    out_r = xr[:, Q - 1:Q - 1 + N, L:L + F].contiguous()
    out_i = xi[:, Q - 1:Q - 1 + N, L:L + F].contiguous()
    # the new ring: frames seen+N-W .. seen+N-1 (buffer rows N-1 ..)
    slots = _slots(seen + N - W, W, W, dev)
    ring_r = torch.empty_like(state.ring_r)
    ring_i = torch.empty_like(state.ring_i)
    ring_r[:, slots] = xr[:, N - 1:N - 1 + W, L:L + F]
    ring_i[:, slots] = xi[:, N - 1:N - 1 + W, L:L + F]
    aslots = _slots(seen + N - WA, WA, WA, dev)
    amp_new = torch.empty_like(state.amp)
    amp_new[:, aslots] = amps[:, N - 1:N - 1 + WA]
    return out_r, out_i, ChunkState(ring_r, ring_i, amp_new, seen + N)


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
    The thresholds scale with mean |S| per item, over the stage input.
    """
    thresholds = torch.as_tensor(thresholds, dtype=sr.dtype, device=sr.device)
    if int(thresholds.shape[0]) == 0:
        return sr, si
    shape = sr.shape
    T, F = shape[-2:]
    LA = len(st_la)
    sr3, si3 = sr.reshape(-1, T, F), si.reshape(-1, T, F)
    means = safe_sqrt(sr3 * sr3 + si3 * si3).mean(dim=(-2, -1))[:, None].expand(-1, T)
    args = (st_la, st_ai, st_af, thresholds)
    kw = dict(inner_passes=inner_passes, inner_scheme=inner_scheme)
    state = online_chunk_init(st_la, st_af, sr3[:, 0], si3[:, 0])
    cr, ci, state = online_chunk(sr3, si3, state, means, *args, **kw)
    if LA:
        # LA drain steps commit the last LA frames unchanged
        drain = sr3.new_zeros((sr3.shape[0], LA, F))
        dr, di, _ = online_chunk(drain, drain, state, drain[..., 0], *args, n_live=0, **kw)
        cr, ci = torch.cat([cr, dr], dim=1), torch.cat([ci, di], dim=1)
    return cr[:, LA:].reshape(shape), ci[:, LA:].reshape(shape)
