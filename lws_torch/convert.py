"""Carry parameters and state across from the JAX package.

`stencil_from_numpy` turns the arrays of an lws_tpu stencil, fetched as
numpy (`np.asarray(st.Wr)`, `np.asarray(st.Wi)`, `st.nz`), into the port's
`Stencil`, so that both packages can be fed identical weights.
`stream_state_from_numpy` turns the window of an lws_tpu StreamingLWS on
its per-frame ("xla") backend into the port's stream state, so that a
stream begun by one package can go on in the other. Both take plain
arrays: lws_torch imports nothing of lws_tpu.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.online import ChunkState
from .core.stencil import Stencil


def stencil_from_numpy(Wr, Wi, nz, Q: int, L: int, *, device=None,
                       dtype=torch.float32) -> Stencil:
    """A `Stencil` on `device` from real/imag weights (2Q-1, 2L+1, F) and the
    host tap mask (2Q-1, 2L+1)."""
    Wr = np.asarray(Wr)
    Wi = np.asarray(Wi)
    nz = np.asarray(nz, dtype=bool)
    shape = (2 * Q - 1, 2 * L + 1)
    if Wr.shape != Wi.shape or Wr.shape[:2] != shape or nz.shape != shape:
        raise ValueError(f"stencil arrays {Wr.shape}/{Wi.shape}/{nz.shape} do "
                         f"not fit Q={Q}, L={L}")
    dev = resolve_device(device)
    # torch.tensor copies: arrays fetched from jax are read-only
    return Stencil(Wr=torch.tensor(Wr).to(dev, dtype),
                   Wi=torch.tensor(Wi).to(dev, dtype),
                   nz=nz.copy(), Q=int(Q), L=int(L))


def stream_state_from_numpy(win_r, win_i, amp_w, amp_sum, frames_seen, Q: int, L: int,
                            LA: int, *, device=None, dtype=torch.float32):
    """(state, amp_sum, count) for lws_torch's StreamingLWS from an lws_tpu
    StreamingLWS (backend="xla") after `frames_seen` >= 1 frames:
    `_win_r` / `_win_i` ([S,] LA+2Q-1, F+2L), frequency-extended rows, the
    frame seen-1 at row LA+Q-1 and its LA+Q-1 predecessors above it (the
    rows below are padding); `_amp_w` ([S,] LA+2Q-1, F) in the same rows;
    `_amp_sum` (scalar or (S,)), the running sum of per-frame mean |S|.

    The port's state keeps the last LA+Q frames un-extended, frame f in slot
    f mod (LA+Q), and the amp rows of the last LA+1 frames in slot
    f mod (LA+1) (core/online.py::ChunkState); its running mean is
    (amp_sum, count) with count = frames_seen.
    """
    win_r, win_i, amp_w = (np.asarray(a) for a in (win_r, win_i, amp_w))
    if win_r.ndim == 2:
        win_r, win_i, amp_w = win_r[None], win_i[None], amp_w[None]
    seen = int(frames_seen)
    K = LA + Q
    F = amp_w.shape[-1]
    if seen < 1 or win_r.shape[1:] != (K + Q - 1, F + 2 * L) or win_i.shape != win_r.shape:
        raise ValueError(f"stream window {win_r.shape} / amp {amp_w.shape} after {seen} "
                         f"frames does not fit Q={Q}, L={L}, LA={LA}")
    # row j holds frame seen-K+j
    slots = (seen - K + np.arange(K)) % K
    ring_r = np.empty((win_r.shape[0], K, F))
    ring_i = np.empty_like(ring_r)
    ring_r[:, slots] = win_r[:, :K, L:L + F]
    ring_i[:, slots] = win_i[:, :K, L:L + F]
    aslots = (seen - LA - 1 + np.arange(LA + 1)) % (LA + 1)
    amp = np.empty((win_r.shape[0], LA + 1, F))
    amp[:, aslots] = amp_w[:, K - LA - 1:K]
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(a).to(dev, dtype)

    state = ChunkState(put(ring_r), put(ring_i), put(amp), seen)
    asum = put(np.broadcast_to(np.asarray(amp_sum, np.float64), (win_r.shape[0],)).copy())
    return state, asum, seen
