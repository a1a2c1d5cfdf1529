"""A ready-made forward step of the music pipeline, for smoke checks.

Counterpart of the JAX package's `__graft_entry__.entry`: `entry()` returns
(fn, example_args), where fn runs the three stages of `LWS(512, 128)`
(no-future 1 sweep, online 2 rounds, batch 5 sweeps) on a (2, 24, 257)
pair of float32 planes and returns the recovered pair.
"""
from __future__ import annotations

import numpy as np
import torch

from .processor import LWS
from .windows import get_thresholds

__all__ = ["entry"]


def entry(device=None):
    """(fn, example_args) on `device` (CUDA unless the caller names another):
    fn(sr, si) -> (sr, si) runs no-future -> online -> batch."""
    proc = LWS(512, 128, L=5, device=device)
    thr_nf = get_thresholds(1, 1, 0.1, 1)
    thr_on = get_thresholds(2, 1, 0.1, 1)
    thr_b = get_thresholds(5, 100, 0.1, 1)

    def fn(sr, si):
        pair = proc.nofuture_lws((sr, si), thresholds=thr_nf)
        pair = proc.online_lws(pair, thresholds=thr_on)
        return proc.batch_lws(pair, thresholds=thr_b)

    rng = np.random.default_rng(0)
    amp = torch.tensor(np.abs(rng.standard_normal((2, 24, 257))).astype(np.float32),
                       device=proc.device)
    return fn, (amp, torch.zeros_like(amp))
