"""Window construction and threshold schedules (host-side precompute layer).

These run once per processor construction, so they are plain numpy in float64
for maximum precision; the device layer (stft/core) casts to the working dtype.

Semantics match the reference library Jonathan-LeRoux/lws:
  - hann:                     python/lws.pyx:10-19
  - synthwin:                 python/lws.pyx:22-40
  - build_asymmetric_windows: python/lws.pyx:184-200
  - get_thresholds:           python/lws.pyx:203-206
(re-derived from the math, not ported line-by-line).

This is lws_torch's own copy of `lws_tpu.windows`: importing that module
runs `lws_tpu/__init__.py`, which imports jax, and lws_torch never does.
tests/test_torch_windows.py holds the two copies equal.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "hann",
    "synthwin",
    "build_asymmetric_windows",
    "get_thresholds",
    "default_window",
    "overlap_factor",
]


def overlap_factor(fsize: int, fshift: int) -> tuple[int, float]:
    """Return (Q, Qfloat): integer (ceil) and exact overlap factors."""
    Q = int(np.ceil(float(fsize) / float(fshift)))
    return Q, float(fsize) / float(fshift)


def hann(n: int, symmetric: bool = True, use_offset: bool = False) -> np.ndarray:
    """Hann window of length n.

    symmetric=True uses half-sample-centred sampling (peak between the two
    middle samples), matching the reference default; otherwise a periodic
    window with optional one-sample offset.
    """
    if symmetric:
        # sample the raised cosine at odd half-integers 1/2, 3/2, ... (n-1/2)
        return 0.5 * (1.0 - np.cos(np.pi * np.arange(1, 2 * n, 2) / n))
    offset = 1 if use_offset else 0
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * (np.arange(n) + offset) / n))


def synthwin(awin: np.ndarray, fshift: int, swin: np.ndarray | None = None) -> np.ndarray:
    """Normalise a synthesis window for perfect reconstruction (COLA).

    Folds awin*swin over all Q frame shifts; the per-sample normaliser is the
    periodised overlap-add envelope. Raises if the envelope is not strictly
    positive (perfect reconstruction impossible).
    """
    awin = np.asarray(awin, dtype=np.float64)
    fsize = len(awin)
    Q, _ = overlap_factor(fsize, fshift)
    if swin is None:
        swin = awin
    swin = np.asarray(swin, dtype=np.float64)
    twin = awin * swin
    padded = np.zeros(Q * fshift)
    padded[:fsize] = twin
    envelope_period = padded.reshape(Q, fshift).sum(axis=0)
    envelope = np.tile(envelope_period, Q)[:fsize]
    if envelope.min() <= 0:
        raise ValueError("The overlap-add normalizer is not strictly positive")
    return swin / envelope


def default_window(fsize: int, fshift: int, symmetric: bool = True) -> np.ndarray:
    """The reference default analysis window: sqrt(sqrt(hann) * synthwin(sqrt(hann))).

    Mirrors python/lws.pyx:384-387.
    """
    a = np.sqrt(hann(fsize, symmetric=symmetric))
    return np.sqrt(a * synthwin(a, fshift))


def build_asymmetric_windows(awin_swin: np.ndarray, fshift: int) -> tuple[np.ndarray, np.ndarray]:
    """Mirrored-envelope asymmetric windows for TF-domain RTISI-LA.

    Input is the *product* of analysis and synthesis windows. Returns
    (win_asym_init, win_asym_full): the time-reversed partial (shifts >= 1) and
    full overlap-add envelopes, used for the newest uncommitted frame in online
    LWS. The reference's Q==2 special case (python/lws.pyx:198-199, condition
    `T % fshift == 2`, admitted there to be a hack for T == 2*fshift) is
    reproduced for drop-in parity.
    """
    w = np.asarray(awin_swin, dtype=np.float64)
    T = len(w)
    Q, _ = overlap_factor(T, fshift)
    shifted = np.zeros((T, Q))
    for q in range(Q):
        nkeep = T - q * fshift
        shifted[:nkeep, q] = w[q * fshift:]
    win_ai = shifted[:, 1:].sum(axis=1)[::-1].copy()
    win_af = shifted.sum(axis=1)[::-1].copy()
    if T % fshift == 2:
        win_ai = w.copy()
    return win_ai, win_af


def get_thresholds(iterations: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Per-iteration sparsity thresholds: alpha * exp(-beta * i**gamma)."""
    return alpha * np.exp(-beta * np.arange(iterations) ** gamma)
