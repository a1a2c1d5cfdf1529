"""Windows, weights and thresholds of LWS, numpy only.

The benchmark's own copy of what the upstream library derives on the host
(python/lws.pyx:147-245 of github.com/Jonathan-LeRoux/lws): the default
sqrt-Hann analysis window, the perfect-reconstruction synthesis window, the
asymmetric RTISI-LA windows, the complex weights (Q', Q, L+1), their
expansion into a (2Q-1, 2L+1, F) stencil and the sparsity thresholds. It
imports nothing of the program: the reference works every table out again.
"""
from __future__ import annotations

import numpy as np

# weights at or under this magnitude are pruned (python/lws.pyx:231)
W_PRUNE = 1.0e-12


def overlap(fsize: int, fshift: int) -> tuple[int, float]:
    """(Q, Qfloat): the integer (ceil) and the exact overlap factor."""
    return int(np.ceil(fsize / fshift)), fsize / fshift


def hann(n: int) -> np.ndarray:
    """Symmetric Hann window sampled at the half-integers 1/2 .. n-1/2."""
    return 0.5 * (1.0 - np.cos(np.pi * np.arange(1, 2 * n, 2) / n))


def synthwin(awin: np.ndarray, fshift: int, swin: np.ndarray | None = None) -> np.ndarray:
    """The synthesis window normalised so that overlap-add of awin * swin is 1."""
    awin = np.asarray(awin, np.float64)
    swin = awin if swin is None else np.asarray(swin, np.float64)
    Q, _ = overlap(len(awin), fshift)
    padded = np.zeros(Q * fshift)
    padded[:len(awin)] = awin * swin
    envelope = np.tile(padded.reshape(Q, fshift).sum(axis=0), Q)[:len(awin)]
    if envelope.min() <= 0:
        raise ValueError("the overlap-add envelope is not strictly positive")
    return swin / envelope


def default_window(fsize: int, fshift: int) -> np.ndarray:
    """sqrt(sqrt(hann) * synthwin(sqrt(hann))), the library's default."""
    a = np.sqrt(hann(fsize))
    return np.sqrt(a * synthwin(a, fshift))


def asymmetric_windows(awin_swin: np.ndarray, fshift: int) -> tuple[np.ndarray, np.ndarray]:
    """(init, full) windows of the newest RTISI-LA frame: the time-reversed
    overlap-add envelope of the later shifts (>= 1) and of all shifts."""
    w = np.asarray(awin_swin, np.float64)
    T = len(w)
    Q, _ = overlap(T, fshift)
    shifted = np.zeros((T, Q))
    for q in range(Q):
        shifted[:T - q * fshift, q] = w[q * fshift:]
    init = shifted[:, 1:].sum(axis=1)[::-1].copy()
    full = shifted.sum(axis=1)[::-1].copy()
    if T % fshift == 2:  # the library's Q = 2 special case
        init = w.copy()
    return init, full


def thresholds(iterations: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """alpha * exp(-beta * i**gamma), i = 0 .. iterations-1."""
    return alpha * np.exp(-beta * np.arange(iterations) ** gamma)


def weights(awin: np.ndarray, swin: np.ndarray, fshift: int, L: int) -> np.ndarray:
    """The complex weights (Q', Q, L+1); Q' = Q (weights summarised by bin
    mod Q) when fshift divides the window, else the window length."""
    awin = np.asarray(awin, np.float64)
    swin = np.asarray(swin, np.float64)
    T = len(awin)
    Q, Qf = overlap(T, fshift)
    Qp = Q if T % fshift == 0 else T
    prod = np.zeros((T, Q))
    for q in range(Q):
        prod[:T - q * fshift, q] = awin[:T - q * fshift] * swin[q * fshift:] / T
    ks = np.arange(L + 1)
    base = np.exp(-2j * np.pi * np.outer(ks, np.arange(T)) / T) @ prod
    base = base * np.exp(-2j * np.pi * np.outer(ks, np.arange(Q)) / Qf)
    base[0, 0] -= 1.0
    ramp = np.exp(2j * np.pi * np.outer(np.arange(Qp), np.arange(Q)) / Qf)
    return np.einsum("kq,pq->pqk", base, ramp)


def stencil(W: np.ndarray, F: int) -> np.ndarray:
    """W (Q', Q, L+1) -> (2Q-1, 2L+1, F): the weight of frame m + dr - (Q-1)
    and bin n + dk - L in the update of (m, n) (lwslib.cpp:299-353)."""
    Qp, Q, Lp1 = W.shape
    L = Lp1 - 1
    Wm = np.where(np.abs(W) > W_PRUNE, W, 0.0)
    n = np.arange(F)
    Wp, Wn = Wm[n % Qp], Wm[(Qp - n) % Qp]
    st = np.zeros((2 * Q - 1, 2 * L + 1, F), np.complex128)
    c, k0 = Q - 1, L
    for r in range(Q):
        for k in range(L + 1):
            if r == 0 and k == 0:
                continue
            if r == 0:
                st[c, k0 - k] = Wp[:, 0, k]
                st[c, k0 + k] = np.conj(Wp[:, 0, k])
            elif k == 0:
                st[c - r, k0] = Wp[:, r, 0]
                st[c + r, k0] = np.conj(Wp[:, r, 0])
            else:
                st[c - r, k0 - k] = Wp[:, r, k]
                st[c + r, k0 - k] = np.conj(Wp[:, r, k])
                st[c + r, k0 + k] = Wn[:, r, k]
                st[c - r, k0 + k] = np.conj(Wn[:, r, k])
    return st


def visible(st: np.ndarray, v: int) -> np.ndarray:
    """The stencil with every frame more than v after the centre zeroed:
    v = Q-1 batch, v = 0 the newest online frame, v = -1 no future."""
    Q = (st.shape[0] + 1) // 2
    dr = np.arange(-(Q - 1), Q)
    return np.where((dr <= v)[:, None, None], st, 0.0)
