"""The plain reference of the paths the benchmark drives, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: from
a configuration's program keys it works out the windows, weights and
thresholds again (`config.py`, `windows.py`), and from the benchmark's
signals or magnitudes it computes

  - the STFT, the iSTFT and the consistency of the library
    (python/lws.pyx:43-144, perfectrec padding);
  - Gauss-Seidel LWS sweeps in the library's frame order
    (lwslib.cpp:59-145): frame after frame, each frame's update reading
    the frames before it from this sweep and the frames after it from the
    last one, the in-frame passes recomputing the centre-frame taps from
    the previous pass with the frame's value before the update as the
    fallback, a sweep no bin passes skipped (it changes nothing);
  - sweeps in the Jacobi orders: every frame of a sweep from the last
    sweep's frames, every tap once;
  - TF-domain RTISI-LA (lwslib.cpp:1424-1492): per newest frame an
    initialisation from the past frames, then per round the look-ahead
    frames and the newest one, a frame final once it leaves the window.

A frame's tap sum is written as one matrix product: the state holds each
frame as (re, im) rows of F bins, and each stencil becomes a real matrix
from the (2Q-1) frames around a frame to its 2F outputs, with the
conjugate reflection below DC and above Nyquist folded into the matrix.
Everything runs in the dtype it is given: float64 for the reference, a
lower one for the control. torch.fft has no bfloat16 transform: there the
transform runs in float32 on bfloat16 values and its result is rounded
back.

On CUDA one sweep of the frame loop is captured once as a CUDA graph and
replayed for every live sweep; on the CPU it runs eagerly. Both run the
same operations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

from . import config as C

class Mats(NamedTuple):
    """One stencil as matrices on the (re, im) rows of F bins."""
    off: torch.Tensor            # ((2Q-1) * 2F, 2F): every frame but the centre one
    centre: torch.Tensor | None  # (2F, 2F), None where the stencil has no centre taps


def stencil_mats(st: np.ndarray, device, dtype) -> Mats:
    """Real matrices of a complex stencil (2Q-1, 2L+1, F). Output n reads
    bin j = n + dk - L of frame row dr; below DC and above Nyquist j is the
    conjugate of bin -j or 2(F-1) - j (lwslib.cpp:27-40)."""
    R, K, F = st.shape
    L, c = (K - 1) // 2, (R - 1) // 2
    dr, dk, n = np.nonzero(st)
    w = st[dr, dk, n]
    j = n + dk - L
    b = np.where(j < 0, -j, np.where(j >= F, 2 * (F - 1) - j, j))
    sg = np.where((j < 0) | (j >= F), -1.0, 1.0)
    M = np.zeros((R, 2 * F, 2 * F))
    np.add.at(M, (dr, b, n), w.real)               # re -> re
    np.add.at(M, (dr, F + b, n), -w.imag * sg)     # im -> re
    np.add.at(M, (dr, F + b, F + n), w.real * sg)  # im -> im
    np.add.at(M, (dr, b, F + n), w.imag)           # re -> im
    centre = M[c].copy() if np.any(M[c]) else None
    M[c] = 0.0

    def put(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return Mats(put(M.reshape(R * 2 * F, 2 * F)), None if centre is None else put(centre))


class Tables:
    """What the reference derives from a configuration's program keys
    (`config.Program`): windows and, with `stencils`, the stencils as
    matrices, the thresholds and the in-frame passes."""

    def __init__(self, spec: C.Program, device, dtype, stencils: bool = True):
        self.spec = spec
        self.fsize, self.fshift, self.L, self.LA = spec.fsize, spec.fshift, spec.L, spec.LA
        self.Q, self.F = spec.Q, spec.F
        self.device, self.dtype = torch.device(device), dtype
        awin, swin = C.windows(self.fsize, self.fshift)
        self.awin = torch.as_tensor(awin).to(device=device, dtype=dtype)
        self.swin = torch.as_tensor(swin).to(device=device, dtype=dtype)
        if not stencils:
            return
        self.mats = {k: stencil_mats(v, device, dtype) for k, v in spec.stencils().items()}
        self.thr = {s: torch.as_tensor(t).to(device=device, dtype=dtype)
                    for s, t in spec.thr.items()}
        self.batch_passes, self.online_passes = spec.batch_passes, spec.online_passes


# ---------------------------------------------------------------- STFT ----

def _fft_dtype(x):
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype


def _pre(fsize, fshift):
    return fsize - fshift if fsize % fshift == 0 else fsize - fsize % fshift


def spectra(frames: torch.Tensor, awin: torch.Tensor) -> torch.Tensor:
    """(..., M, fsize) frames -> (..., M, 2, F): rfft of the windowed frames."""
    spec = torch.fft.rfft((frames * awin).to(_fft_dtype(frames)), dim=-1)
    return torch.stack([spec.real, spec.imag], dim=-2).to(frames.dtype)


def stft(x: torch.Tensor, tb: Tables) -> torch.Tensor:
    """(B, n) signals -> (B, M, 2, F), the library's perfectrec layout."""
    fsize, fshift = tb.fsize, tb.fshift
    n = x.shape[-1]
    pre = _pre(fsize, fshift)
    post = (-n) % fshift
    M = (pre + n + post) // fshift
    tail = (M - 1) * fshift + fsize - (pre + n + post)
    xp = tnf.pad(x, (pre, post + tail))
    return spectra(xp.unfold(-1, fsize, fshift), tb.awin)


def overlap_add(frames: torch.Tensor, fshift: int) -> torch.Tensor:
    """(B, M, fsize) -> (B, (M-1) * fshift + fsize)."""
    B, M, fsize = frames.shape
    K = -(-fsize // fshift)
    fp = tnf.pad(frames, (0, K * fshift - fsize))
    y = frames.new_zeros((B, (M + K) * fshift))
    for k in range(K):
        y[:, k * fshift:(k + M) * fshift] += fp[:, :, k * fshift:(k + 1) * fshift].reshape(
            B, M * fshift)
    return y[:, :(M - 1) * fshift + fsize]


def synth_frames(S: torch.Tensor, tb: Tables) -> torch.Tensor:
    """(B, M, 2, F) -> (B, M, fsize): irfft times the synthesis window. The
    imaginary parts of the DC and Nyquist bins, which a real frame cannot
    hold, are dropped first, as numpy's irfft in the library drops them
    (cuFFT's may not, for input that is not Hermitian)."""
    re = S[..., 0, :].to(_fft_dtype(S))
    im = S[..., 1, :].to(_fft_dtype(S)).clone()
    im[..., 0] = 0
    im[..., -1] = 0
    return torch.fft.irfft(torch.complex(re, im), n=tb.fsize, dim=-1).to(S.dtype) * tb.swin


def istft(S: torch.Tensor, tb: Tables) -> torch.Tensor:
    """(B, M, 2, F) -> (B, n): overlap-add without the perfectrec padding."""
    y = overlap_add(synth_frames(S, tb), tb.fshift)
    pre = _pre(tb.fsize, tb.fshift)
    return y[:, pre:y.shape[-1] - (tb.fsize - tb.fshift)]


def consistency(S: torch.Tensor, tb: Tables) -> torch.Tensor:
    """10 log10(||S||^2 / ||STFT(iSTFT(S)) - S||^2) dB, one value per item."""
    d = stft(istft(S, tb), tb)[:, :S.shape[1]] - S
    return 10.0 * (torch.log10((S * S).sum(dim=(1, 2, 3)))
                   - torch.log10((d * d).sum(dim=(1, 2, 3))))


# ------------------------------------------------------------ updates ----

def _frame(Z, m, H, mats: Mats, amp_m, mask_m, passes):
    """Update the frame at state row m + H from rows m .. m + 2H: the taps
    of the other frames once, then `passes` passes of the centre taps; bins
    whose magnitude is over the threshold (mask_m) and whose sum is not 0
    take the sum's phase at their magnitude, the others keep their value."""
    B, _, _, F = Z.shape
    off = Z[:, m:m + 2 * H + 1].reshape(B, -1) @ mats.off
    old = Z[:, m + H]
    row = old
    for _ in range(passes if mats.centre is not None else 1):
        s = off if mats.centre is None else torch.addmm(off, row.reshape(B, 2 * F),
                                                        mats.centre)
        s = s.view(B, 2, F)
        mag = torch.linalg.vector_norm(s, dim=1)
        upd = (mask_m & (mag > 0))[:, None, :]
        row = torch.where(upd, s * (amp_m / mag)[:, None, :], old)
    Z[:, m + H] = row


def _padded(X, H, bottom_zero=False):
    B, T, _, F = X.shape
    top = X[:, :1].expand(B, H, 2, F)
    bot = X.new_zeros((B, H, 2, F)) if bottom_zero else X[:, -1:].expand(B, H, 2, F)
    return torch.cat([top, X, bot], dim=1).contiguous()


def _capture(sweep, Z):
    """A CUDA graph of sweep(Z), after a warm-up run on a copy of Z on a
    side stream (which initialises the libraries the sweep calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep(Z.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sweep(Z)
    return graph


def gs_sweeps(X: torch.Tensor, mats: Mats, thresholds: torch.Tensor, passes: int,
              graphs: bool = True) -> torch.Tensor:
    """len(thresholds) Gauss-Seidel sweeps over (B, T, 2, F). The target
    magnitudes are |X| and the threshold of sweep i is thresholds[i] times
    the item's mean magnitude; the frames outside are frozen copies of the
    first and the last frame."""
    B, T, _, F = X.shape
    H = (mats.off.shape[0] // (2 * F) - 1) // 2
    amp = torch.linalg.vector_norm(X, dim=2)
    mean = amp.mean(dim=(1, 2))
    thr = thresholds[:, None] * mean[None, :]
    live = (amp.amax(dim=(1, 2))[None, :] > thr).any(dim=1).tolist()
    Z = _padded(X, H)
    mask = torch.zeros((B, T, F), dtype=torch.bool, device=X.device)

    def sweep(state):
        for m in range(T):
            _frame(state, m, H, mats, amp[:, m], mask[:, m], passes)

    graph = _capture(sweep, Z) if graphs and X.is_cuda and any(live) else None
    for i, alive in enumerate(live):
        if alive:
            torch.gt(amp, thr[i][:, None, None], out=mask)
            graph.replay() if graph is not None else sweep(Z)
    return Z[:, H:H + T].contiguous()


def jacobi_sweeps(X: torch.Tensor, mats: Mats, thresholds: torch.Tensor) -> torch.Tensor:
    """len(thresholds) Jacobi sweeps over (B, T, 2, F): each live sweep
    sums every tap once over the last sweep's frames and updates all
    frames together; targets, thresholds and the frozen frames outside as
    in gs_sweeps."""
    B, T, _, F = X.shape
    H = (mats.off.shape[0] // (2 * F) - 1) // 2
    amp = torch.linalg.vector_norm(X, dim=2)
    thr = thresholds[:, None] * amp.mean(dim=(1, 2))[None, :]
    live = (amp.amax(dim=(1, 2))[None, :] > thr).any(dim=1).tolist()
    Z = _padded(X, H)
    for i, alive in enumerate(live):
        if not alive:
            continue
        old = Z[:, H:H + T]
        win = torch.stack([Z[:, d:d + T] for d in range(2 * H + 1)], dim=2)
        s = win.reshape(B, T, -1) @ mats.off
        if mats.centre is not None:
            s = s + old.reshape(B, T, 2 * F) @ mats.centre
        s = s.view(B, T, 2, F)
        mag = torch.linalg.vector_norm(s, dim=2)
        upd = ((amp > thr[i][:, None, None]) & (mag > 0))[:, :, None, :]
        Z[:, H:H + T] = torch.where(upd, s * (amp / mag)[:, :, None, :], old)
    return Z[:, H:H + T].contiguous()


def rtisi_la(X: torch.Tensor, mean: torch.Tensor, thresholds: torch.Tensor, tb: Tables,
             passes: int) -> torch.Tensor:
    """RTISI-LA over (B, T, 2, F) frames; mean (B,) is each item's
    threshold scale. Returns the committed frames."""
    B, T, _, F = X.shape
    H, LA = tb.Q - 1, tb.LA
    amp = torch.linalg.vector_norm(X, dim=2)
    Z = _padded(X, H, bottom_zero=True)
    la = [tb.mats[f"la{d}"] for d in range(1, LA + 1)]
    for m in range(T):
        _frame(Z, m, H, tb.mats["ai"], amp[:, m], amp[:, m] > 0, 1)
        for h in range(thresholds.shape[0]):
            t = thresholds[h] * mean[:, None]
            for d in range(LA, 0, -1):
                if m - d >= 0:
                    _frame(Z, m - d, H, la[d - 1], amp[:, m - d], amp[:, m - d] > t, passes)
            _frame(Z, m, H, tb.mats["af"], amp[:, m], amp[:, m] > t, passes)
    return Z[:, H:H + T].contiguous()


# -------------------------------------------------------------- paths ----

def offline(A: torch.Tensor, tb: Tables, entry: str, graphs: bool = True) -> torch.Tensor:
    """What the processor's `entry` (config.ENTRY_STAGES) makes of
    magnitudes A (B, T, F) at zero phase: (B, T, 2, F)."""
    X = torch.stack([A, torch.zeros_like(A)], dim=2)
    for stage in tb.spec.stages(entry):
        if stage != "online" and tb.spec.order != "gs":
            X = jacobi_sweeps(X, tb.mats["ai" if stage == "nofuture" else "batch"], tb.thr[stage])
        elif stage == "nofuture":
            X = gs_sweeps(X, tb.mats["ai"], tb.thr["nofuture"], 1, graphs)
        elif stage == "online":
            mean = torch.linalg.vector_norm(X, dim=2).mean(dim=(1, 2))
            X = rtisi_la(X, mean, tb.thr["online"], tb, tb.online_passes)
        else:
            X = gs_sweeps(X, tb.mats["batch"], tb.thr["batch"], tb.batch_passes, graphs)
    return X
