"""The plain reference of the mel vocoder's front end, in plain PyTorch.

It imports nothing of the program. From a configuration's `mel` object
(`n_mels`, `fmin`, `fmax`, `htk`, `norm`, `eps`) it builds

  - the triangular mel filterbank (n_mels, F) over the rfft's bins: band
    edges equally spaced on the mel scale (Slaney's: linear below 1 kHz at
    200/3 Hz a mel, logarithmic above at ln(6.4) / 27 a mel; or HTK's
    2595 log10(1 + f / 700)), each band rising from its lower edge to its
    centre and falling to its upper edge, with Slaney's norm scaling each
    band by 2 / (its upper edge - its lower edge) in Hz;
  - the Moore-Penrose pseudo-inverse of that filterbank
    (`torch.linalg.pinv`), applied to mel magnitudes as one product and
    clamped from below at `eps`: the Tacotron-style mel -> linear
    inversion before phase recovery.

Everything runs in the dtype it is given: float64 for the reference, a
lower one for the control. torch.linalg has no bfloat16 pseudo-inverse:
there it is taken in float32 and rounded.
"""
from __future__ import annotations

import math

import torch

_F_SP = 200.0 / 3  # Hz a mel below the break (Slaney)
_BREAK_HZ = 1000.0
_LOG_STEP = math.log(6.4) / 27.0  # mels above the break, in log Hz


def hz_to_mel(f: torch.Tensor, htk: bool) -> torch.Tensor:
    if htk:
        return 2595.0 * torch.log10(1.0 + f / 700.0)
    above = _BREAK_HZ / _F_SP + torch.log(f.clamp_min(_BREAK_HZ) / _BREAK_HZ) / _LOG_STEP
    return torch.where(f >= _BREAK_HZ, above, f / _F_SP)


def mel_to_hz(m: torch.Tensor, htk: bool) -> torch.Tensor:
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    brk = _BREAK_HZ / _F_SP
    return torch.where(m >= brk, _BREAK_HZ * torch.exp(_LOG_STEP * (m - brk)), m * _F_SP)


def filterbank(mel: dict, fftsize: int, sample_rate: float, device, dtype) -> torch.Tensor:
    """(n_mels, fftsize // 2 + 1): the configuration's mel filterbank."""
    f64 = torch.float64
    n = int(mel["n_mels"])
    freqs = torch.linspace(0.0, sample_rate / 2, fftsize // 2 + 1, dtype=f64)
    lo, hi = (hz_to_mel(torch.tensor(float(mel[k]), dtype=f64), mel["htk"])
              for k in ("fmin", "fmax"))
    edges = mel_to_hz(torch.linspace(float(lo), float(hi), n + 2, dtype=f64), mel["htk"])
    rise = (freqs[None, :] - edges[:n, None]) / (edges[1:n + 1] - edges[:n])[:, None]
    fall = (edges[2:, None] - freqs[None, :]) / (edges[2:] - edges[1:n + 1])[:, None]
    fb = torch.minimum(rise, fall).clamp_min(0.0)
    if mel["norm"] == "slaney":
        fb = fb * (2.0 / (edges[2:] - edges[:n]))[:, None]
    elif mel["norm"] is not None:
        raise ValueError(f"norm {mel['norm']!r} is not 'slaney' or None")
    return fb.to(device=device, dtype=dtype)


def pinv(fb: torch.Tensor) -> torch.Tensor:
    """(F, n_mels): the pseudo-inverse of the filterbank, in its dtype."""
    if fb.dtype in (torch.bfloat16, torch.float16):
        return torch.linalg.pinv(fb.float()).to(fb.dtype)
    return torch.linalg.pinv(fb)


def to_mel(A: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(..., T, F) linear magnitudes -> (..., T, n_mels)."""
    return A @ fb.T


def to_linear(M: torch.Tensor, inv: torch.Tensor, eps: float) -> torch.Tensor:
    """(..., T, n_mels) mel magnitudes -> (..., T, F): the pseudo-inverse's
    projection, clamped from below at eps."""
    return (M @ inv.T).clamp_min(eps)


def peak_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over an item's bins, relative to the item's
    peak |want|, largest over items ((B, ...) tensors)."""
    B = want.shape[0]
    err = (got - want).abs().reshape(B, -1).amax(dim=1)
    return float((err / want.abs().reshape(B, -1).amax(dim=1)).max())
