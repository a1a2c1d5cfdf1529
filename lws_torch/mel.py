"""Mel filterbanks and mel -> linear inversion for vocoder back ends.

Counterpart of lws_tpu/mel.py: "mel spectrogram -> linear magnitudes ->
LWS phase recovery -> waveform". The filterbank is built on the host in
numpy float64, as lws_tpu builds it (a copy of its code: the two are equal
bit for bit), and both projections are one batched `torch.matmul` on the
data's device. mel_to_linear's pseudo-inverse is a host float64 SVD, cached
on a sha256 of the filterbank's bytes, and its transpose is cached again on
each device and dtype it is applied in, so steady calls copy nothing from
the host (PINV_BUILDS and PINV_UPLOADS count both).

mel_vocoder_pipeline's two stages run inside `torch.profiler` ranges,
`lws_torch.mel_to_linear` and `lws_torch.run_lws`, which a profiler's trace
shows with the device work each launched.

Tensors stay on their device; numpy input goes to `device` (CUDA unless the
caller names another, as every entry point of the port).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from ._device import resolve_device

__all__ = ["mel_filterbank", "linear_to_mel", "mel_to_linear", "mel_vocoder_pipeline",
           "PINV_BUILDS", "PINV_UPLOADS"]

# pinv builds (host SVDs) and uploads (to a device and dtype) so far; a
# path's run is read as a difference.
PINV_BUILDS = 0
PINV_UPLOADS = 0


def _hz_to_mel(f, htk=False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above
    f_sp = 200.0 / 3
    brk = 1000.0
    mel = f / f_sp
    log_step = np.log(6.4) / 27.0
    above = f >= brk
    mel = np.where(above, brk / f_sp + np.log(np.maximum(f, brk) / brk) / log_step, mel)
    return mel


def _mel_to_hz(m, htk=False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    brk_mel = 1000.0 / f_sp
    log_step = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= brk_mel
    return np.where(above, 1000.0 * np.exp(log_step * (m - brk_mel)), f)


def mel_filterbank(
    n_mels: int,
    fftsize: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, fftsize//2 + 1), host float64."""
    if fmax is None:
        fmax = sample_rate / 2
    n_bins = fftsize // 2 + 1
    fft_freqs = np.arange(n_bins) * sample_rate / fftsize
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)

    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb


def _tensor(x, device) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to `device`."""
    if torch.is_tensor(x):
        return x
    return torch.tensor(np.asarray(x), device=resolve_device(device))


def linear_to_mel(spec_mag, fb, device=None) -> torch.Tensor:
    """(..., T, n_bins) magnitudes -> (..., T, n_mels), in the input's dtype."""
    spec_mag = _tensor(spec_mag, device)
    fb = torch.as_tensor(np.asarray(fb)).to(spec_mag.device, spec_mag.dtype)
    return spec_mag @ fb.T


_PINV_CACHE: dict = {}  # (shape, sha256) -> the host float64 pinv
_PINV_ON_DEVICE: dict = {}  # (shape, sha256, device, dtype) -> its transpose there


def _pinv_t(fb, device, dtype) -> torch.Tensor:
    """The transposed pinv of a filterbank, (n_mels, n_bins), on `device` in
    `dtype`: built once per filterbank (host SVD, float64, keyed on a
    sha256 of its bytes: Python's hash() can collide for two filterbanks of
    one shape), uploaded once per device and dtype."""
    global PINV_BUILDS, PINV_UPLOADS
    fb64 = np.ascontiguousarray(np.asarray(fb, dtype=np.float64))
    key = (fb64.shape, hashlib.sha256(fb64.tobytes()).digest())
    where = key + (device, dtype)
    there = _PINV_ON_DEVICE.get(where)
    if there is None:
        inv = _PINV_CACHE.get(key)
        if inv is None:
            inv = _PINV_CACHE[key] = np.linalg.pinv(fb64)  # (n_bins, n_mels)
            PINV_BUILDS += 1
        there = _PINV_ON_DEVICE[where] = torch.as_tensor(inv.T).to(device, dtype)
        PINV_UPLOADS += 1
    return there


def mel_to_linear(mel_mag, fb, eps: float = 1e-10, device=None) -> torch.Tensor:
    """Approximate inverse projection: (..., T, n_mels) -> (..., T, n_bins).

    The Moore-Penrose pseudo-inverse of the filterbank with a
    non-negativity clamp at `eps`, the Tacotron-style inversion before phase
    recovery, applied as one batched matmul on the data's device (the pinv
    is kept there, `_pinv_t`).
    """
    mel_mag = _tensor(mel_mag, device)
    proj = mel_mag @ _pinv_t(fb, mel_mag.device, mel_mag.dtype)
    return torch.clamp_min(proj, eps)


def mel_vocoder_pipeline(mel_mag, proc, fb=None, sample_rate=None, return_spec=False):
    """mel magnitudes -> linear magnitudes -> LWS phase recovery -> waveform.

    mel_mag: (..., T, n_mels), a tensor or an array, moved to the
    processor's device; proc: an `LWS` processor whose fftsize matches the
    filterbank (`fb`, or an n_mels-band Slaney filterbank at `sample_rate`).
    Runs `proc.run_lws` from zero phase and returns the (..., n_samples)
    waveform as a tensor, or the recovered (sr, si) pair with
    return_spec=True.
    """
    mel_mag = _tensor(mel_mag, proc.device).to(proc.device)
    if fb is None:
        if sample_rate is None:
            raise ValueError("provide fb or sample_rate")
        fb = mel_filterbank(mel_mag.shape[-1], proc.fftsize, sample_rate)
    with record_function("lws_torch.mel_to_linear"):
        lin = mel_to_linear(mel_mag, fb).to(proc.rdtype)
    with record_function("lws_torch.run_lws"):
        pair = proc.run_lws((lin, torch.zeros_like(lin)))
    if return_spec:
        return pair
    return proc.istft(pair)
