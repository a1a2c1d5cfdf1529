"""Batched STFT / iSTFT / consistency metric on torch.fft.

Counterpart of lws_tpu/stft.py (reference: python/lws.pyx:43-144). Signals
of any leading batch shape are framed with `unfold` (a strided view, no
index tensor), transformed with one batched rfft / irfft, and overlap-added
as K shifted column sums in the same order as the JAX package. Frame-count
and padding arithmetic is the reference's, including the `perfectrec`
padding that puts the signal start on a frame boundary.

The `_ri` functions take and return split (sr, si) real tensors on the
input's device. The complex-array functions keep the reference signatures
at the numpy boundary: numpy in, numpy out, computed on `device` (CUDA
unless the caller passes device="cpu").

Not in this slice (ROADMAP A8): the bounded-memory blocked paths. Inputs
past the one-shot limits below raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from ._device import resolve_device
from .windows import synthwin

__all__ = ["stft", "istft", "get_consistency", "stft_ri", "istft_ri",
           "get_consistency_ri", "frame_signal", "overlap_add"]

# One-shot limits of lws_tpu's stft/istft (frames) and consistency metric;
# past them the JAX package switches to blocked paths, which are ROADMAP A8.
LONGFORM_BLOCK = 131072
CONSISTENCY_BLOCK = 16384


def _not_ported(what: str, M: int, limit: int):
    raise NotImplementedError(
        f"lws_torch: {what} of {M} frames exceeds the one-shot limit of "
        f"{limit}; the blocked long-form paths are ROADMAP A8")


def _stft_layout(n_samples: int, fsize: int, fshift: int, perfectrec: bool):
    """Static padding/frame-count arithmetic (mirrors python/lws.pyx:54-77)."""
    if perfectrec:
        residual = fsize % fshift
        pre = fsize - fshift if residual == 0 else fsize - residual
        post = 0 if n_samples % fshift == 0 else fshift - n_samples % fshift
        padded = pre + n_samples + post
        M = padded // fshift
    else:
        pre = 0
        rem = (n_samples - fsize) % fshift
        post = 0 if rem == 0 else fshift - rem
        padded = n_samples + post
        M = (padded - fsize) // fshift + 1
    tail = (M - 1) * fshift + fsize - padded
    return pre, post + tail, M


def frame_signal(x: torch.Tensor, fsize: int, fshift: int, M: int) -> torch.Tensor:
    """(..., n) -> (..., M, fsize) frames at starts m*fshift (zero past n)."""
    need = (M - 1) * fshift + fsize
    if need > x.shape[-1]:
        x = tnf.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, fsize, fshift)


def overlap_add(frames: torch.Tensor, fshift: int) -> torch.Tensor:
    """(..., M, fsize) -> (..., (M+K)*fshift): K shifted column sums, in the
    order of lws_tpu.stft.overlap_add. The signal occupies the first
    fshift*(M-1) + fsize samples; the rest is zero slack."""
    M, fsize = frames.shape[-2], frames.shape[-1]
    K = -(-fsize // fshift)
    lead = frames.shape[:-2]
    fpad = tnf.pad(frames, (0, K * fshift - fsize))
    signal = torch.zeros(lead + ((M + K) * fshift,), dtype=frames.dtype,
                         device=frames.device)
    for k in range(K):
        seg = fpad[..., :, k * fshift:(k + 1) * fshift].reshape(lead + (M * fshift,))
        signal[..., k * fshift:(k + M) * fshift] += seg
    return signal


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _stft(x, awin_t, fsize, fshift, fftsize, perfectrec):
    pre, post, M = _stft_layout(x.shape[-1], fsize, fshift, perfectrec)
    x = tnf.pad(x, (pre, post))
    frames = frame_signal(x, fsize, fshift, M) * awin_t
    spec = torch.fft.rfft(frames, n=fftsize, dim=-1)
    return spec.real.contiguous(), spec.imag.contiguous()


def stft_ri(x, fsize, fshift, awin, fftsize=None, perfectrec=False,
            framepadding=False, device=None):
    """Batched STFT: (..., n) real -> split pair of (..., M, fftsize//2+1).

    `x` is a tensor (computed on its device, or on `device` when given) or
    an array (moved to `device`, CUDA by default). `framepadding=True`
    zero-pads (Q-1)*fshift samples on both sides before framing
    (matlab/stft.m:43-46)."""
    if fftsize is None:
        fftsize = fsize
    if fftsize % 2 == 1:
        raise ValueError("Odd ffts not supported.")
    fsize, fshift, fftsize = int(fsize), int(fshift), int(fftsize)
    x = _as_tensor(x, device)
    if framepadding:
        Q = -(-fsize // fshift)
        x = tnf.pad(x, ((Q - 1) * fshift, (Q - 1) * fshift))
    _, _, M = _stft_layout(x.shape[-1], fsize, fshift, bool(perfectrec))
    if M > LONGFORM_BLOCK:
        _not_ported("stft", M, LONGFORM_BLOCK)
    awin_t = torch.as_tensor(np.asarray(awin)).to(x.device, x.dtype)
    return _stft(x, awin_t, fsize, fshift, fftsize, bool(perfectrec))


def stft(x, fsize, fshift, awin, fftsize=None, perfectrec=False,
         framepadding=False, device=None) -> np.ndarray:
    """Batched STFT returning a host complex array (reference signature,
    python/lws.pyx:43-90; framepadding from matlab/stft.m:43-46)."""
    sr, si = stft_ri(x, fsize, fshift, awin, fftsize, perfectrec,
                     framepadding, device)
    return torch.complex(sr, si).cpu().numpy()


def _istft(sr, si, swin_t, fshift, fftsize, perfectrec):
    M, Nreal = sr.shape[-2], sr.shape[-1]
    fsize = 2 * (Nreal - 1)
    spec = torch.complex(sr, si)
    # rank 2 before the irfft, as lws_tpu's _istft_jit does (its TPU
    # backend corrupted batched rank>=3 irfft past 16384 frames)
    flat = spec.reshape(-1, Nreal)
    frames = torch.fft.irfft(flat, n=fftsize, dim=-1)
    frames = frames.reshape(spec.shape[:-1] + (fftsize,))[..., :fsize]
    frames = frames * swin_t[:fsize]
    T = fshift * (M - 1) + fsize
    signal = overlap_add(frames, fshift)[..., :T]
    if perfectrec:
        residual = fsize % fshift
        pre = fsize - fshift if residual == 0 else fsize - residual
        signal = signal[..., pre:(fshift - fsize)]
    return signal


def _prep_swin(swin, awin, fshift, fftsize):
    if awin is not None:
        # re-normalise for perfect reconstruction (python/lws.pyx:105-108)
        swin = synthwin(np.asarray(awin), fshift, swin=np.asarray(swin))
    swin = np.asarray(swin)
    if fftsize > len(swin):
        swin = np.concatenate([swin, np.zeros(fftsize - len(swin))])
    return swin


def istft_ri(sr, si, fshift, swin, awin=None, fftsize=None, perfectrec=False,
             device=None):
    """Batched iSTFT from a split pair -> (..., n_samples) real tensor."""
    sr = _as_tensor(sr, device)
    si = _as_tensor(si, sr.device)
    Nreal = sr.shape[-1]
    if Nreal % 2 != 1:
        raise ValueError("Expected only non-negative frequencies in the spectrogram.")
    fsize = 2 * (Nreal - 1)
    if fftsize is None:
        fftsize = fsize
    if sr.shape[-2] > LONGFORM_BLOCK:
        _not_ported("istft", sr.shape[-2], LONGFORM_BLOCK)
    swin = _prep_swin(swin, awin, fshift, fftsize)
    swin_t = torch.as_tensor(swin).to(sr.device, sr.dtype)
    return _istft(sr, si, swin_t, int(fshift), int(fftsize), bool(perfectrec))


def istft(spec, fshift, swin, awin=None, fftsize=None, perfectrec=False,
          device=None) -> np.ndarray:
    """Batched iSTFT from a host complex array (reference signature,
    python/lws.pyx:93-137)."""
    spec = np.asarray(spec)
    y = istft_ri(spec.real.copy(), spec.imag.copy(), fshift, swin, awin,
                 fftsize, perfectrec, device)
    return y.cpu().numpy()


def get_consistency_ri(sr, si, fsize, fshift, awin, swin, fftsize=None,
                       perfectrec=False, device=None):
    """Consistency 20*log10(||S|| / ||STFT(iSTFT(S)) - S||) dB from a split
    pair: one value per leading batch element (python/lws.pyx:140-144)."""
    sr = _as_tensor(sr, device)
    si = _as_tensor(si, sr.device)
    if fftsize is None:
        fftsize = 2 * (sr.shape[-1] - 1)
    if sr.shape[-2] > CONSISTENCY_BLOCK:
        _not_ported("consistency", sr.shape[-2], CONSISTENCY_BLOCK)
    swin_t = torch.as_tensor(_prep_swin(swin, None, fshift, fftsize)).to(sr.device, sr.dtype)
    awin_t = torch.as_tensor(np.asarray(awin)).to(sr.device, sr.dtype)
    x = _istft(sr, si, swin_t, int(fshift), int(fftsize), bool(perfectrec))
    br, bi = _stft(x, awin_t, int(fsize), int(fshift), int(fftsize), bool(perfectrec))
    dr, di = br - sr, bi - si
    num = torch.sum(sr * sr + si * si, dim=(-2, -1))
    den = torch.sum(dr * dr + di * di, dim=(-2, -1))
    return 10.0 * (torch.log10(num) - torch.log10(den))


def get_consistency(S, fsize, fshift, awin, swin, fftsize=None,
                    perfectrec=False, device=None) -> np.ndarray:
    """Consistency metric from a host complex array (reference signature)."""
    S = np.asarray(S)
    c = get_consistency_ri(S.real.copy(), S.imag.copy(), fsize, fshift, awin,
                           swin, fftsize, perfectrec, device)
    return c.cpu().numpy()
