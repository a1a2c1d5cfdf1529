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

Past the one-shot limits below (frames), the functions switch to the
bounded-memory blocked paths as lws_tpu does: frames are independent, so
the STFT analyses chunks of the signal and concatenates them; overlap-add
is linear in the frames, so the iSTFT accumulates chunk-local
overlap-adds, and the consistency metric accumulates its two norms per
frame chunk. Only the float addition order at the chunk seams differs
from the one-shot path.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from ._device import resolve_device
from .windows import synthwin

__all__ = ["stft", "istft", "get_consistency", "stft_ri", "istft_ri",
           "get_consistency_ri", "frame_signal", "overlap_add"]

# lws_tpu's one-shot limits (frames): stft / istft past LONGFORM_BLOCK and
# the consistency metric past CONSISTENCY_BLOCK take the blocked paths, in
# blocks of CONSISTENCY_BLOCK frames. The same limits keep the seams where
# lws_tpu has them.
LONGFORM_BLOCK = 131072
CONSISTENCY_BLOCK = 16384


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
    return _stft_frames(tnf.pad(x, (pre, post)), awin_t, fsize, fshift, M, fftsize)


def _stft_frames(x, awin_t, fsize, fshift, M, fftsize):
    """The M frames of an already padded signal -> split spectrum."""
    frames = frame_signal(x, fsize, fshift, M) * awin_t
    spec = torch.fft.rfft(frames, n=fftsize, dim=-1)
    return spec.real.contiguous(), spec.imag.contiguous()


def _stft_blocked(x, awin_t, fsize, fshift, fftsize, perfectrec,
                  block=CONSISTENCY_BLOCK):
    """Bounded-memory STFT: chunks of the padded signal, each analysed
    alone, concatenated; bit-equal per frame to the one-shot path."""
    pre, post, M = _stft_layout(x.shape[-1], fsize, fshift, perfectrec)
    x = tnf.pad(x, (pre, post))
    parts = [_stft_frames(x[..., m0 * fshift:(m1 - 1) * fshift + fsize], awin_t,
                          fsize, fshift, m1 - m0, fftsize)
             for m0, m1 in _blocks(M, block)]
    return (torch.cat([p[0] for p in parts], dim=-2),
            torch.cat([p[1] for p in parts], dim=-2))


def _blocks(M, block):
    return [(m0, min(M, m0 + block)) for m0 in range(0, M, block)]


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
    awin_t = torch.as_tensor(np.asarray(awin)).to(x.device, x.dtype)
    if M > LONGFORM_BLOCK:
        return _stft_blocked(x, awin_t, fsize, fshift, fftsize, bool(perfectrec))
    return _stft(x, awin_t, fsize, fshift, fftsize, bool(perfectrec))


def stft(x, fsize, fshift, awin, fftsize=None, perfectrec=False,
         framepadding=False, device=None) -> np.ndarray:
    """Batched STFT returning a host complex array (reference signature,
    python/lws.pyx:43-90; framepadding from matlab/stft.m:43-46)."""
    sr, si = stft_ri(x, fsize, fshift, awin, fftsize, perfectrec,
                     framepadding, device)
    return torch.complex(sr, si).cpu().numpy()


def c2r_spectrum(sr, si) -> torch.Tensor:
    """torch.complex(sr, si) with the imaginary parts of the DC and Nyquist
    bins zeroed, as the irfft's input. A real frame cannot hold them:
    numpy's irfft (the library's) and torch's CPU irfft ignore them, cuFFT's
    float32 C2R does not. The pair passed in is left as it is."""
    spec = torch.complex(sr, si)
    spec.imag[..., 0] = 0
    spec.imag[..., -1] = 0
    return spec


def _istft(sr, si, swin_t, fshift, fftsize, perfectrec):
    M, Nreal = sr.shape[-2], sr.shape[-1]
    fsize = 2 * (Nreal - 1)
    spec = c2r_spectrum(sr, si)
    # rank 2 before the irfft, as lws_tpu's _istft_jit does (its TPU
    # backend corrupted batched rank>=3 irfft past 16384 frames)
    flat = spec.reshape(-1, Nreal)
    frames = torch.fft.irfft(flat, n=fftsize, dim=-1)
    frames = frames.reshape(spec.shape[:-1] + (fftsize,))[..., :fsize]
    frames = frames * swin_t[:fsize]
    T = fshift * (M - 1) + fsize
    signal = overlap_add(frames, fshift)[..., :T]
    return _trim(signal, fsize, fshift) if perfectrec else signal


def _trim(signal, fsize, fshift):
    """Drop the perfectrec alignment padding of a synthesised signal."""
    residual = fsize % fshift
    pre = fsize - fshift if residual == 0 else fsize - residual
    return signal[..., pre:(fshift - fsize)]


def _istft_blocked(sr, si, swin_t, fshift, fftsize, perfectrec,
                   block=CONSISTENCY_BLOCK):
    """Bounded-memory iSTFT: each frame chunk's overlap-add is added into
    the signal at its offset (the one-shot sum, up to the addition order at
    the chunk seams)."""
    M, Nreal = sr.shape[-2], sr.shape[-1]
    fsize = 2 * (Nreal - 1)
    y = torch.zeros(sr.shape[:-2] + (fshift * (M - 1) + fsize,), dtype=sr.dtype,
                    device=sr.device)
    for m0, m1 in _blocks(M, block):
        seg = _istft(sr[..., m0:m1, :], si[..., m0:m1, :], swin_t, fshift, fftsize, False)
        y[..., m0 * fshift:m0 * fshift + seg.shape[-1]] += seg
    return _trim(y, fsize, fshift) if perfectrec else y


def _consistency(sr, si, awin_t, swin_t, fsize, fshift, fftsize, perfectrec):
    x = _istft(sr, si, swin_t, fshift, fftsize, perfectrec)
    br, bi = _stft(x, awin_t, fsize, fshift, fftsize, perfectrec)
    dr, di = br - sr, bi - si
    num = torch.sum(sr * sr + si * si, dim=(-2, -1))
    den = torch.sum(dr * dr + di * di, dim=(-2, -1))
    return 10.0 * (torch.log10(num) - torch.log10(den))


def _consistency_blocked(sr, si, awin_t, swin_t, fsize, fshift, fftsize,
                         perfectrec, block=CONSISTENCY_BLOCK):
    """The consistency metric in frame blocks: the blocked iSTFT, then the
    re-analysis and both norms accumulated per frame chunk (the one-shot
    metric up to the addition order at the seams)."""
    M = sr.shape[-2]
    y = _istft_blocked(sr, si, swin_t, fshift, fftsize, perfectrec, block=block)
    pre, post, M2 = _stft_layout(y.shape[-1], fsize, fshift, perfectrec)
    y = tnf.pad(y, (pre, post))
    num = den = 0.0
    for m0, m1 in _blocks(min(M, M2), block):
        ys = y[..., m0 * fshift:(m1 - 1) * fshift + fsize]
        br, bi = _stft_frames(ys, awin_t, fsize, fshift, m1 - m0, fftsize)
        src, sic = sr[..., m0:m1, :], si[..., m0:m1, :]
        dr, di = br - src, bi - sic
        num = num + torch.sum(src * src + sic * sic, dim=(-2, -1))
        den = den + torch.sum(dr * dr + di * di, dim=(-2, -1))
    return 10.0 * (torch.log10(num) - torch.log10(den))


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
    swin = _prep_swin(swin, awin, fshift, fftsize)
    swin_t = torch.as_tensor(swin).to(sr.device, sr.dtype)
    fn = _istft_blocked if sr.shape[-2] > LONGFORM_BLOCK else _istft
    return fn(sr, si, swin_t, int(fshift), int(fftsize), bool(perfectrec))


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
    swin_t = torch.as_tensor(_prep_swin(swin, None, fshift, fftsize)).to(sr.device, sr.dtype)
    awin_t = torch.as_tensor(np.asarray(awin)).to(sr.device, sr.dtype)
    fn = _consistency_blocked if sr.shape[-2] > CONSISTENCY_BLOCK else _consistency
    return fn(sr, si, awin_t, swin_t, int(fsize), int(fshift), int(fftsize), bool(perfectrec))


def get_consistency(S, fsize, fshift, awin, swin, fftsize=None,
                    perfectrec=False, device=None) -> np.ndarray:
    """Consistency metric from a host complex array (reference signature)."""
    S = np.asarray(S)
    c = get_consistency_ri(S.real.copy(), S.imag.copy(), fsize, fshift, awin,
                           swin, fftsize, perfectrec, device)
    return c.cpu().numpy()
