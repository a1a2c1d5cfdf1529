"""Minimal WAV audio IO on the standard library's `wave` module.

The port's own copy of lws_tpu/io.py (which it cannot import: importing
lws_tpu imports jax): the Python equivalents of MATLAB's audioread /
audiowrite that the reference's demo uses (matlab/run_lws.m:59, 92-99).
Reads 8-, 16-, 24- and 32-bit PCM; writes 16-bit PCM. Multi-channel files
are averaged to mono on read (mono=False keeps channels as a leading axis).
read_wav returns host numpy arrays; write_wav also takes a tensor on any
device.
"""
from __future__ import annotations

import wave

import numpy as np
import torch

__all__ = ["read_wav", "write_wav"]


def read_wav(path, mono: bool = True):
    """Returns (samples, sample_rate); samples float64 in [-1, 1]."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        raw = f.readframes(n)
        nch = f.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif width == 3:
        # 24-bit PCM: widen each little-endian triplet to int32 (<< 8 keeps
        # the sign), then scale by 2^31
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.uint32)
               | (b[:, 1].astype(np.uint32) << 8)
               | (b[:, 2].astype(np.uint32) << 16)) << 8
        data = i32.astype(np.int32).astype(np.float64) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    if nch > 1:
        data = data.reshape(-1, nch)
        data = data.mean(axis=1) if mono else data.T
    return data, sr


def write_wav(path, x, sample_rate: int, normalize: bool = True):
    """Write mono (n,) or multi-channel (C, n) float audio as 16-bit PCM."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x.T  # (n, C) interleaved
    if normalize:
        peak = np.abs(x).max()
        if peak > 0:
            x = x / peak * 0.9
    x = np.clip(x, -1.0, 1.0)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1 if x.ndim == 1 else x.shape[1])
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes((x * 32767.0).astype("<i2").tobytes())
