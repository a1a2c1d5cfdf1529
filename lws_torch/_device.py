"""Device and dtype resolution shared by the entry points.

Entry points run on CUDA unless the caller names another device. Without
CUDA they raise instead of quietly running on the CPU: a caller who wants
the plain PyTorch path on the CPU asks for it with `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lws_torch: CUDA is not available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def real_dtype(dtype) -> torch.dtype:
    """Working real dtype from a torch or numpy dtype (None -> float32;
    complex128 -> float64; complex64 -> float32)."""
    if dtype is None:
        return torch.float32
    if not isinstance(dtype, torch.dtype):
        dtype = _NUMPY_TO_TORCH[np.dtype(dtype)]
    dtype = {torch.complex128: torch.float64,
             torch.complex64: torch.float32}.get(dtype, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"lws_torch: unsupported dtype {dtype}")
    return dtype
