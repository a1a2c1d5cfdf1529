"""lws_torch: spectrogram phase recovery via Local Weighted Sums, in PyTorch.

The PyTorch / CUDA port of lws_tpu, for NVIDIA Hopper. It exports what is
ported so far: the batch and no-future schedules of the `LWS` processor
(the library default `LWS(512, 128)`), the STFT / iSTFT / consistency
functions, the host-side window and weight construction, and the plain
PyTorch sweeps. The Gauss-Seidel sweep runs in a hand-written CUDA kernel
(lws_torch/csrc/lws_sweeps.cu) for CUDA float32 data.

Entry points run on CUDA unless the caller passes device="cpu". lws_torch
imports neither jax nor lws_tpu.
"""
from __future__ import annotations

from .convert import stencil_from_numpy
from .core.batch import lws_sweeps
from .core.stencil import Stencil, make_stencil, merge, split
from .processor import LWS, lws
from .stft import (
    get_consistency,
    get_consistency_ri,
    istft,
    istft_ri,
    stft,
    stft_ri,
)
from .weights import W_PRUNE_THRESHOLD, build_stencil, create_weights
from .windows import (
    build_asymmetric_windows,
    default_window,
    get_thresholds,
    hann,
    overlap_factor,
    synthwin,
)

__version__ = "0.1.0"

__all__ = [
    "LWS", "lws", "hann", "synthwin", "default_window", "build_asymmetric_windows",
    "get_thresholds", "overlap_factor", "create_weights", "build_stencil",
    "W_PRUNE_THRESHOLD", "stft", "istft", "get_consistency", "stft_ri",
    "istft_ri", "get_consistency_ri", "lws_sweeps", "Stencil", "make_stencil",
    "split", "merge", "stencil_from_numpy",
]
