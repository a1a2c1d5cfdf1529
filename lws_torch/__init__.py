"""lws_torch: spectrogram phase recovery via Local Weighted Sums, in PyTorch.

The PyTorch / CUDA port of lws_tpu, for NVIDIA Hopper. It exports what
lws_tpu exports on one card: the `LWS` processor's no-future, online
(RTISI-LA) and batch stages and its 3-stage `run_lws` (mode="music"), the
sweep orders "gs", "jacobi" and "jacobi_mxu" (`order=`, `precision=`), long
inputs (time segmentation, macro chunking, blocked STFT / iSTFT /
consistency), streaming serving (`StreamingLWS`, `StreamStats`), the free
functions `extspec` / `batch_lws` / `nofuture_lws` / `online_lws`, the STFT
/ iSTFT / consistency functions, the mel front end (`mel_filterbank`,
`linear_to_mel`, `mel_to_linear`, `mel_vocoder_pipeline`), resumable
checkpointed stages (`resumable_lws`, `save_checkpoint`, `load_checkpoint`),
wav io (`read_wav`, `write_wav`), run metrics and tracing
(`lws_torch.utils`), the host-side window and weight construction, the
plain PyTorch sweeps and online loops, and the kernel entry points
`segmented_lws_sweeps`, `packed_lws_sweeps` and `packed_supported`. For
CUDA float32 data the Gauss-Seidel sweep, the grouped sweep, the online
stage and the stream's chunked online step run in hand-written CUDA
kernels (lws_torch/csrc/lws_sweeps.cu, lws_torch/csrc/lws_online.cu);
they have no backward, so gradients need backend="torch" (the plain
versions, which autograd differentiates).

Multi-card execution (lws_tpu.parallel's meshes, data parallelism and
time-sharded sweeps, `batch_lws(mesh=)`) is `lws_torch.parallel`, on
torch.distributed. Entry points run on CUDA unless the caller passes
device="cpu". lws_torch imports neither jax nor lws_tpu.
"""
from __future__ import annotations

from .checkpoint import load_checkpoint, resumable_lws, save_checkpoint
from .convert import stencil_from_numpy, stream_state_from_numpy
from .core.batch import lws_sweeps, packed_sweeps
from .core.online import ChunkState, online_chunk, online_chunk_init, rtisi_la
from .core.stencil import Stencil, make_stencil, merge, split
from .functional import batch_lws, extspec, nofuture_lws, online_lws
from .io import read_wav, write_wav
from .mel import linear_to_mel, mel_filterbank, mel_to_linear, mel_vocoder_pipeline
from .ops import packed_lws_sweeps, packed_supported, segmented_lws_sweeps
from .processor import LWS, lws
from .streaming import StreamingLWS, StreamStats
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
    "split", "merge", "stencil_from_numpy", "rtisi_la", "extspec", "batch_lws",
    "nofuture_lws", "online_lws", "StreamingLWS", "StreamStats", "ChunkState",
    "online_chunk", "online_chunk_init", "stream_state_from_numpy", "packed_sweeps",
    "packed_lws_sweeps", "packed_supported", "segmented_lws_sweeps",
    "mel_filterbank", "linear_to_mel", "mel_to_linear", "mel_vocoder_pipeline",
    "read_wav", "write_wav", "resumable_lws", "save_checkpoint", "load_checkpoint",
]
