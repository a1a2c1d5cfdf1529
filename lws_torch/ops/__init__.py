"""Hand-written CUDA kernels for Hopper and their wrappers.

`tiled_lws_sweeps` wraps csrc/lws_sweeps.cu, the counterpart of the TPU
kernel lws_tpu.ops.pallas_packed.tiled_lws_sweeps; `packed_rtisi_la` and
`online_chunk` wrap the two kernels of csrc/lws_online.cu, the
counterparts of packed_rtisi_la and online_chunk. The CUDA sources are
compiled only when a CUDA tensor first reaches a wrapper, never at import.
"""
from .lws_sweeps import MAX_Q, sweep_schedule, tiled_lws_sweeps
from .online import MAX_LA, online_chunk, online_chunk_init, online_supported, packed_rtisi_la

__all__ = ["tiled_lws_sweeps", "sweep_schedule", "MAX_Q", "packed_rtisi_la",
           "online_chunk", "online_chunk_init", "online_supported", "MAX_LA"]
