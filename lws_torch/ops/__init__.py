"""Hand-written CUDA kernels for Hopper and their wrappers.

`tiled_lws_sweeps` wraps K1 in csrc/lws_sweeps.cu, the counterpart of the
TPU kernel lws_tpu.ops.pallas_packed.tiled_lws_sweeps (`sweep_plan`: its
launch and shared-memory plan, which decides the geometries it takes), and
`packed_lws_sweeps` the grouped kernel K5 in the same source (the
counterpart of packed_lws_sweeps, and of tiled_lws_sweeps and
segmented_lws_sweeps at micro > 1; `packed_plan`: its launch and
shared-memory plan, `packed_supported`: the geometries it takes).
`segmented_lws_sweeps` (K2) has no kernel of its own: it runs K1 (K5 at
micro > 1) on time segments with halo exchanges between them, as lws_tpu's
does. `packed_rtisi_la` and `online_chunk` wrap the two kernels of
csrc/lws_online.cu, the counterparts of packed_rtisi_la and online_chunk
(`online_plan`: their launch and shared-memory plan). The CUDA sources are
compiled only when a CUDA tensor first reaches a wrapper, never at import.
"""
from .lws_sweeps import MAX_Q, sweep_plan, sweep_schedule, tiled_lws_sweeps
from .online import online_chunk, online_chunk_init, online_plan, online_supported, packed_rtisi_la
from .packed import packed_lws_sweeps, packed_plan, packed_supported
from .segmented import segmented_lws_sweeps

__all__ = ["tiled_lws_sweeps", "sweep_schedule", "sweep_plan", "MAX_Q", "packed_rtisi_la",
           "online_chunk", "online_chunk_init", "online_supported", "online_plan",
           "packed_lws_sweeps", "packed_supported", "packed_plan", "segmented_lws_sweeps"]
