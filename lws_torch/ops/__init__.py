"""Hand-written CUDA kernels for Hopper and their wrappers.

`lws_sweeps` wraps csrc/lws_sweeps.cu, the counterpart of the TPU kernel
lws_tpu.ops.pallas_packed.tiled_lws_sweeps. The CUDA source is compiled
only when a CUDA tensor first reaches the wrapper, never at import.
"""
from .lws_sweeps import MAX_Q, sweep_schedule, tiled_lws_sweeps

__all__ = ["tiled_lws_sweeps", "sweep_schedule", "MAX_Q"]
