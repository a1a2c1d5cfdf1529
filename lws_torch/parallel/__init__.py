"""Multi-card execution of lws_torch on torch.distributed: meshes of ranks,
data parallelism, time-sharded sweeps (the sweep kernel K1 on each shard)
and the multi-process helpers. Counterpart of lws_tpu.parallel; every rank
is one process (see sharding.py for the SPMD contract)."""
from .multihost import init_distributed, make_host_mesh, scaling_report
from .sharding import data_parallel_run, make_mesh, shard_pair, sharded_lws_sweeps

__all__ = [
    "make_mesh",
    "shard_pair",
    "sharded_lws_sweeps",
    "data_parallel_run",
    "init_distributed",
    "make_host_mesh",
    "scaling_report",
]
