"""Multi-process execution on torch.distributed: initialisation,
host-aware meshes, and a scaling harness.

Counterpart of lws_tpu/parallel/multihost.py. LWS's only traffic between
cards is none at all for data-parallel batches, and for time-sharded sweeps
the (Q-1)-frame halos per exchange (3 x 2049 x 8 B ~ 49 KB per boundary
for the 4096-point long-form configuration) plus one all-reduce of the
per-item mean at entry. `make_host_mesh` keeps time neighbours on one host
(NVLink), so only one boundary pair between consecutive hosts crosses the
network, and lays 'data' across hosts (no traffic).

Launch, one process per card (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT):

    torchrun --nproc-per-node 4 script.py
    # in script.py, on every rank
    import lws_torch, lws_torch.parallel as par
    par.init_distributed()                 # NCCL on CUDA, gloo on the CPU
    mesh = par.make_host_mesh(data=1, time=4)
    out = lws_torch.LWS(4096, 1024).batch_lws(abs_X, mesh=mesh)   # whole result on every rank

NCCL refuses two ranks on one card. Ranks that share a card run gloo
(`init_distributed(backend="gloo")`), which stages the halos through host
memory (sharding.py); their times are no measure of scaling.

Without torchrun, `spawn_ranks(n, device, fn, ...)` starts n ranks from
the calling process (torch.multiprocessing, a file store in a temporary
directory) and returns rank 0's result: the multi-card example and
`lws_torch.entry.dryrun_multichip` run that way when no process group
exists.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time as _time

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from .sharding import make_mesh, shard_pair, sharded_lws_sweeps

__all__ = ["init_distributed", "make_host_mesh", "mesh_shape", "scaling_report", "spawn_ranks"]

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
# seconds that bound every collective of spawn_ranks' process group
_SPAWN_TIMEOUT_S = 600.0


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout: float | None = None) -> bool:
    """Initialise the default process group (idempotent); True when more
    than one process takes part.

    With nothing configured (every argument None and none of torchrun's
    MASTER_ADDR / WORLD_SIZE / RANK in the environment) it is a no-op that
    returns False. `coordinator_address` is an init_method URL
    ("tcp://host:port", "file:///path") or "host:port"; without it the
    environment's MASTER_ADDR / MASTER_PORT are read ("env://").
    `num_processes` and `process_id` default to WORLD_SIZE and RANK.
    `backend` defaults to "nccl" with CUDA and "gloo" without. With CUDA
    the rank takes card (local rank) modulo the card count: the local rank
    and the ranks on this host are torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE where both are set, else counted from every rank's
    host name (an all-gather over a gloo group, after the default group is
    up). With NCCL, more ranks on this host than cards raises (the group is
    torn down first): pass backend="gloo" for ranks that share a card.
    `timeout` (seconds) bounds every collective.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if (coordinator_address is None and num_processes is None and process_id is None
            and not any(k in env for k in _ENV)):
        return False
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None else int(num_processes)
    rank = int(env.get("RANK", 0)) if process_id is None else int(process_id)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    kw = {} if timeout is None else dict(timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kw)
    if cuda:  # NCCL's communicators are made at the first collective, after set_device
        cards = torch.cuda.device_count()
        if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
            local_rank, local = int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
        else:
            hosts = _host_names(backend)
            local_rank, local = hosts[:rank].count(hosts[rank]), hosts.count(hosts[rank])
        if backend == "nccl" and local > cards:
            dist.destroy_process_group()
            raise ValueError(
                f"lws_torch: {local} ranks on this host share {cards} CUDA card(s); NCCL "
                "refuses two ranks on one card: pass backend='gloo'")
        torch.cuda.set_device(local_rank % cards)
    return world > 1


def _host_names(backend):
    """Every rank's host name, by rank, gathered over the default group
    (gloo) or a gloo group made for it (an NCCL all-gather would need each
    rank's card before the card is known)."""
    group = None if backend == "gloo" else dist.new_group(backend="gloo")
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    if group is not None:
        dist.destroy_process_group(group)
    return hosts


def _host_major(hosts, n):
    """The first n ranks ordered host-major: by the first rank of each one's
    host, then by rank."""
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    return sorted(range(n), key=lambda r: (first[hosts[r]], r))


def _gather_objects(obj):
    """obj from every rank of the default group, by rank ([obj] without one)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def make_host_mesh(data: int = 1, time: int = 1, device=None):
    """('data', 'time') mesh over the first data*time ranks, host-major:
    ranks are ordered by their host (the order hosts first appear among the
    ranks), then by rank, and laid out in C order, so time neighbours (the
    halo partners) share a host wherever the time axis fits in one, with one
    crossing between consecutive hosts; 'data' spans hosts freely.
    torchrun numbers ranks host-major already, and then the order is the
    ranks'. Every rank of the default group calls it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = int(data) * int(time)
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    hosts = _gather_objects(socket.gethostname())
    return make_mesh(data, time, ranks=_host_major(hosts, n), device=device)


def ranks_per_card(device) -> int:
    """The most ranks of the default group that share one CUDA card (0 for
    a device that is not CUDA). Every rank of the default group calls it."""
    dev = torch.device(device)
    key = None
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        card = getattr(torch.cuda.get_device_properties(idx), "uuid", idx)
        key = f"{socket.gethostname()}/{card}"
    keys = _gather_objects(key)
    return max((keys.count(k) for k in keys if k is not None), default=0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_report(proc, T_frames: int = 2048, iters: int = 20,
                   time_shards: int | None = None, kernel: str = "xla", n_rep: int = 3):
    """Time-sharded scaling on the ranks of the default group.

    Runs `iters` sweeps of a (T, F) random-magnitude spectrogram (T =
    T_frames rounded down to a multiple of the shards) unsharded on rank 0
    and time-sharded over the first `time_shards` ranks (default: all), and
    reports the median walls of `n_rep` runs after a warm-up (the sharded
    wall is the slowest rank's) and efficiency = t_1 / (t_N * N). Every
    rank of the default group calls it and gets the same dict, with
    lws_tpu's fields. `estimate_only` is True unless each rank has a CUDA
    card of its own: on the CPU, or with ranks sharing one card, the
    figures are no measure of scaling.
    """
    from ..core.stencil import split
    from ..windows import get_thresholds

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = int(time_shards or world)
    dev = proc.device
    F = proc.fftsize // 2 + 1
    T = (T_frames // n) * n
    rng = np.random.default_rng(0)
    A = np.abs(rng.standard_normal((T, F)))
    pair = split(A + 0j, dtype=proc.rdtype, device="cpu")
    thr = torch.as_tensor(get_thresholds(iters, 100, 0.1, 1), dtype=proc.rdtype)

    def best_wall(mesh):
        member = mesh.coord is not None
        p = shard_pair(pair, mesh, time_sharded=True) if member else None
        walls = []
        for _ in range(n_rep + 1):  # the first run warms up
            if dist.is_initialized():
                dist.barrier()
            t0 = _time.perf_counter()
            if member:
                out = sharded_lws_sweeps(*p, st=proc._st_batch, thresholds=thr.to(dev),
                                         mesh=mesh, kernel=kernel,
                                         inner_passes=proc.batch_inner_passes,
                                         inner_scheme=proc.inner_scheme)
                _sync(out[0].device)
            walls.append(_time.perf_counter() - t0)
        return max(_gather_objects(float(np.median(walls[1:])) if member else 0.0))

    t1 = best_wall(make_mesh(1, 1, device=dev))
    tN = best_wall(make_host_mesh(1, n, device=dev))
    shared = ranks_per_card(dev)
    return {
        "T": T, "F": F, "iters": iters, "shards": n, "kernel": kernel,
        "platform": dev.type,
        "wall_1dev_s": round(t1, 4), "wall_Ndev_s": round(tN, 4),
        "speedup": round(t1 / tN, 3) if tN else None,
        "efficiency": round(t1 / (tN * n), 3) if tN > 0 else float("nan"),
        "estimate_only": dev.type != "cuda" or shared > 1,
    }


def mesh_shape(n: int) -> tuple[int, int]:
    """lws_tpu's (data, time) split of n ranks for its dry run and its
    multi-card example: (2, n // 2) for an even n >= 4, else (1, n)."""
    return (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)


def spawn_ranks(n: int, device, fn, *args):
    """Run fn(rank_device, *args) on n ranks spawned from this process, and
    return rank 0's return value.

    The ranks are torch.multiprocessing processes (start method "spawn")
    that join one default group through a file store in a temporary
    directory (`init_distributed`): NCCL when each rank has a CUDA card of
    its own, gloo when the ranks outnumber the cards or `device` is not CUDA
    (NCCL refuses two ranks on one card). A CUDA rank's device is its own
    card, or the one card the ranks share. Each rank takes at most this
    process's torch threads and cores / n. `fn` must be picklable (a
    module-level function); _SPAWN_TIMEOUT_S bounds every collective. A
    rank's exception is raised here, with its traceback, and the other ranks
    are stopped.
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    backend = "nccl" if cuda and n <= torch.cuda.device_count() else "gloo"
    with tempfile.TemporaryDirectory() as root:
        torch.multiprocessing.start_processes(
            _spawned_rank, args=(n, backend, root, "cuda" if cuda else str(dev), fn, args,
                                 torch.get_num_threads()),
            nprocs=n, join=True, start_method="spawn")
        return torch.load(os.path.join(root, "rank0.pt"), weights_only=False)


def _spawned_rank(rank, n, backend, root, device, fn, args, threads):
    """One rank of spawn_ranks: join, run fn, write rank 0's result."""
    torch.set_num_threads(max(1, min(threads, (os.cpu_count() or 1) // n)))
    init_distributed(coordinator_address=f"file://{root}/store", num_processes=n,
                     process_id=rank, backend=backend, timeout=_SPAWN_TIMEOUT_S)
    try:
        out = fn(torch.device(device), *args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(out, os.path.join(root, "rank0.pt"))
