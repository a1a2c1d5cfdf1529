"""Multi-card execution on torch.distributed: meshes of ranks, data
parallelism, time-axis sharding.

Counterpart of lws_tpu/parallel/sharding.py. lws_tpu is one controller that
passes global arrays a `Mesh` shards, with `shard_map` + `ppermute` + `psum`
inside one process; here every rank is a process (SPMD), so the functions
take and return this rank's block, and only `shard_pair` and
`LWS.batch_lws(mesh=)` see the global spectrogram. Two axes, as lws_tpu's:

  - 'data': independent utterances (the lead batch dimension). LWS has no
    traffic between items.
  - 'time': long spectrograms split along frames for the batch / no-future
    sweeps. The stencil reads +-(Q-1) frames, so each exchange hands the
    (Q-1)-frame halos to the time neighbours point to point; the per-item
    mean magnitude that scales the thresholds (python/lws.pyx:240-245) is
    one all-reduce over 'time'. The +-L frequency halo is local index math;
    F is never split.

Gauss-Seidel runs within each shard; across shard boundaries information
moves one exchange at a time (block-Jacobi between shards). The end shards
keep the frozen stage-entry edge replicas as their outer halos
(lwslib.cpp:21-25); interior boundaries receive the neighbour's live Q-1
frames. The online (RTISI-LA) stage is sequential along time and is only
ever data-parallel.

Transport: each exchange is one `dist.batch_isend_irecv` of the stacked
(real, imag) halo rows per neighbour, so neither ordering nor the end
shards' single neighbour can deadlock. NCCL moves CUDA tensors directly.
Gloo's point-to-point ops take CPU tensors only, so when the time group's
backend is not NCCL and the shard lives on CUDA, the (2, ..., Q-1, F) halo
rows are copied to the host and back (ranks that share one card must use
gloo: NCCL refuses two ranks on one GPU). The sweeps stay on the card; the
all-reduce and all-gather take CUDA tensors on both backends.

The mesh is a small class of the port's own (`Mesh`), not DeviceMesh: it
holds the (data, time) array of global ranks, this rank's coordinates and
device, and one process group per axis line (`dist.new_group`), which
every rank of the default group creates in the same order. Groups are
cached by their ranks for the life of the default group, so meshes built
again (a server's requests, `scaling_report`) reuse them. Without an
initialised default group a mesh of one rank needs no group: communication
over an axis of size 1 is skipped.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..core.batch import ORDERS, lws_sweeps
from ..ops import lws_sweeps as _k1

__all__ = ["Mesh", "make_mesh", "shard_pair", "sharded_lws_sweeps", "data_parallel_run",
           "gather_pair"]

_TPU_KNOBS = dict(pack=1, storage=None, frame_unroll=1, window_carry="stack",
                  tap_chunks=1, interpret=False)

# the default group the cached line groups belong to, and those groups by ranks
_WORLD = None
_GROUPS: dict = {}


def _line_group(line):
    """The process group of `line`'s ranks, made once per default group
    (collective: every rank of the default group asks for every line, in
    one order, so every rank's cache holds the same lines)."""
    global _WORLD
    if _WORLD is not dist.group.WORLD:  # a new default group: the old groups died with it
        _WORLD = dist.group.WORLD
        _GROUPS.clear()
    key = tuple(int(r) for r in line)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


class Mesh:
    """A ('data', 'time') mesh of ranks of the default process group.

    `ranks` is the (data, time) array of global ranks, `shape` maps each
    axis name to its size (as a jax Mesh's), `device` is this rank's
    device, `coord` this rank's (data, time) coordinates (None when the
    rank is not in the mesh) and `groups` its process group along each axis
    (the ranks of its mesh row for 'time', of its column for 'data'; none
    without an initialised default group).
    """

    axis_names = ("data", "time")

    def __init__(self, ranks, device):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device = device
        rank = dist.get_rank() if dist.is_initialized() else 0
        hit = np.argwhere(self.ranks == rank)
        self.coord = tuple(int(v) for v in hit[0]) if len(hit) else None
        self.groups = {}
        if dist.is_initialized():
            # new_group is collective over the default group: every rank
            # asks for every line's group, in one order, and keeps its own
            for axis, lines in (("time", self.ranks), ("data", self.ranks.T)):
                for line in lines:
                    group = _line_group(line)
                    if rank in line:
                        self.groups[axis] = group

    def line(self, axis: str) -> np.ndarray:
        """Global ranks of this rank's line along `axis`, by coordinate."""
        i, j = self.coord
        return self.ranks[i] if axis == "time" else self.ranks[:, j]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, time={self.shape['time']}, "
                f"ranks={self.ranks.tolist()})")


def make_mesh(data: int = 1, time: int = 1, ranks=None, device=None) -> Mesh:
    """A ('data', 'time') mesh over the first data*time of `ranks` (default:
    every rank of the initialised default group, in order; one rank, 0,
    without one), laid out in C order: time neighbours are consecutive
    ranks. Every rank of the default group calls it (the axis groups are
    created collectively). `device` is this rank's device: CUDA (the
    current card) unless the caller names another."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = [int(r) for r in ranks]
    n = int(data) * int(time)
    if len(ranks) < n:
        raise ValueError(f"need {n} ranks, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:n]).reshape(int(data), int(time)), resolve_device(device))


def _member(mesh: Mesh):
    if mesh.coord is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        raise ValueError(f"lws_torch: rank {rank} is not in {mesh!r}")
    return mesh.coord


def _block(x: torch.Tensor, dim: int, k: int, n: int, what: str) -> torch.Tensor:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what}={size} not divisible by {'time' if what == 'T' else 'data'}={n}")
    step = size // n
    return x.narrow(dim, k * step, step)


def shard_pair(pair, mesh: Mesh, time_sharded: bool = False):
    """This rank's block of a global (sr, si) pair of (..., T, F) arrays
    (numpy or tensors), on the mesh's device.

    The lead batch dimension is split over 'data' when the arrays have more
    than two dimensions, the time axis over 'time' when `time_sharded`;
    frequency is never split. Raises when a split dimension does not divide.
    """
    i, j = _member(mesh)
    out = []
    for x in pair:
        x = torch.as_tensor(x)
        if x.ndim > 2:
            x = _block(x, 0, i, mesh.shape["data"], "B")
        if time_sharded:
            x = _block(x, -2, j, mesh.shape["time"], "T")
        out.append(x.to(mesh.device).contiguous())
    return tuple(out)


def data_parallel_run(fn, pair, mesh: Mesh):
    """Run any (sr, si) -> (sr, si) stage on this rank's block of the batch
    (the lead dimension split over 'data'); returns this rank's result."""
    return fn(*shard_pair(pair, mesh))


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of x along `axis`, concatenated along `dim` in mesh order."""
    if mesh.shape[axis] == 1:
        return x
    group = mesh.groups[axis]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=group)
    # all_gather lists by group rank; the mesh's line may be in another order
    by_rank = {dist.get_global_rank(group, k): p for k, p in enumerate(parts)}
    return torch.cat([by_rank[int(r)] for r in mesh.line(axis)], dim=dim)


def gather_pair(pair, mesh: Mesh, time_sharded: bool = True):
    """The inverse of shard_pair: the whole (sr, si) from every rank's
    block, on every rank (all-gathers over 'time' when `time_sharded`, then
    over 'data' for arrays of more than two dimensions)."""
    _member(mesh)
    out = []
    for x in pair:
        if time_sharded:
            x = _all_gather(x, mesh, "time", x.ndim - 2)
        if x.ndim > 2:
            x = _all_gather(x, mesh, "data", 0)
        out.append(x)
    return tuple(out)


def _global_mean(sr: torch.Tensor, si: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per item, the mean magnitude of the whole time axis: the sum of |S|
    over the local shard, all-reduced (SUM) over 'time', over T_total x F.
    Shape (...,): (B,) for 3-D shards, a scalar for 2-D."""
    total = torch.sqrt(sr * sr + si * si).sum(dim=(-2, -1))
    if mesh.shape["time"] > 1:
        dist.all_reduce(total, group=mesh.groups["time"])
    return total / (sr.shape[-2] * mesh.shape["time"] * sr.shape[-1])


def _exchange(cr, ci, frozen, mesh: Mesh, Q1: int):
    """(top_r, top_i, bot_r, bot_i) halos of this rank's shard: the time
    neighbours' current edge frames (Q-1 each) where a neighbour exists,
    the frozen stage-entry replicas at the ends of the time axis."""
    j, n = mesh.coord[1], mesh.shape["time"]
    T = cr.shape[-2]
    got, ops = {}, []
    if n > 1:
        group = mesh.groups["time"]
        stage = cr.is_cuda and dist.get_backend(group) != dist.Backend.NCCL
        line = mesh.line("time")
        for side, peer_j, rows in (("top", j - 1, slice(0, Q1)), ("bot", j + 1, slice(T - Q1, T))):
            if not 0 <= peer_j < n:
                continue
            send = torch.stack((cr[..., rows, :], ci[..., rows, :]))  # contiguous copy
            if stage:  # gloo: point to point from host memory only
                send = send.cpu()
            recv = torch.empty_like(send)
            peer = int(line[peer_j])
            ops += [dist.P2POp(dist.isend, send, peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
            got[side] = recv
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    top = got["top"].to(cr.device) if "top" in got else frozen[:2]
    bot = got["bot"].to(cr.device) if "bot" in got else frozen[2:]
    return top[0], top[1], bot[0], bot[1]


def sharded_lws_sweeps(
    sr: torch.Tensor,
    si: torch.Tensor,
    st,
    thresholds,
    mesh: Mesh,
    order: str = "gs",
    inner_passes: int = 1,
    kernel: str = "xla",
    sweeps_per_exchange: int = 1,
    inner_scheme: str = "jacobi",
    backend: str = "auto",
    precision=None,
    *,
    pack: int = 1,
    interpret: bool = False,
    storage=None,
    frame_unroll: int = 1,
    window_carry: str = "stack",
    tap_chunks: int = 1,
):
    """Time-sharded batch / no-future sweeps on this rank's shard (..., T_loc,
    F) of a spectrogram split as `shard_pair(..., time_sharded=True)` splits
    it: equal shards of at least Q-1 frames. Every rank of the mesh calls it
    at once; it returns this rank's shard.

    The mean magnitude is taken once, at entry, over the whole time axis
    (an all-reduce over 'time'); the end shards keep their stage-entry edge
    replicas as outer halos throughout. With one time shard (a data-only
    mesh) there is no neighbour and nothing to exchange: all the sweeps run
    as one call of the unsharded sweeps (kernel "tiled": one K1 launch),
    with their own edge replicas and mean, and equal them bit for bit.

    kernel="xla", the portable path, runs the plain PyTorch sweeps of
    `order` ("gs", "jacobi" or "jacobi_mxu", `precision` for the last) one
    sweep at a time with an exchange before every sweep, whatever
    `sweeps_per_exchange` says (lws_tpu's xla path ignores it too).
    kernel="tiled" runs blocks of `sweeps_per_exchange` Gauss-Seidel sweeps
    (the last block the iters % s left over), one exchange before each and
    each block one `tiled_lws_sweeps(halo=, mean_amp=)` call: the sweep
    kernel K1 for CUDA shards (float32 only: other types raise there, as in
    tiled_lws_sweeps), the plain frame loop for CPU shards and with
    backend="torch". The tiled path runs the Gauss-Seidel order whatever
    `order` says, as lws_tpu's does.

    Autograd through the point-to-point exchange is not supported: a tensor
    that requires grad raises. lws_tpu's TPU launch knobs (pack, storage,
    frame_unroll, window_carry, tap_chunks, interpret) raise at any value
    other than their default.
    """
    _k1.reject_tpu_knobs("parallel.sharded_lws_sweeps", _TPU_KNOBS, pack=pack,
                         storage=storage, frame_unroll=frame_unroll,
                         window_carry=window_carry, tap_chunks=tap_chunks, interpret=interpret)
    _k1.refuse_grad("sharded_lws_sweeps", sr, si, thresholds,
                    reason="exchanges halos point to point, which autograd does not "
                           "differentiate; detach the input or run the unsharded sweeps")
    if kernel not in ("xla", "tiled"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if order not in ORDERS:
        raise ValueError(f"unknown sweep order: {order!r}")
    if backend not in ("auto", "torch"):
        raise ValueError(f"lws_torch: backend must be 'auto' or 'torch', got {backend!r}")
    _member(mesh)
    Q1 = st.Q - 1
    if sr.shape[-2] < Q1:
        raise ValueError(f"each time shard needs >= Q-1={Q1} frames")
    thresholds = torch.as_tensor(thresholds, device=sr.device).to(sr.dtype)
    iters = int(thresholds.shape[0])
    if iters == 0:
        return sr, si
    if mesh.shape["time"] == 1:
        if kernel == "tiled":
            return _k1.tiled_lws_sweeps(sr, si, st, thresholds, inner_passes, inner_scheme,
                                        backend=backend)
        return lws_sweeps(sr, si, st, thresholds, order=order, inner_passes=inner_passes,
                          inner_scheme=inner_scheme, precision=precision)
    mean = _global_mean(sr, si, mesh)
    T = sr.shape[-2]
    rep = lambda x, k: x[..., k:k + 1, :].expand(*x.shape[:-2], Q1, x.shape[-1])  # noqa: E731
    frozen = (rep(sr, 0), rep(si, 0), rep(sr, T - 1), rep(si, T - 1))
    s = max(1, int(sweeps_per_exchange)) if kernel == "tiled" else 1
    cr, ci = sr, si
    for a in range(0, iters, s):
        halo = _exchange(cr, ci, frozen, mesh, Q1)
        block = thresholds[a:a + s]
        if kernel == "tiled":
            cr, ci = _k1.tiled_lws_sweeps(cr, ci, st, block, inner_passes, inner_scheme,
                                          halo=halo, mean_amp=mean, backend=backend)
        else:
            cr, ci = lws_sweeps(cr, ci, st, block, order=order, inner_passes=inner_passes,
                                inner_scheme=inner_scheme, halo=halo, mean_amp=mean,
                                precision=precision)
    return cr, ci
