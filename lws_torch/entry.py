"""Ready-made runs of the port, for smoke checks.

Counterpart of the JAX package's `__graft_entry__`:

  - `entry()` returns (fn, example_args), where fn runs the three stages of
    `LWS(512, 128)` (no-future 1 sweep, online 2 rounds, batch 5 sweeps) on
    a (2, 24, 257) pair of float32 planes and returns the recovered pair.
  - `dryrun_multichip(n_ranks)` runs one pipeline step over a mesh of
    n_ranks ranks (lws_torch.parallel on torch.distributed) in four
    phases, with lws_tpu's configurations, sizes and tolerances
    (__graft_entry__.py:33-204), and raises on a failed check.

The dry run's mesh is lws_tpu's: (data, time) = (2, n // 2) when n >= 4 and
even, else (1, n). Its phases:

  1. `LWS(32, 8, L=2)` (Q = 4, F = 17) on |N(0, 1)| of (2 data, 8 time, 17)
     from zero phase: no-future and online data-parallel over 'data', then
     the batch sweeps time-sharded (`sharded_lws_sweeps`) with kernel "xla"
     and with "tiled" at sweeps_per_exchange=2. Checks: finite, magnitudes
     kept.
  2. `LWS(4096, 1024)` (F = 2049) on |N| + 0.1 of (data, 32 time, 2049), 2
     sweeps: `batch_lws(mesh=, kernel="tiled", sweeps_per_exchange=1)`
     against the unsharded `batch_lws`: both keep magnitudes to rtol = atol
     = 2e-5, consistencies within 0.5 dB.
  3. order "jacobi_mxu" sharded over the same mesh, one exchange a sweep,
     against the unsharded sweeps on phase 2's input: rtol = atol = 2e-4.
  4. `LWS(512, 128)` on 8 bench-style mixtures of 41,088 samples at 16 kHz,
     T cut to a multiple of `time`, 100 sweeps, over mesh (1, time): the
     batch-mean consistency within 0.25 dB of the unsharded run.

The unsharded references of phases 2-4 and the comparisons of phases 2-4
run on rank 0 only; every rank checks rank 0's numbers, so every rank
raises on a failed check. On CUDA float32 each rank's sweeps are the
hand-written kernels: no-future and phase 1's "tiled" blocks, phases 2 and
4 run the sweep kernel K1 (one launch per block of sweeps, one for each
unsharded call), the online stage K3; phase 1's "xla" route and phase 3
run the plain sweeps. Each phase's record counts the K1 and K3 launches it
made on this rank.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch
import torch.distributed as dist

from ._device import real_dtype, resolve_device
from .core.batch import lws_sweeps
from .ops import lws_sweeps as _k1
from .ops import online as _online
from .parallel import data_parallel_run, make_mesh, shard_pair, sharded_lws_sweeps
from .parallel.multihost import mesh_shape, spawn_ranks
from .parallel.sharding import gather_pair
from .processor import LWS
from .windows import get_thresholds

__all__ = ["entry", "dryrun_multichip", "dryrun_inputs", "DRYRUN_SIZES"]

# lws_tpu's dry-run sizes (__graft_entry__.py:86-204): phase 1's batch per
# 'data' rank and frames per 'time' rank, phase 2's frames per 'time' rank,
# phase 4's mixtures, samples per mixture and sweeps
DRYRUN_SIZES = dict(p1_batch=2, p1_frames=8, p2_frames=32,
                    p4_items=8, p4_samples=41088, p4_sweeps=100)


def entry(device=None):
    """(fn, example_args) on `device` (CUDA unless the caller names another):
    fn(sr, si) -> (sr, si) runs no-future -> online -> batch."""
    proc = LWS(512, 128, L=5, device=device)
    thr_nf = get_thresholds(1, 1, 0.1, 1)
    thr_on = get_thresholds(2, 1, 0.1, 1)
    thr_b = get_thresholds(5, 100, 0.1, 1)

    def fn(sr, si):
        pair = proc.nofuture_lws((sr, si), thresholds=thr_nf)
        pair = proc.online_lws(pair, thresholds=thr_on)
        return proc.batch_lws(pair, thresholds=thr_b)

    rng = np.random.default_rng(0)
    amp = torch.tensor(np.abs(rng.standard_normal((2, 24, 257))).astype(np.float32),
                       device=proc.device)
    return fn, (amp, torch.zeros_like(amp))


def dryrun_multichip(n_ranks: int, device=None, dtype=torch.float32, *, _sizes=None):
    """Run the four-phase dry run over n_ranks ranks; returns rank 0's
    record (a dict of each phase's numbers) and raises on a failed check.

    In a default process group of n_ranks ranks (torchrun, the caller's
    own), every rank calls it at once and runs its part; each returns its
    own record, and every rank raises on a failed check. Without a default
    group it spawns n_ranks ranks that join one (`parallel.multihost.
    spawn_ranks`: NCCL when each rank has a card of its own, gloo when the
    ranks outnumber the cards or run on the CPU); a rank's failure is raised
    here.

    `device` is CUDA unless the caller names another ("cpu": the plain
    sweeps); `dtype` float32 (lws_tpu's) or float64 (the plain sweeps).
    """
    n = int(n_ranks)
    sizes = dict(DRYRUN_SIZES, **(_sizes or {}))
    if not dist.is_initialized():
        return spawn_ranks(n, device, _dryrun, n, dtype, sizes)
    if dist.get_world_size() != n:
        raise ValueError(f"lws_torch: dryrun_multichip({n}) in a process group of "
                         f"{dist.get_world_size()} ranks")
    return _dryrun(resolve_device(device), n, dtype, sizes)


def dryrun_inputs(n_ranks: int, device=None, dtype=torch.float32, sizes=None):
    """The magnitudes of the dry run's phases 1, 2 and 4 over n_ranks ranks,
    as numpy arrays of `dtype`'s real type: phase 1 |N(0, 1)| of (p1_batch
    x data, p1_frames x time, 17) and phase 2 |N(0, 1)| + 0.1 of (data,
    p2_frames x time, 2049), both from default_rng(0) in turn; phase 4 |STFT|
    of LWS(512, 128) (on `device`) of p4_items bench-style mixtures of
    p4_samples samples at 16 kHz (default_rng(0) for the noise), its frames
    cut to a multiple of time."""
    sizes = dict(DRYRUN_SIZES, **(sizes or {}))
    data, time = mesh_shape(int(n_ranks))
    npdt = np.float32 if real_dtype(dtype) == torch.float32 else np.float64
    rng = np.random.default_rng(0)
    A1 = np.abs(rng.standard_normal((sizes["p1_batch"] * data, sizes["p1_frames"] * time, 17)))
    A2 = np.abs(rng.standard_normal((data, sizes["p2_frames"] * time, 2049))) + 0.1
    t4 = np.arange(sizes["p4_samples"]) / 16000.0
    rng4 = np.random.default_rng(0)
    xs4 = []
    for i in range(sizes["p4_items"]):
        f0 = 120 + 40 * (i % 8)
        xs4.append(0.5 * np.sin(2 * np.pi * f0 * 2 * t4)
                   + 0.3 * np.sin(2 * np.pi * (f0 * 4.7) * t4 + 0.3 * i)
                   + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t4 / t4[-1]) * t4)
                   + 0.05 * rng4.standard_normal(t4.size))
    A4 = np.abs(LWS(512, 128, dtype=real_dtype(dtype), device=device).stft(np.stack(xs4)))
    A4 = A4[:, :A4.shape[1] - A4.shape[1] % time]
    return dict(phase1=A1.astype(npdt), phase2=A2.astype(npdt), phase4=A4.astype(npdt))


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _within(a, b, tol):
    """max |a - b| over every plane of the pairs, and whether each element
    is within tol + tol * |b| (numpy's allclose at rtol = atol = tol)."""
    worst, ok = 0.0, True
    for x, y in zip(a, b):
        d = (x - y).abs()
        worst = max(worst, float(d.max()))
        ok = ok and bool((d <= tol + tol * y.abs()).all())
    return worst, ok


def _from_rank0(fn):
    """fn() on rank 0 only, and its result on every rank (an all-gather of
    Python objects, so every rank calls it): the dry run's unsharded
    references and comparisons run once, and every rank checks them."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, fn() if dist.get_rank() == 0 else None)
    return every[0]


def _mag(pair):
    return torch.sqrt(pair[0] * pair[0] + pair[1] * pair[1])


class _Counts:
    """K1 and K3 launches on this rank since the last read, with the host
    wall time (synchronised on CUDA)."""

    def __init__(self, device):
        self.device = device
        self._mark()

    def _mark(self):
        self.k1, self.k3, self.t0 = _k1.LAUNCHES, _online.LAUNCHES, _time.perf_counter()

    def read(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = dict(k1_launches=_k1.LAUNCHES - self.k1, k3_launches=_online.LAUNCHES - self.k3,
                   wall_s=_time.perf_counter() - self.t0)
        self._mark()
        return out


def _dryrun(dev, n, dtype, sizes):
    """The four phases on this rank of the default group (every rank calls
    it); returns this rank's record."""
    rank = dist.get_rank()
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else (lambda *a: None)
    rdtype = real_dtype(dtype)
    data, time = mesh_shape(n)  # __graft_entry__.py:80-84
    mesh = make_mesh(data, time, device=dev)

    def pair_of(A):
        a = torch.tensor(A, dtype=rdtype, device=dev)
        return a, torch.zeros_like(a)

    rec = dict(rank=rank, world=n, mesh=[data, time], device=str(dev), dtype=str(rdtype),
               backend=dist.get_backend())
    say(f"dryrun_multichip: {n} rank(s), backend {rec['backend']}, mesh=({data}x{time}), "
        f"{dev.type} {rdtype}")
    count = _Counts(dev)

    # ---- phase 1: data-parallel no-future + online, time-sharded batch ----
    proc = LWS(32, 8, L=2, dtype=rdtype, device=dev)
    inputs = dryrun_inputs(n, dev, rdtype, sizes)
    A = inputs["phase1"]
    B, T = A.shape[:2]
    thr_nf = get_thresholds(1, 1, 0.1, 1)
    thr_on = get_thresholds(2, 1, 0.1, 1)
    thr_b = get_thresholds(3, 100, 0.1, 1)

    def stages(sr, si):
        return proc.online_lws(proc.nofuture_lws((sr, si), thresholds=thr_nf),
                               thresholds=thr_on)

    local = data_parallel_run(stages, pair_of(A), mesh)
    # each rank holds its 'data' block: gather it whole, then split time
    shard = shard_pair(gather_pair(local, mesh, time_sharded=False), mesh, time_sharded=True)
    out = {}
    for kernel, kw in (("xla", {}), ("tiled", dict(sweeps_per_exchange=2))):
        out[kernel] = gather_pair(sharded_lws_sweeps(*shard, proc._st_batch, thr_b, mesh,
                                                     kernel=kernel, **kw), mesh)
    A_t = torch.as_tensor(A).to(dev, rdtype)
    for kernel, pair in out.items():
        err, ok = _within((_mag(pair),), (A_t,), 2e-5)
        _check(ok and all(bool(torch.isfinite(p).all()) for p in pair),
               f"phase 1 ({kernel}): magnitudes off by {err:.3e} (tol 2e-5) or not finite")
    c = {k: float(proc.get_consistency(p).mean()) for k, p in out.items()}
    rec["phase1"] = dict(shape=[B, T, int(A.shape[-1])], consistency_xla=c["xla"],
                         consistency_tiled=c["tiled"], **count.read(),
                         xla=(out["xla"][0] + 1j * out["xla"][1]).cpu().numpy(),
                         tiled=(out["tiled"][0] + 1j * out["tiled"][1]).cpu().numpy())
    say(f"dryrun_multichip ok: mesh=({data}x{time}), out={tuple(out['tiled'][0].shape)}, "
        f"consistency xla={c['xla']:.2f} dB / tiled={c['tiled']:.2f} dB")

    # ---- phase 2: F = 2049 through batch_lws(mesh=, kernel="tiled") ----
    proc2 = LWS(4096, 1024, dtype=rdtype, device=dev)
    A2 = inputs["phase2"]
    T2 = A2.shape[1]
    pair2 = pair_of(A2)
    thr2 = get_thresholds(2, 1, 0.1, 1)
    sh = proc2.batch_lws(pair2, thresholds=thr2, mesh=mesh, kernel="tiled",
                         sweeps_per_exchange=1)

    def reference2():
        un = proc2.batch_lws(pair2, thresholds=thr2)
        mags = {w: _within((_mag(p),), (pair2[0],), 2e-5) for w, p in (("sharded", sh),
                                                                         ("unsharded", un))}
        return mags, float(proc2.get_consistency(un).mean()), float(
            proc2.get_consistency(sh).mean())

    mags, c_un, c_sh = _from_rank0(reference2)
    for what, (err, ok) in mags.items():
        _check(ok, f"phase 2 ({what}): magnitudes off by {err:.3e} (tol 2e-5)")
    _check(abs(c_un - c_sh) < 0.5, f"phase 2: consistency unsharded {c_un:.4f} dB vs "
           f"sharded {c_sh:.4f} dB (tol 0.5 dB)")
    rec["phase2"] = dict(shape=[data, T2, 2049], consistency_unsharded=c_un,
                         consistency_sharded=c_sh, **count.read())
    say(f"dryrun_multichip phase2 ok: F=2049 Q=4 mesh=({data}x{time}), T={T2}, consistency "
        f"unsharded={c_un:.2f} dB / sharded-tiled={c_sh:.2f} dB")

    # ---- phase 3: jacobi_mxu over the mesh, one exchange a sweep ----
    st2 = proc2._st_batch
    mx_sh = gather_pair(sharded_lws_sweeps(*shard_pair(pair2, mesh, time_sharded=True), st2,
                                           thr2, mesh, order="jacobi_mxu",
                                           sweeps_per_exchange=1), mesh)
    err, ok, c_mx = _from_rank0(lambda: (
        *_within(mx_sh, lws_sweeps(*pair2, st2, thr2, order="jacobi_mxu"), 2e-4),
        float(proc2.get_consistency(mx_sh).mean())))
    _check(ok, f"phase 3: jacobi_mxu sharded vs unsharded max|d| {err:.3e} (rtol = atol = 2e-4)")
    rec["phase3"] = dict(max_abs_err=err, consistency=c_mx, **count.read())
    say(f"dryrun_multichip phase3 ok: jacobi_mxu sharded == unsharded (max|d| {err:.2e}, "
        f"consistency {c_mx:.2f} dB)")

    # ---- phase 4: the full schedule's batch-mean parity over (1, time) ----
    proc4 = LWS(512, 128, dtype=rdtype, device=dev)
    A4 = inputs["phase4"]
    T4 = A4.shape[1]
    pair4 = pair_of(A4)
    thr4 = get_thresholds(sizes["p4_sweeps"], 100, 0.1, 1)
    mesh_t = make_mesh(1, time, device=dev)  # collective: every rank makes the groups
    rec["phase4"] = dict(shape=[int(A4.shape[0]), int(T4), int(A4.shape[-1])],
                         in_mesh=mesh_t.coord is not None)
    sh4 = (proc4.batch_lws(pair4, thresholds=thr4, mesh=mesh_t)
           if mesh_t.coord is not None else None)
    c_un4, c_sh4 = _from_rank0(lambda: [
        float(proc4.get_consistency(proc4.batch_lws(pair4, thresholds=thr4)).mean()),
        float(proc4.get_consistency(sh4).mean())])
    _check(abs(c_sh4 - c_un4) < 0.25, f"phase 4: batch-mean consistency sharded "
           f"{c_sh4:.4f} dB vs unsharded {c_un4:.4f} dB (tol 0.25 dB)")
    rec["phase4"].update(consistency_unsharded=c_un4, consistency_sharded=c_sh4,
                         **count.read())
    say(f"dryrun_multichip phase4 ok: {sizes['p4_sweeps']}-iter sharded batch-mean "
        f"parity T={T4} time={time}: unsharded={c_un4:.2f} dB sharded={c_sh4:.2f} dB "
        f"(delta {c_sh4 - c_un4:+.3f} dB)")
    return rec
