"""lws_torch.parallel on the CPU: four gloo ranks (torch.multiprocessing,
spawned once for the module) run every mesh case in float64, and the
parent holds the results to lws_tpu.parallel on the 8-device virtual CPU
mesh tests/conftest.py gives (the counterparts of tests/test_sharding.py),
to the port's own unsharded and segmented sweeps, and to the contracts of
the multi-process helpers. The same spawn runs the port's dry run
(`lws_torch.entry.dryrun_multichip`, in-rank) and the two stages of its
multi-card example; one test spawns the dry run's own two ranks.

The ranks import this module to unpickle their entry point, so it imports
neither jax nor lws_tpu at the top: the parent's test bodies do, and one
case checks that a rank's sys.modules holds neither. lws_tpu's references
run its "xla" sharded path only (its interpret-mode tiled path is slow, and
tests/test_sharding.py already holds it to the xla path).
"""
import os
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

import lws_torch
from lws_torch.entry import dryrun_inputs, dryrun_multichip
from lws_torch.examples import multichip
from lws_torch.parallel import (
    data_parallel_run,
    init_distributed,
    make_host_mesh,
    make_mesh,
    scaling_report,
    shard_pair,
    sharded_lws_sweeps,
)
from lws_torch.parallel import multihost, sharding

# One torch thread per process: the ranks run beside the other test workers.
torch.set_num_threads(1)

WORLD = 4
JOIN_LIMIT_S = 150
ORDERS = ("gs", "jacobi", "jacobi_mxu")
MESHES = ((1, 4), (2, 2))
F64 = torch.float64
# The dry run's sizes in the spawn: lws_tpu's (entry.DRYRUN_SIZES) but for
# phase 2's frames (8 per 'time' rank, not 32: phases 2 and 3 at F = 2049
# repeat the xla and jacobi_mxu cases above) and phase 4, cut from 8
# mixtures of 41,088 samples and 100 sweeps (~120 s a rank at one thread)
# to one of 8,192 samples and 20 sweeps (~1 s); its sharded batch mean keeps
# the dry run's 0.25 dB bound over time = 2 there (measured +0.046 dB; 12,288
# samples at 100 sweeps missed it by 0.46 dB). The spawn-route test's
# smallest table: phase 4's 5 sweeps at alpha = 100 are all dead.
DRYRUN_TEST_SIZES = dict(p2_frames=8, p4_items=1, p4_samples=8192, p4_sweeps=20)
DRYRUN_SMALLEST = dict(p1_batch=1, p1_frames=4, p2_frames=4, p4_items=1, p4_samples=4096,
                       p4_sweeps=5)
# The example's two stages in the spawn: one 0.25 s utterance per 'data'
# rank, 16 frames per 'time' rank
EXAMPLE_TEST_SIZES = dict(utterances=1, seconds=0.25, frames=16)


def _golden_q4_spectrogram():
    with np.load(os.path.join(os.path.dirname(__file__), "golden", "ref_q4.npz")) as z:
        return z["S"]


def _inputs():
    """Made in the parent from the golden q4 spectrogram (66, 257), T cut
    to 64: |S| (zero phase), 4 scaled copies of it, two items with seeded
    random phases (the second time-reversed at 0.7x: different means),
    and a 2 s random signal's STFT magnitude at LWS(4096, 1024)."""
    A1 = np.abs(_golden_q4_spectrogram())[:64]
    S = A1 * np.exp(2j * np.pi * np.random.default_rng(7).random(A1.shape))
    x = np.random.default_rng(3).standard_normal(48000 * 2)
    long = lws_torch.LWS(4096, 1024, dtype=F64, device="cpu").stft(x)
    return dict(A1=A1, A4=np.stack([A1 * (1 + 0.1 * i) for i in range(4)]),
                S2=np.stack([S, 0.7 * S[::-1]]), long=np.abs(long[:long.shape[0] // 4 * 4]))


def _pair(S):
    return torch.tensor(np.real(S)), torch.tensor(np.imag(np.asarray(S, dtype=complex)))


def _whole(pair):
    return (pair[0] + 1j * pair[1]).numpy()


def _cases(inp):
    """(name, fn) run in order on every rank; each fn returns rank 0's
    record (other ranks' returns are dropped)."""
    proc = lws_torch.LWS(512, 128, L=5, dtype=F64, device="cpu")
    st, ip, scheme = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme
    thr4 = torch.tensor(lws_torch.get_thresholds(4, 1, 0.1, 1))
    S2 = _pair(inp["S2"])

    def sweeps(mesh, pair, thr, **kw):
        local = shard_pair(pair, mesh, time_sharded=True)
        out = sharded_lws_sweeps(*local, st, thr, mesh, inner_passes=ip,
                                 inner_scheme=scheme, **kw)
        return _whole(sharding.gather_pair(out, mesh))

    def data_parallel():
        mesh = make_mesh(4, 1, device="cpu")
        thr = lws_torch.get_thresholds(3, 100, 0.1, 1)
        out = data_parallel_run(lambda sr, si: proc.batch_lws((sr, si), thresholds=thr),
                                _pair(inp["A4"].astype(complex)), mesh)
        return dict(dp=_whole(sharding.gather_pair(out, mesh, time_sharded=False)),
                    batch_mesh=proc.batch_lws(inp["A4"].astype(complex), thresholds=thr,
                                              mesh=mesh))

    def xla(order, shape):
        return lambda: sweeps(make_mesh(*shape, device="cpu"), S2, thr4, order=order)

    def jacobi_t0():
        thr = torch.tensor(lws_torch.get_thresholds(1, 0, 0.1, 1))
        return sweeps(make_mesh(1, 4, device="cpu"), _pair(inp["A1"].astype(complex)), thr,
                      order="jacobi")

    def tiled():
        mesh = make_mesh(1, 4, device="cpu")
        thr12 = torch.tensor(lws_torch.get_thresholds(12, 1, 0.1, 1))
        s5 = sweeps(mesh, S2, thr12, kernel="tiled", sweeps_per_exchange=5)
        # the mean the sharded sweeps take (an all-reduce: every rank calls it)
        mean = sharding._global_mean(*shard_pair(S2, mesh, time_sharded=True), mesh)
        seg = lws_torch.segmented_lws_sweeps(*S2, st, thr12, segments=4, sweeps_per_exchange=5,
                                             inner_passes=ip, inner_scheme=scheme,
                                             mean_amp=mean)
        A1 = inp["A1"].astype(complex)
        thr = lws_torch.get_thresholds(12, 100, 0.1, 1)
        return dict(s1=sweeps(mesh, S2, thr4, kernel="tiled"),
                    xla=sweeps(mesh, S2, thr4, order="gs"), s5=s5, seg=_whole(seg),
                    q_sharded=proc.batch_lws(A1, thresholds=thr, mesh=mesh, kernel="tiled",
                                             sweeps_per_exchange=5),
                    q_whole=proc.batch_lws(A1, thresholds=thr))

    def one_rank():
        mesh = make_mesh(1, 1, device="cpu")  # collective: every rank creates its groups
        if mesh.coord is None:
            return None
        S = inp["S2"]
        thr = lws_torch.get_thresholds(3, 1, 0.1, 1)
        return dict(whole=proc.batch_lws(S, thresholds=thr),
                    auto=proc.batch_lws(S, thresholds=thr, mesh=mesh),
                    tiled=proc.batch_lws(S, thresholds=thr, mesh=mesh, kernel="tiled"))

    def errors():
        out = {}
        mesh = make_mesh(1, 4, device="cpu")
        for name, fn in (
                ("divisible", lambda: shard_pair(_pair(np.ones((2, 5, 257))), mesh, True)),
                ("divisible_batch", lambda: proc.batch_lws(np.ones((2, 5, 257)), mesh=mesh)),
                ("frames", lambda: sharded_lws_sweeps(
                    *shard_pair(_pair(np.ones((2, 8, 257))), mesh, True), st, thr4, mesh)),
                ("ranks", lambda: make_mesh(2, 4, device="cpu"))):
            try:
                fn()
                out[name] = "no error"
            except ValueError as e:
                out[name] = str(e)
        return out

    def longform():
        p = lws_torch.LWS(4096, 1024, L=5, dtype=F64, device="cpu")
        return p.batch_lws(inp["long"].astype(complex), thresholds=np.zeros(4),
                           mesh=make_mesh(1, 4, device="cpu"))

    def selection():
        mesh = make_mesh(1, 4, device="cpu")
        A = inp["A1"].astype(complex)[None]
        return {k: proc.batch_lws(A, iterations=4, mesh=mesh, kernel=k)
                for k in (None, "xla", "tiled")}

    def host_mesh():
        return make_host_mesh(2, 2, device="cpu").ranks

    def mesh_groups():
        # a mesh built again reuses its lines' groups (one cache per default group)
        a, b = make_mesh(2, 2, device="cpu"), make_mesh(2, 2, device="cpu")
        c = make_mesh(1, 4, device="cpu")
        return dict(same=[a.groups[k] is b.groups[k] for k in ("data", "time")],
                    time_1x4_is_new=c.groups["time"] not in (a.groups["data"],
                                                             a.groups["time"]),
                    cached=sorted(sharding._GROUPS))

    def report():
        return scaling_report(proc, T_frames=64, iters=2, time_shards=4, n_rep=1)

    def dryrun():
        return dryrun_multichip(WORLD, device="cpu", dtype=F64, _sizes=DRYRUN_TEST_SIZES)

    def example():
        return multichip.run(make_mesh(2, 2, device="cpu"), **EXAMPLE_TEST_SIZES)

    return ([("data_parallel", data_parallel)]
            + [(f"xla_{o}_{d}x{t}", xla(o, (d, t))) for o in ORDERS for d, t in MESHES]
            + [("jacobi_t0", jacobi_t0), ("tiled", tiled), ("one_rank", one_rank),
               ("errors", errors), ("longform", longform), ("selection", selection),
               ("host_mesh", host_mesh), ("mesh_groups", mesh_groups), ("report", report),
               ("dryrun", dryrun), ("example", example)])


def _rank_main(rank, world, root, inp):
    """One rank: join the gloo group through a file store, run every case,
    and write rank 0's records (or a case's traceback) to root."""
    torch.set_num_threads(1)
    rec = dict(multi=init_distributed(coordinator_address=f"file://{root}/store",
                                      num_processes=world, process_id=rank,
                                      backend="gloo", timeout=60),
               imports=sorted(m for m in ("jax", "lws_tpu") if m in sys.modules),
               seconds={})
    for name, fn in _cases(inp):
        t0 = time.perf_counter()
        try:
            rec[name] = fn()
        except Exception:  # recorded: the test of this case fails with it
            rec[name] = "ERROR " + traceback.format_exc()
        rec["seconds"][name] = time.perf_counter() - t0
    dist.destroy_process_group()
    if rank:  # the other ranks' records are rank 0's; their errors are their own
        rec = {k: v for k, v in rec.items() if isinstance(v, str) and v.startswith("ERROR")}
    torch.save(rec, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """Rank 0's records of every case, from one spawn of WORLD gloo ranks."""
    root = str(tmp_path_factory.mktemp("parallel"))
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(WORLD, root, inputs), nprocs=WORLD, join=False,
        start_method="spawn")
    deadline = time.monotonic() + JOIN_LIMIT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):  # a rank's raise re-raises
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD} ranks did not finish within {JOIN_LIMIT_S} s")
    recs = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return dict(recs[0], other_errors={r: recs[r] for r in range(1, WORLD) if recs[r]})


def _get(ranks, name):
    rec = ranks[name]
    if isinstance(rec, str) and rec.startswith("ERROR"):
        pytest.fail(f"case {name} raised in a rank:\n{rec}")
    return rec


def _tpu():
    import jax.numpy as jnp
    from lws_tpu import LWS
    return LWS(512, 128, L=5, dtype=jnp.float64)


def _tpu_sharded(S, mesh_shape, thr, **kw):
    import jax.numpy as jnp
    from lws_tpu.core.stencil import merge, split
    from lws_tpu.parallel import make_mesh as jmesh
    from lws_tpu.parallel import shard_pair as jshard
    from lws_tpu.parallel import sharded_lws_sweeps as jsweeps
    p = _tpu()
    mesh = jmesh(*mesh_shape)
    pair = jshard(split(S, dtype=jnp.float64), mesh, time_sharded=True)
    return merge(*jsweeps(*pair, st=p._st_batch, thresholds=jnp.asarray(thr), mesh=mesh,
                          inner_passes=p.batch_inner_passes, **kw))


def test_ranks_import_neither_jax_nor_lws_tpu(ranks):
    """The ranks joined a group of WORLD, no case raised on ranks 1-3 (rank
    0's are the cases' own tests), and importing lws_torch.parallel and
    this module left jax and lws_tpu out of every rank."""
    assert ranks["multi"] is True
    assert not ranks["other_errors"], ranks["other_errors"]
    assert ranks["imports"] == [], ranks["imports"]


def test_data_parallel_matches_lws_tpu(ranks, inputs):
    """(4, 1): each rank runs the port's batch_lws on its utterance;
    gathered, equal to lws_tpu's _batch_fn on golden q4 x 4 scaled copies,
    3 sweeps; batch_lws(mesh=) over (4, 1) too."""
    import jax.numpy as jnp
    from lws_tpu.core.stencil import merge, split
    rec = _get(ranks, "data_parallel")
    inp = inputs
    p = _tpu()
    thr = jnp.asarray(lws_torch.get_thresholds(3, 100, 0.1, 1))
    ref = merge(*p._batch_fn(*split(inp["A4"].astype(complex), dtype=jnp.float64),
                             thresholds=thr))
    np.testing.assert_allclose(rec["dp"], ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rec["batch_mesh"], ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("order", ORDERS)
def test_xla_path_matches_lws_tpu(ranks, inputs, order, shape):
    """The portable path over a time (1, 4) and a mixed (2, 2) mesh, 4
    sweeps at alpha=1 from seeded random phases, against lws_tpu's
    sharded_lws_sweeps(kernel="xla") on the same mesh."""
    out = _get(ranks, f"xla_{order}_{shape[0]}x{shape[1]}")
    ref = _tpu_sharded(inputs["S2"], shape, lws_torch.get_thresholds(4, 1, 0.1, 1),
                       order=order, kernel="xla")
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)


def test_jacobi_threshold_zero_matches_unsharded(ranks, inputs):
    """One Jacobi sweep at threshold 0: interior boundaries read the same
    neighbour values as the whole grid, the ends the same frozen replicas."""
    out = _get(ranks, "jacobi_t0")
    p = lws_torch.LWS(512, 128, L=5, dtype=F64, device="cpu", order="jacobi")
    ref = p.batch_lws(inputs["A1"].astype(complex), thresholds=[0.0])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)


def test_tiled_route_one_sweep_per_exchange_equals_xla(ranks):
    rec = _get(ranks, "tiled")
    np.testing.assert_allclose(rec["s1"], rec["xla"], rtol=0, atol=1e-12)


def test_tiled_route_equals_segmented_sweeps(ranks):
    """Five sweeps per exchange over time=4 are the port's segmented sweeps
    at S = 4, exchange every 5, given the same mean: same blocks, halos and
    frozen ends."""
    rec = _get(ranks, "tiled")
    np.testing.assert_allclose(rec["s5"], rec["seg"], rtol=0, atol=1e-12)


def test_tiled_route_quality(ranks, inputs):
    """12 sweeps from |X|, an exchange every 5: within 0.8 dB of the
    unsharded sweeps (tests/test_sharding.py's bound), magnitudes kept."""
    rec = _get(ranks, "tiled")
    p = lws_torch.LWS(512, 128, L=5, dtype=F64, device="cpu")
    c_sh = float(p.get_consistency(rec["q_sharded"]))
    c_un = float(p.get_consistency(rec["q_whole"]))
    assert c_sh > c_un - 0.8, (c_sh, c_un)
    np.testing.assert_allclose(np.abs(rec["q_sharded"]), inputs["A1"], rtol=0, atol=1e-9)


def test_one_rank_mesh_equals_batch_lws(ranks):
    """Mesh (1, 1): one time shard has nothing to exchange, so the auto
    route ("xla" off CUDA) and the tiled route each run the unsharded
    sweeps in one call and equal batch_lws bit for bit."""
    rec = _get(ranks, "one_rank")
    np.testing.assert_array_equal(rec["auto"], rec["whole"])
    np.testing.assert_array_equal(rec["tiled"], rec["whole"])


@pytest.mark.parametrize("case, match", [
    ("divisible", "T=5 not divisible by time=4"),
    ("divisible_batch", "T=5 not divisible by time=4"),
    ("frames", r"each time shard needs >= Q-1=3 frames"),
    ("ranks", "need 8 ranks, have 4"),
])
def test_sharding_errors(ranks, case, match):
    import re
    msg = _get(ranks, "errors")[case]
    assert re.search(match, msg), msg


def test_longform_4096_time_sharded(ranks, inputs):
    """LWS(4096, 1024) (F = 2049) over time = 4 through batch_lws(mesh=):
    magnitudes kept, consistency up by 3 dB (tests/test_sharding.py)."""
    out = _get(ranks, "longform")
    A = inputs["long"]
    assert out.shape == A.shape
    p = lws_torch.LWS(4096, 1024, L=5, dtype=F64, device="cpu")
    c0 = float(p.get_consistency(A.astype(complex)))
    c1 = float(p.get_consistency(out))
    assert c1 > c0 + 3, (c0, c1)
    np.testing.assert_allclose(np.abs(out), A, rtol=0, atol=1e-9)


def test_kernel_selection(ranks):
    """Off CUDA, kernel=None is "xla" (bit for bit); a forced "tiled"
    equals it (the same frame order, one sweep per exchange)."""
    rec = _get(ranks, "selection")
    np.testing.assert_array_equal(rec[None], rec["xla"])
    np.testing.assert_allclose(rec["tiled"], rec["xla"], rtol=0, atol=1e-12)


def test_make_host_mesh_order(ranks):
    """One host: C order over the ranks; time neighbours consecutive."""
    assert _get(ranks, "host_mesh").tolist() == [[0, 1], [2, 3]]
    # two hosts whose ranks alternate: each host's ranks first, in order
    assert multihost._host_major(["a", "b", "a", "b"], 4) == [0, 2, 1, 3]
    assert multihost._host_major(["a", "b", "a", "b", "c"], 3) == [0, 2, 1]


def test_mesh_groups_are_cached(ranks):
    """Building a mesh again makes no new process groups: equal lines share
    one (time lines of (2, 2): (0, 1), (2, 3); data lines: (0, 2), (1, 3);
    (1, 4)'s time line and its one-rank data lines are new)."""
    rec = _get(ranks, "mesh_groups")
    assert rec["same"] == [True, True] and rec["time_1x4_is_new"], rec
    want = {(0, 1), (2, 3), (0, 2), (1, 3), (0, 1, 2, 3), (0,), (1,), (2,), (3,)}
    assert want <= set(rec["cached"]), rec["cached"]


def test_forced_tiled_refuses_a_geometry_k1_cannot_plan(monkeypatch):
    """kernel="tiled" where K1's plan does not fit raises before any
    sharding, on any device (the plan is the geometry's)."""
    from lws_torch import processor
    p = lws_torch.LWS(512, 128, device="cpu")
    plan = processor.sweep_plan(257, p._Qi, p.L)
    monkeypatch.setattr(processor, "sweep_plan",
                        lambda F, Q, L: plan._replace(bytes=1 << 30))
    A = np.ones((1, 8, 257), dtype=complex)
    with pytest.raises(ValueError, match="tiled kernel cannot run this sharded geometry"):
        p.batch_lws(A, iterations=2, mesh=make_mesh(1, 1, device="cpu"), kernel="tiled")
    p.batch_lws(A, iterations=2, mesh=make_mesh(1, 1, device="cpu"))  # off CUDA: "xla"


def _fake_cuda(monkeypatch, cards, hosts):
    """init_distributed with `cards` CUDA cards and the ranks on `hosts`,
    the group itself stubbed: returns the calls it made."""
    calls = dict(init=[], destroy=0, device=[], hosts=0)
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", calls["device"].append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls["init"].append((backend, kw)))

    def destroy(group=None):
        calls["destroy"] += 1
    monkeypatch.setattr(dist, "destroy_process_group", destroy)

    def host_names(backend):
        calls["hosts"] += 1
        return hosts
    monkeypatch.setattr(multihost, "_host_names", host_names)
    return calls


def test_init_distributed_places_ranks_by_host(monkeypatch):
    """Without torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE, the ranks per host
    come from the ranks' host names: 2 hosts x 4 cards, 8 NCCL ranks, is
    no oversubscription, and rank 5 takes its host's card 1. 8 ranks on
    one 4-card host raise for NCCL (the group torn down) and run on gloo.
    With torchrun's variables, those are used and no names are gathered."""
    calls = _fake_cuda(monkeypatch, 4, ["a"] * 4 + ["b"] * 4)
    assert init_distributed("localhost:29500", num_processes=8, process_id=5) is True
    assert calls["init"][0][0] == "nccl" and calls["device"] == [1]
    assert calls["init"][0][1]["init_method"] == "tcp://localhost:29500"
    calls = _fake_cuda(monkeypatch, 4, ["a"] * 8)
    with pytest.raises(ValueError, match="8 ranks on this host share 4 CUDA card"):
        init_distributed("localhost:29500", num_processes=8, process_id=5)
    assert calls["destroy"] == 1 and calls["device"] == []
    assert init_distributed("localhost:29500", num_processes=8, process_id=5,
                            backend="gloo") is True
    assert calls["device"] == [1]  # local rank 5, modulo 4 cards
    calls = _fake_cuda(monkeypatch, 4, ["a"] * 8)
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert init_distributed("localhost:29500", num_processes=8, process_id=6) is True
    assert calls["device"] == [2] and calls["hosts"] == 0


def test_scaling_report_fields(ranks):
    rep = _get(ranks, "report")
    assert set(rep) == {"T", "F", "iters", "shards", "kernel", "platform", "wall_1dev_s",
                        "wall_Ndev_s", "speedup", "efficiency", "estimate_only"}
    assert rep["shards"] == 4 and rep["T"] == 64 and rep["F"] == 257
    assert rep["platform"] == "cpu" and rep["estimate_only"] is True
    assert rep["speedup"] is not None and rep["efficiency"] > 0


def test_init_distributed_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()


def test_sharded_sweeps_refuse_grad():
    """Autograd does not cross the point-to-point exchange: a tensor that
    requires grad is refused, naming the entry point; a mesh of one rank
    needs no process group."""
    p = lws_torch.LWS(512, 128, device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    sr = torch.ones(1, 8, 257, requires_grad=True)
    si = torch.zeros(1, 8, 257)
    with pytest.raises(ValueError, match="sharded_lws_sweeps refuses a tensor that requires grad"):
        sharded_lws_sweeps(sr, si, p._st_batch, torch.ones(2), mesh)
    with pytest.raises(ValueError, match="sharded_lws_sweeps"):
        p.batch_lws((sr, si), iterations=2, mesh=mesh)
    with torch.no_grad():
        out = sharded_lws_sweeps(sr, si, p._st_batch, torch.ones(2), mesh)
    assert out[0].shape == sr.shape
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        make_mesh(1, 4, device="cpu")


def _phase_numbers(rec):
    return {k: v for p in ("phase1", "phase2", "phase3", "phase4") for k, v in rec[p].items()
            if isinstance(v, float)}


def test_dryrun_phases_pass_in_rank(ranks):
    """dryrun_multichip(4) inside the four ranks (mesh (2, 2), float64 on
    the CPU): every phase ran on rank 0 and passed its own checks (a failed
    one raises in every rank), with finite numbers; the CPU launches no
    kernel."""
    rec = _get(ranks, "dryrun")
    assert rec["mesh"] == [2, 2] and rec["backend"] == "gloo" and rec["world"] == WORLD
    assert rec["phase1"]["shape"] == [4, 16, 17]
    assert rec["phase2"]["shape"] == [2, 16, 2049]
    assert rec["phase4"]["in_mesh"] and rec["phase4"]["shape"] == [1, 66, 257]
    nums = _phase_numbers(rec)
    assert {"consistency_xla", "consistency_tiled", "consistency_unsharded",
            "consistency_sharded", "max_abs_err", "consistency"} <= set(nums), nums
    assert all(np.isfinite(v) for v in nums.values()), nums
    assert abs(rec["phase4"]["consistency_sharded"]
               - rec["phase4"]["consistency_unsharded"]) < 0.25
    assert rec["phase3"]["max_abs_err"] <= 2e-4
    assert all(rec[p]["k1_launches"] == rec[p]["k3_launches"] == 0
               for p in ("phase1", "phase2", "phase3", "phase4"))
    print("dry run in the spawn: rank 0 took %.1f s" % ranks["seconds"]["dryrun"])


def test_dryrun_phase1_matches_lws_tpu(ranks):
    """Phase 1 in float64 against lws_tpu's own composition on a (2, 2)
    mesh of the virtual CPU devices, same numpy input: _nofuture_fn ->
    _online_fn data-parallel, then sharded_lws_sweeps(kernel="xla"). From
    zero phase; the port's "xla" result to 1e-6 x max amp (the online
    stage's float64 record is 7.5e-7; measured 3.5e-14, held to 1e-10)."""
    import jax.numpy as jnp
    from lws_tpu import LWS as JLWS
    from lws_tpu.core.stencil import merge, split
    from lws_tpu.parallel import make_mesh as jmesh
    from lws_tpu.parallel import shard_pair as jshard
    from lws_tpu.parallel import sharded_lws_sweeps as jsweeps
    rec = _get(ranks, "dryrun")["phase1"]
    p = JLWS(32, 8, L=2, dtype=jnp.float64)
    mesh = jmesh(data=2, time=2)
    A = np.abs(np.random.default_rng(0).standard_normal((4, 16, 17)))
    thr = [jnp.asarray(lws_torch.get_thresholds(*a)) for a in
           ((1, 1, 0.1, 1), (2, 1, 0.1, 1), (3, 100, 0.1, 1))]
    sr, si = p._nofuture_fn(*jshard(split(A + 0j, dtype=jnp.float64), mesh), thresholds=thr[0])
    sr, si = p._online_fn(sr, si, thresholds=thr[1])
    sr, si = jshard((sr, si), mesh, time_sharded=True)
    ref = np.asarray(merge(*jsweeps(sr, si, st=p._st_batch, thresholds=thr[2], mesh=mesh)))
    np.testing.assert_array_equal(dryrun_inputs(WORLD, "cpu", F64, DRYRUN_TEST_SIZES)["phase1"], A)
    err = np.abs(rec["xla"] - ref).max() / A.max()
    print(f"phase 1, port vs lws_tpu, float64: max|d| / max amp {err:.3e}")
    assert err <= 1e-10, err
    np.testing.assert_allclose(np.abs(rec["tiled"]), A, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (1, 2)), (3, (1, 3)), (4, (2, 2)),
                                      (6, (2, 3)), (8, (2, 4))])
def test_mesh_shape_is_lws_tpus(n, shape):
    """The dry run's and the example's mesh: lws_tpu's rule
    (__graft_entry__.py:80-84), (2, n // 2) for an even n >= 4, else (1, n)."""
    from lws_torch.parallel.multihost import mesh_shape
    assert mesh_shape(n) == shape


def test_example_stages_in_rank(ranks):
    """The example's two stages over (2, 2): run_lws keeps magnitudes and
    beats |X|'s consistency on every utterance; the time-sharded batch_lws
    gives a finite consistency on its (2, 32, 257) spectrogram."""
    rec = _get(ranks, "example")
    assert rec["mesh"] == [2, 2] and rec["utterances"] == 2
    assert rec["magnitude_err"] <= 1e-5, rec["magnitude_err"]
    assert all(c > c0 for c, c0 in zip(rec["consistency"], rec["consistency_in"])), rec
    assert rec["long_shape"] == [2, 32, 257] and np.isfinite(rec["long_consistency"])


def test_dryrun_spawn_route():
    """Without a process group dryrun_multichip spawns its ranks: two gloo
    ranks on the CPU at the smallest table, run from a process without jax;
    importing lws_torch.entry and lws_torch.examples.multichip and running
    it leaves jax and lws_tpu out of sys.modules. A rank's failure (a time
    shard of fewer than Q-1 frames, on one spawned rank) raises in the caller."""
    import json
    import subprocess
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import lws_torch.entry as e, lws_torch.examples.multichip\n"
        f"rec = e.dryrun_multichip(2, device='cpu', _sizes={DRYRUN_SMALLEST!r})\n"
        "try:\n"
        "    e.dryrun_multichip(1, device='cpu', _sizes=dict(p2_frames=1))\n"
        "    failed = None\n"
        "except Exception as x:\n"
        "    failed = f'{type(x).__name__}: {x}'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lws_tpu'))\n"
        "print(json.dumps(dict(mesh=rec['mesh'], backend=rec['backend'], bad=bad, "
        "failed=failed, nums={p: [v for v in rec[p].values() if isinstance(v, float)] "
        "for p in ('phase1', 'phase2', 'phase3', 'phase4')})))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["mesh"] == [1, 2] and out["backend"] == "gloo", out
    assert all(np.isfinite(v) for vs in out["nums"].values() for v in vs), out
    for line in ("dryrun_multichip ok:", "phase2 ok", "phase3 ok", "phase4 ok"):
        assert line in r.stdout, r.stdout
    assert out["failed"] and "each time shard needs >= Q-1=3 frames" in out["failed"], out


def test_dryrun_and_example_need_a_card_unless_told(monkeypatch):
    """Without CUDA and without device=, both entry points raise before
    spawning anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multichip.main(["--ranks", "1"])
