"""The roofline's counts against chip_smoke.py's sweep_bound and
online_bound at the cells' shapes (counts repeat exactly on the CPU)."""
import numpy as np
import pytest
import torch

import chip_smoke
import lws_torch
from lws_torch.ops import online as online_mod
from portbench import generate, harness, roofline

# (configuration, traffic) of the offline cells: the shapes of their calls
OFFLINE = [("speech16k", "batch32"), ("music16k", "pipeline32_spec")]


def _frames(cfg, seconds):
    n = int(round(seconds * cfg["sample_rate"]))
    fsize, fshift = cfg["program"]["fsize"], cfg["program"]["fshift"]
    pre = fsize - fshift
    return (pre + n + (-n) % fshift) // fshift


@pytest.mark.parametrize("cname,tname", OFFLINE)
def test_offline_counts(cname, tname):
    cfg, tr = generate.load("configs", cname), generate.load("traffic", tname)
    proc = harness.program(lws_torch, cfg, "cpu")
    wk = roofline.Work(cfg)
    B, T, F = tr["items"], _frames(cfg, tr["seconds"]), proc.fsize // 2 + 1
    rng = np.random.default_rng(0)
    amax, mean = rng.uniform(20, 60, B), rng.uniform(0.1, 1.0, B)
    counts = wk.offline(tr["entry"], amax, mean, T)
    live = torch.as_tensor(wk.live("batch", amax, mean))
    _, _, flops, nbytes, _ = chip_smoke.sweep_bound(proc._st_batch, proc.batch_inner_passes,
                                                    live, T, F, B)
    assert counts["batch"] == (flops, nbytes)
    stages = {"batch"}
    if proc.nofuture_iterations and tr["entry"] == "run_lws":
        live = torch.as_tensor(wk.live("nofuture", amax, mean))
        _, _, flops, nbytes, _ = chip_smoke.sweep_bound(proc._st_nofuture, 1, live, T, F, B)
        assert counts["nofuture"] == (flops, nbytes)
        stages.add("nofuture")
    if proc.online_iterations and tr["entry"] == "run_lws":
        _, _, flops, nbytes, _ = chip_smoke.online_bound(proc, online_mod, T, F, B,
                                                         proc.online_iterations)
        assert counts["online"] == (flops, nbytes)
        stages.add("online")
    assert set(counts) == stages
    assert set(wk.offline("batch_lws", amax, mean, T)) == {"batch"}


def test_least_seconds_is_the_larger_bound():
    p = roofline.PEAKS
    assert roofline.least_seconds(p["f32_flop_s"], 0.0) == 1.0
    assert roofline.least_seconds(0.0, 2 * p["hbm_byte_s"]) == 2.0


@pytest.mark.parametrize("cname,tname", OFFLINE)
def test_least_time_of_the_calls(cname, tname):
    """The runner's least time of k calls: the pool's sets in turn."""
    cfg = generate.load("configs", cname)
    tr = dict(generate.load("traffic", tname), items=2, seconds=0.25, pool=2, checked=1)
    drv = harness.kind(tr["kind"]).Driver(lws_torch, cfg, tr, 5, "cpu")
    one, two = drv.least_s(1), drv.least_s(2)
    assert 0 < one <= two
    assert drv.least_s(4) == pytest.approx(2 * two, rel=1e-12)
