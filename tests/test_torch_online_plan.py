"""The online kernels' launch plan and weight table on the CPU: the Python
mirror `ops.online.online_plan` at the geometries the kernels K3 and K4
take (the library's defaults and those the previous kernels refused), the
weights' period in the bin index that the table is built on, the table's
cache, and the plain online stage against lws_tpu's at one newly covered
geometry (Q = 8, F = 2049). The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py) and, rehearsed on the CPU, in
port_tools/cuda_on_cpu.py, which also holds the built library's plan to
this mirror.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lws_torch
import lws_tpu
from lws_torch.convert import stencil_from_numpy
from lws_torch.core.online import rtisi_la as torch_rtisi_la
from lws_torch.ops import online as online_mod
from lws_tpu.core.online import rtisi_la as jax_rtisi_la

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)

# (label, LWS arguments, K4?, live taps G, period P, plan: bins, threads,
# width, ring, table, amp rows, fixed kernel, bytes). A (re, im) pair is 8
# bytes: one centre-row copy and the ring rows of F + 2L pairs, the table
# G x P pairs; the tap lists 4 x (3 x (2 + LA) x (2Q - 1) + G) bytes; K4's
# amp rows 4 x (LA + 1) x F.
PLANS = [
    ("music K3, LWS(1024, 256)", ((1024, 256), dict(mode="music")), False, 216, 4,
     (1, 544, 523, True, True, False, True, 41668)),
    ("streaming K4, LWS(512, 128, look_ahead=3)", ((512, 128), dict(look_ahead=3)), True,
     216, 4, (1, 288, 267, True, True, True, True, 29396)),
    ("LWS(4096, 512, music) K3: Q = 8, F = 2049", ((4096, 512), dict(mode="music")), False,
     444, 8, (3, 704, 2059, True, True, False, False, 228756)),
    ("LWS(4096, 512, music) K4: amp rows in device memory",
     ((4096, 512), dict(mode="music")), True, 444, 8,
     (3, 704, 2059, True, True, False, False, 228756)),
    ("Q = 32: table in device memory", ((256, 8), dict(L=3)), False, 1126, 32,
     (1, 160, 135, True, False, False, False, 47164)),
    ("look_ahead = 10, K4", ((512, 128), dict(look_ahead=10)), True, 636, 4,
     (1, 288, 267, True, True, True, True, 67252)),
    ("F = 8193 K3: ring in device memory", ((16384, 4096), {}), False, 216, 4,
     (9, 928, 8203, False, True, False, False, 73820)),
    ("F = 8193 K4: ring in device memory, amp rows shared", ((16384, 4096), {}), True, 216,
     4, (9, 928, 8203, False, True, True, False, 204908)),
]


@pytest.mark.parametrize("label,geometry,chunk,taps,period,plan", PLANS,
                         ids=[p[0] for p in PLANS])
def test_online_plan(label, geometry, chunk, taps, period, plan):
    args, kw = geometry
    p = lws_torch.LWS(*args, device="cpu", **kw)
    F = p.fftsize // 2 + 1
    wt = online_mod.online_weight_sets(p._st_la, p._st_nofuture, p._st_af)
    assert (wt.dks.numel(), wt.period) == (taps, period)
    got = online_mod.online_plan(F, p._Qi, p.L, p.look_ahead, chunk, taps, period)
    assert tuple(got) == plan
    assert got.fits and got.bytes <= online_mod.SMEM_LIMIT
    assert online_mod.online_supported(F, p._Qi, p.L, p.look_ahead, chunk)


def test_online_gate_refuses_only_float64():
    """On CUDA the kernels refuse float64 (naming backend='torch') and take
    every geometry above; the lane skip still raises."""
    for F, Q, L, LA in ((2049, 8, 5, 3), (129, 32, 3, 3), (257, 4, 5, 10), (8193, 4, 5, 3)):
        for chunk in (False, True):
            online_mod.check_online(F, Q, L, LA, torch.float32, chunk)
            with pytest.raises(ValueError, match="backend='torch'"):
                online_mod.check_online(F, Q, L, LA, torch.float64, chunk)
    A = torch.ones((1, 4, 257))
    p = lws_torch.LWS(512, 128, device="cpu")
    with pytest.raises(ValueError, match="lane_skip"):
        online_mod.packed_rtisi_la(A, A, p._st_la, p._st_nofuture, p._st_af, [1.0],
                                   lane_skip=True)


@pytest.mark.parametrize("args,kw,period", [
    ((1024, 256), dict(mode="music"), 4),
    ((512, 128), dict(look_ahead=3), 4),
    ((4096, 512), dict(mode="music"), 8),
    ((256, 8), dict(L=3), 32),
    ((1000, 256), {}, 501),  # fsize % fshift != 0: fractional, per-bin weights
], ids=["LWS(1024, 256)", "LWS(512, 128)", "LWS(4096, 512)", "LWS(256, 8, L=3)",
        "LWS(1000, 256)"])
def test_weight_period(args, kw, period):
    """Summarized weights repeat with period Q in the bin index, bit for bit
    (every set, every tap); fractional ones do not, and the table then has
    one column per bin."""
    p = lws_torch.LWS(*args, device="cpu", **kw)
    sets = [p._st_nofuture, p._st_af, *p._st_la, p._st_batch]
    assert {st.period for st in sets} == {period}
    F = p.fftsize // 2 + 1
    if period < F:
        col = np.arange(F) % period
        for st in sets:
            assert np.array_equal(st.Wr.numpy()[..., col].view(np.int32),
                                  st.Wr.numpy().view(np.int32))
    else:
        st = p._st_af
        assert not np.array_equal(st.Wr.numpy()[..., np.arange(F) % p._Qi], st.Wr.numpy())
    wt = online_mod.online_weight_sets(p._st_la, p._st_nofuture, p._st_af)
    assert wt.period == period and wt.table.shape[1] == period


def test_weight_table_cached_with_the_stencils():
    """online_weights builds the table once per set of stencils; another
    set (another processor) gets its own."""
    p = lws_torch.LWS(512, 128, device="cpu")
    q = lws_torch.LWS(512, 128, device="cpu")
    a = online_mod.online_weights(p._st_la, p._st_nofuture, p._st_af)
    assert online_mod.online_weights(p._st_la, p._st_nofuture, p._st_af) is a
    b = online_mod.online_weights(q._st_la, q._st_nofuture, q._st_af)
    assert b is not a and torch.equal(b.table, a.table)


def _carried(st):
    return stencil_from_numpy(np.asarray(st.Wr), np.asarray(st.Wi), st.nz, st.Q, st.L,
                              device="cpu", dtype=torch.float64)


def test_plain_rtisi_la_matches_lws_tpu_q8():
    """LWS(4096, 512, mode="music") (Q = 8, F = 2049), which the previous
    kernels refused: the plain frame-commit loop against lws_tpu's frame
    scan, the same stencils carried across, float64, 3 frames of seeded
    random magnitudes and phases, 1 round. lws_tpu's scan runs eagerly
    (jax.disable_jit: compiling it at this width takes ~14 s on the CPU,
    running it ~4 s). Tolerance: test_torch_online.py's TOL_SCAN for
    jacobi (1e-5 x max amp)."""
    tp = lws_tpu.LWS(4096, 512, mode="music", dtype=jnp.float64)
    rng = np.random.default_rng(12)
    S = rng.uniform(0.1, 1.0, (1, 3, 2049)) * np.exp(2j * np.pi * rng.random((1, 3, 2049)))
    thr = lws_torch.get_thresholds(1, 1, 0.1, 1)
    with jax.disable_jit():
        jr, ji = jax_rtisi_la(jnp.asarray(S.real), jnp.asarray(S.imag), st_la=tp._st_la,
                              st_ai=tp._st_nofuture, st_af=tp._st_af,
                              thresholds=jnp.asarray(thr), inner_passes=tp.inner_passes,
                              inner_scheme=tp.inner_scheme)
        jr, ji = np.asarray(jr), np.asarray(ji)
    tr, ti = torch_rtisi_la(torch.tensor(S.real), torch.tensor(S.imag),
                            [_carried(s) for s in tp._st_la], _carried(tp._st_nofuture),
                            _carried(tp._st_af), torch.tensor(thr),
                            inner_passes=tp.inner_passes, inner_scheme=tp.inner_scheme)
    tol = 1e-5 * np.abs(S).max()
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=tol)
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=tol)
