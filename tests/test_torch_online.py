"""The port's online stage (RTISI-LA) and music pipeline on the CPU, against
the reference goldens and lws_tpu, in float64.

The quality gates at the full schedules (10 online rounds, 100 batch
sweeps) run on q4, q2 and frac only (Q=4 jacobi, Q=2 color2x3, fractional
Q), as tests/test_torch_processor.py does, to stay inside the tier-1 time
budget. The CUDA kernel's own tests are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from conftest import _load
from lws_torch.convert import stencil_from_numpy
from lws_torch.core.online import rtisi_la as torch_rtisi_la
from lws_torch.entry import entry
from lws_torch.ops import online as online_mod
from lws_tpu.core.online import rtisi_la as jax_rtisi_la

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)

# max |port - lws_tpu| / max amp of rtisi_la from golden.nofuture_i1, 2
# rounds, float64 (port_tools/online_vs_reference.py, section scan): q4
# (jacobi) 7.5e-7, q2 (color2x3) 2.4e-15. Both are correct frame-commit
# loops that sum their taps in different orders; the one-bin-at-a-time
# recursion amplifies the float64 rounding differences along the commit
# chain, the jacobi stencil far more than color2x3.
TOL_SCAN = {"q4": 1e-5, "q2": 1e-12}


def _proc(g, **kw):
    return lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                         device="cpu", **kw)


def _tpu(g, **kw):
    return lws_tpu.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64, **kw)


def _carried(st):
    return stencil_from_numpy(np.asarray(st.Wr), np.asarray(st.Wi), st.nz, st.Q, st.L,
                              device="cpu", dtype=torch.float64)


def test_online_sparse_matches_golden(golden):
    """One active bin per frame: no in-frame order dependence, so the
    frame-commit sequencing must match the reference to float64 precision
    (the JAX test's own tolerance, tests/test_oracle.py:76-86)."""
    p = _proc(golden, look_ahead=2)
    out = p.online_lws(golden.online_sparse_in, thresholds=golden.online_sparse_thr)
    np.testing.assert_allclose(out, golden.online_sparse_out, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("name", ["q4", "q2"])
def test_plain_rtisi_la_matches_lws_tpu(name):
    """The plain frame-commit loop against lws_tpu's frame scan, the same
    stencils carried across, from golden.nofuture_i1 at 2 rounds. Tolerance
    TOL_SCAN (measured 7.5e-7 on q4, 2.4e-15 on q2; see its comment)."""
    g = _load(name)
    tp = _tpu(g)
    S = g.nofuture_i1.astype(np.complex128)
    thr = lws_torch.get_thresholds(2, 1, 0.1, 1)
    jr, ji = jax_rtisi_la(jnp.asarray(S.real), jnp.asarray(S.imag), st_la=tp._st_la,
                          st_ai=tp._st_nofuture, st_af=tp._st_af,
                          thresholds=jnp.asarray(thr), inner_passes=tp.inner_passes,
                          inner_scheme=tp.inner_scheme)
    tr, ti = torch_rtisi_la(torch.tensor(S.real), torch.tensor(S.imag),
                            [_carried(s) for s in tp._st_la], _carried(tp._st_nofuture),
                            _carried(tp._st_af), torch.tensor(thr),
                            inner_passes=tp.inner_passes, inner_scheme=tp.inner_scheme)
    tol = TOL_SCAN[name] * np.abs(S).max()
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=tol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=tol)


def test_online_stencils_match_lws_tpu(golden):
    t = _proc(golden)
    j = _tpu(golden)
    assert len(t._st_la) == len(j._st_la) == t.look_ahead
    for st_t, st_j in zip([t._st_af, *t._st_la], [j._st_af, *j._st_la]):
        np.testing.assert_array_equal(st_t.Wr.numpy(), np.asarray(st_j.Wr))
        np.testing.assert_array_equal(st_t.Wi.numpy(), np.asarray(st_j.Wi))
        np.testing.assert_array_equal(st_t.nz, st_j.nz)


def test_online_batched_items_match_single(golden_q4):
    g = golden_q4
    p = _proc(g)
    A = np.abs(g.S).astype(np.complex128)
    out_b = p.online_lws(np.stack([A, 0.3 * A]), iterations=2)
    np.testing.assert_allclose(out_b[0], p.online_lws(A, iterations=2), atol=1e-10)
    np.testing.assert_allclose(out_b[1], p.online_lws(0.3 * A, iterations=2), atol=1e-10)
    np.testing.assert_allclose(np.abs(out_b[1]), 0.3 * np.abs(A), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["q4", "q2", "frac"])
def test_music_pipeline_quality_parity(name):
    """mode="music" stage by stage: online (10 rounds) within 1.0 dB of the
    reference's online result, the whole pipeline within 0.4 dB of its
    run_lws result (tests/test_pipeline.py's gates), consistency never
    falling from stage to stage and rising through online and batch."""
    g = _load(name)
    p = _proc(g, mode="music")
    A = np.abs(g.S).astype(np.complex128)
    S0 = p.nofuture_lws(A)
    S1 = p.online_lws(S0)
    S2 = p.batch_lws(S1)
    c0, c1, c2, c3 = (float(p.get_consistency(s)) for s in (A, S0, S1, S2))
    assert c2 > float(g.consistency_online) - 1.0, (c2, float(g.consistency_online))
    assert c3 > float(g.consistency_run) - 0.4, (c3, float(g.consistency_run))
    assert c0 <= c1 < c2 < c3, (c0, c1, c2, c3)
    np.testing.assert_allclose(np.abs(S2), np.abs(A), rtol=1e-9, atol=1e-9)


def test_functional_api_matches_class_and_lws_tpu(golden_q4):
    """The free functions against the processor's methods (exact) and
    against lws_tpu's free functions (as tests/test_pipeline.py:132)."""
    g = golden_q4
    p = _proc(g)
    A = np.abs(g.S).astype(np.complex128)
    # live sweeps (at alpha=100 every bin sits under its threshold and the
    # output is the input) from random phases, where two correct tap orders
    # agree to rounding (as tests/test_torch_sweeps.py); the free functions
    # run one in-frame pass, so the class is built with inner_passes=1
    S_b = A * np.exp(2j * np.pi * np.random.default_rng(5).random(A.shape))
    thr = lws_torch.get_thresholds(3, 1, 0.1, 1)
    out_b = lws_torch.batch_lws(S_b, p.W, thr, device="cpu")
    np.testing.assert_allclose(
        out_b, _proc(g, inner_passes=1).batch_lws(S_b, thresholds=thr), atol=1e-12)
    np.testing.assert_allclose(out_b, np.asarray(lws_tpu.batch_lws(S_b, p.W, thr)),
                               rtol=0, atol=1e-9)
    assert np.abs(out_b - S_b).max() > 1e-3  # the sweeps changed the phases
    thr_nf = lws_torch.get_thresholds(1, 1, 0.1, 1)
    out_nf = lws_torch.nofuture_lws(A, p.W_ai, thr_nf, device="cpu")
    np.testing.assert_allclose(out_nf, p.nofuture_lws(A, iterations=1), atol=1e-12)
    np.testing.assert_allclose(out_nf, np.asarray(lws_tpu.nofuture_lws(A, p.W_ai, thr_nf)),
                               rtol=1e-5, atol=1e-6)
    # look-ahead 1 here (the processor's 3 is test_plain_rtisi_la_matches_lws_tpu's):
    # it halves lws_tpu's compile time
    S = g.nofuture_i1.astype(np.complex128)
    thr_on = lws_torch.get_thresholds(2, 1, 0.1, 1)
    out_on = lws_torch.online_lws(S, p.W, p.W_ai, p.W_af, thr_on, LA=1,
                                  fshift=int(g.fshift), device="cpu")
    np.testing.assert_allclose(out_on, _proc(g, look_ahead=1).online_lws(S, iterations=2),
                               atol=1e-12)
    ref_on = np.asarray(lws_tpu.online_lws(S, p.W, p.W_ai, p.W_af, thr_on, LA=1))
    np.testing.assert_allclose(out_on, ref_on, rtol=0, atol=TOL_SCAN["q4"] * np.abs(S).max())
    ext = lws_torch.extspec(A, int(g.L), int(g.Q), device="cpu")
    np.testing.assert_array_equal(ext, np.asarray(lws_tpu.extspec(A, int(g.L), int(g.Q))))


def test_entry_runs_on_cpu():
    fn, args = entry(device="cpu")
    sr, si = fn(*args)
    assert sr.shape == si.shape == (2, 24, 257)
    assert bool(torch.isfinite(sr).all() and torch.isfinite(si).all())
    np.testing.assert_allclose(torch.sqrt(sr * sr + si * si).numpy(), args[0].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_online_wrapper_checks(golden_q4):
    """The wrapper's CPU path is the plain loop; the TPU lane skip raises;
    the fit gate takes Q = 8 at F = 2049 and look-ahead past lws_tpu's 8;
    the weight table lists every live tap once, in the kernels' order, with
    the stencils' own values."""
    p = _proc(golden_q4)
    A = torch.tensor(np.abs(golden_q4.S))
    thr = torch.tensor(lws_torch.get_thresholds(1, 1, 0.1, 1))
    args = (A, torch.zeros_like(A), p._st_la, p._st_nofuture, p._st_af, thr)
    kr, ki = online_mod.packed_rtisi_la(*args)
    pr, pi = torch_rtisi_la(*args)
    assert torch.equal(kr, pr) and torch.equal(ki, pi)
    with pytest.raises(ValueError, match="lane_skip"):
        online_mod.packed_rtisi_la(*args, lane_skip=True)
    assert online_mod.online_supported(513, 4, 5, 3)
    assert online_mod.online_supported(2049, 8, 5, 3)  # LWS(4096, 512, mode="music")
    assert online_mod.online_supported(257, 4, 5, 10)
    wt = online_mod.online_weight_sets(p._st_la, p._st_nofuture, p._st_af)
    sets = [p._st_nofuture, p._st_af, *p._st_la]
    assert wt.period == 4 and wt.table.shape == (sum(int(st.nz.sum()) for st in sets), 4, 2)
    # every live tap is listed once, each set's off-centre rows in dr order,
    # then its centre row (dr = 3), each row's live dk in order
    g = 0
    for s, st in enumerate(sets):
        n_off, n_cen = wt.counts[s]
        assert n_off + n_cen == st.nz.sum() and n_cen == st.nz[3].sum()
        for dr in [0, 1, 2, 4, 5, 6, 3]:
            mask, first, count = (int(v) for v in wt.rows[s, dr])
            live = np.flatnonzero(st.nz[dr])
            assert (first, count) == (g, live.size)
            assert mask == sum(1 << int(dk) for dk in live)
            assert wt.dks[first:first + count].tolist() == live.tolist()
            for part, plane in ((0, st.Wr), (1, st.Wi)):
                assert torch.equal(wt.table[first:first + count, :, part],
                                   plane[dr][torch.as_tensor(live)][:, :4])
            g += count
