"""lws_torch.core.stencil vs lws_tpu.core.stencil and the single-bin goldens.

Float64 on the CPU. The single-bin goldens (tests/test_stencil_exact.py's
cases: exactly one bin above threshold, so it reads only old neighbours)
run here through the port's Gauss-Seidel `update_frame` on that bin's
frame, which checks every tap weight and index, DC / Nyquist margins and
time halos included.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
from conftest import _load
from lws_torch.convert import stencil_from_numpy
from lws_torch.core import stencil as tst
from lws_tpu import LWS as TpuLWS
from lws_tpu.core import stencil as jst

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


def _torch_stencil(golden, W, v):
    F = golden.S.shape[-1]
    Q, L = int(golden.Q), int(golden.L)
    return tst.make_stencil(lws_torch.build_stencil(W, F), Q, L, v=v,
                            device="cpu", dtype=torch.float64)


def test_make_stencil_exact_vs_lws_tpu(golden):
    F = golden.S.shape[-1]
    Q, L = int(golden.Q), int(golden.L)
    wst = lws_torch.build_stencil(golden.W, F)
    for v in (Q - 1, 0, -1):
        for tdt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
            t = tst.make_stencil(wst, Q, L, v=v, device="cpu", dtype=tdt)
            j = jst.make_stencil(wst, Q, L, v=v, dtype=jdt)
            np.testing.assert_array_equal(t.Wr.numpy(), np.asarray(j.Wr))
            np.testing.assert_array_equal(t.Wi.numpy(), np.asarray(j.Wi))
            np.testing.assert_array_equal(t.nz, j.nz)
            assert (t.Q, t.L, t.n_bins) == (j.Q, j.L, j.n_bins)


@pytest.mark.parametrize("name", ["q4", "frac"])
def test_stencil_from_numpy_equals_own(name):
    g = _load(name)
    tp = TpuLWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float32)
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), device="cpu")
    for theirs, mine in ((tp._st_batch, own._st_batch),
                         (tp._st_nofuture, own._st_nofuture)):
        conv = stencil_from_numpy(np.asarray(theirs.Wr), np.asarray(theirs.Wi),
                                  theirs.nz, theirs.Q, theirs.L, device="cpu")
        assert torch.equal(conv.Wr, mine.Wr) and torch.equal(conv.Wi, mine.Wi)
        np.testing.assert_array_equal(conv.nz, mine.nz)
        assert (conv.Q, conv.L) == (mine.Q, mine.L)


def _one_bin(golden, W, v, bm, bn):
    """Update frame bm with amp 0.5 everywhere and 2.0 at bin bn, thr 1."""
    sr, si = tst.split(golden.S, device="cpu")
    T, F = sr.shape
    Q, L = int(golden.Q), int(golden.L)
    st = _torch_stencil(golden, W, v)
    er, ei = tst.freq_extend(sr, si, L)
    top_r, bot_r = tst.make_time_halos(er, Q)
    top_i, bot_i = tst.make_time_halos(ei, Q)
    xr = tst.time_extend(er, top_r, bot_r)
    xi = tst.time_extend(ei, top_i, bot_i)
    amp_m = torch.full((F,), 0.5, dtype=torch.float64)
    amp_m[bn] = 2.0
    xr, xi = tst.update_frame(xr, xi, int(bm), amp_m, st, 1.0)
    row = xr[bm + Q - 1, L:L + F] + 1j * xi[bm + Q - 1, L:L + F]
    return row.numpy()


def test_single_bin_goldens(golden):
    Q = int(golden.Q)
    for i, (bm, bn) in enumerate(golden.sb_mn):
        got = _one_bin(golden, golden.W, Q - 1, bm, bn)
        np.testing.assert_allclose(got[bn], golden.sb_batch[i], rtol=1e-10, atol=1e-12,
                                   err_msg=f"batch single-bin {i} at ({bm},{bn})")
        untouched = np.delete(got, bn)
        np.testing.assert_array_equal(untouched, np.delete(golden.S[bm], bn))
        got = _one_bin(golden, golden.W_ai, -1, bm, bn)
        np.testing.assert_allclose(got[bn], golden.sb_nofuture[i], rtol=1e-10, atol=1e-12,
                                   err_msg=f"nofuture single-bin {i} at ({bm},{bn})")
    if "asym_cases" in golden:
        for (Mu, M0, bm, bn), val in zip(golden.asym_cases, golden.asym_vals):
            raw = int(M0) - int(bm)
            v = min(raw - 1, Q - 1) if raw >= 1 else -1
            got = _one_bin(golden, golden.W_af, v, bm, bn)
            np.testing.assert_allclose(got[bn], val, rtol=1e-10, atol=1e-12,
                                       err_msg=f"asym M={Mu} M0={M0} ({bm},{bn}) v={v}")


@pytest.mark.parametrize("scheme,passes", [("jacobi", 1), ("jacobi", 3), ("color2x3", 1)])
@pytest.mark.parametrize("name", ["q4", "q2"])
def test_update_frame_matches_lws_tpu(name, scheme, passes):
    """Several GS frame updates in a row, float64, random-phase state."""
    g = _load(name)
    Q, L = int(g.Q), int(g.L)
    rng = np.random.default_rng(3)
    A = np.abs(g.S)[:12]
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    st_t = _torch_stencil(g, g.W, Q - 1)
    st_j = jst.make_stencil(lws_torch.build_stencil(g.W, A.shape[-1]), Q, L, v=Q - 1,
                            dtype=jnp.float64)
    sr, si = S.real, S.imag
    er, ei = jst.freq_extend(jnp.asarray(sr), jnp.asarray(si), L)
    tr_, br_ = jst.make_time_halos(er, Q)
    ti_, bi_ = jst.make_time_halos(ei, Q)
    jr, ji = jst.time_extend(er, tr_, br_), jst.time_extend(ei, ti_, bi_)
    xr = torch.tensor(np.asarray(jr))
    xi = torch.tensor(np.asarray(ji))
    thr = 0.3 * A.mean()
    for m in range(A.shape[0]):
        amp_m = A[m]
        jr, ji = jst.update_frame(jr, ji, m, jnp.asarray(amp_m), st_j, thr, passes, scheme)
        tst.update_frame(xr, xi, m, torch.tensor(amp_m), st_t, thr, passes, scheme)
    np.testing.assert_allclose(xr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(xi.numpy(), np.asarray(ji), rtol=0, atol=1e-12)


def test_phase_update_and_freq_extend_match_lws_tpu():
    rng = np.random.default_rng(4)
    tr, ti, old_r, old_i = rng.standard_normal((4, 3, 33))
    tr[0, :5] = 0.0
    ti[0, :5] = 0.0  # a2 == 0: keep the old value
    amp = np.abs(rng.standard_normal((3, 33)))
    got = tst.phase_update(*(torch.tensor(a) for a in (tr, ti, amp, old_r, old_i)), 0.4)
    ref = jst.phase_update(*(jnp.asarray(a) for a in (tr, ti, amp, old_r, old_i)), 0.4)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=1e-15, atol=0)
    for L in (0, 2, 5):
        got = tst.freq_extend(torch.tensor(tr), torch.tensor(ti), L)
        ref = jst.freq_extend(jnp.asarray(tr), jnp.asarray(ti), L)
        for g_, r_ in zip(got, ref):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
