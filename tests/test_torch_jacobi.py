"""The Jacobi sweep orders (order="jacobi", "jacobi_mxu") of lws_torch
against lws_tpu's, on the CPU in float64.

lws_tpu runs these orders in XLA only (its Pallas kernels take "gs"); the
port runs them in plain PyTorch on every device: whole-grid tap sums
(core.stencil.apply_stencil) or the same sums as banded matmuls
(apply_stencil_mxu, Stencil.band_mats). Same inputs, made from a numpy
seed, go through both packages; the port must agree to 1e-9 (the two sum
the taps in the same order; the MXU form differs only by the matmul's
accumulation order), for the batch and no-future stencils, fractional Q
(per-bin weights), halo= / mean_amp=, the processor (macro chunks
included) and the free functions. Then the precision= plumbing and its
warnings.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from lws_torch.core import batch as tbatch
from lws_torch.core.stencil import matmul_precision
from lws_tpu.core.batch import lws_sweeps as jax_sweeps

torch.set_num_threads(1)

ORDERS = ("jacobi", "jacobi_mxu")
TOL = 1e-9


def _procs(fsize, fshift, **kw):
    return (lws_tpu.LWS(fsize, fshift, dtype=jnp.float64, **kw),
            lws_torch.LWS(fsize, fshift, dtype=torch.float64, device="cpu", **kw))


def _spec(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _both(S, st_j, st_t, thr, order, **kw):
    """lws_tpu's and the port's lws_sweeps on the same complex input."""
    kw_j = {k: (tuple(jnp.asarray(h) for h in v) if isinstance(v, tuple) else jnp.asarray(v))
            for k, v in kw.items()}
    kw_t = {k: (tuple(torch.tensor(h) for h in v) if isinstance(v, tuple) else torch.tensor(v))
            for k, v in kw.items()}
    a = jax_sweeps(jnp.asarray(S.real), jnp.asarray(S.imag), st_j, jnp.asarray(thr),
                   order=order, precision="highest", **kw_j)
    b = tbatch.lws_sweeps(torch.tensor(S.real), torch.tensor(S.imag), st_t, thr,
                          order=order, **kw_t)
    return (np.asarray(a[0]) + 1j * np.asarray(a[1]), b[0].numpy() + 1j * b[1].numpy())


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("stage", ["batch", "nofuture"])
def test_sweeps_match_lws_tpu(stage, order):
    j, t = _procs(512, 128)
    attr = "_st_batch" if stage == "batch" else "_st_nofuture"
    S = _spec(0, (2, 30, 257))
    a, b = _both(S, getattr(j, attr), getattr(t, attr), lws_tpu.get_thresholds(4, 1, 0.1, 1),
                 order)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    assert np.abs(b - S).max() > 0.1  # the sweeps moved the phases


@pytest.mark.parametrize("order", ORDERS)
def test_fractional_q_matches_lws_tpu(order):
    """LWS(500, 160): fractional Q, per-bin weight rows, so the band
    matrices must be built per bin."""
    j, t = _procs(500, 160)
    S = _spec(1, (2, 24, t._st_batch.n_bins))
    a, b = _both(S, j._st_batch, t._st_batch, lws_tpu.get_thresholds(4, 1, 0.1, 1), order)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)


@pytest.mark.parametrize("geometry", [(512, 128, "batch"), (512, 128, "nofuture"),
                                      (500, 160, "batch")])
def test_mxu_matches_elementwise(geometry):
    """The port's banded-matmul form against its elementwise form."""
    fsize, fshift, stage = geometry
    t = lws_torch.LWS(fsize, fshift, dtype=torch.float64, device="cpu")
    st = t._st_batch if stage == "batch" else t._st_nofuture
    S = _spec(2, (2, 30, st.n_bins))
    thr = lws_torch.get_thresholds(5, 1, 0.1, 1)
    sr, si = torch.tensor(S.real), torch.tensor(S.imag)
    a = tbatch.lws_sweeps(sr, si, st, thr, order="jacobi")
    b = tbatch.lws_sweeps(sr, si, st, thr, order="jacobi_mxu")
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=TOL)


def test_band_mats_layout_and_cache():
    """M[dr, n+dk, n] = W[dr, dk, n] in the stencil's dtype and device,
    built once per stencil."""
    t = lws_torch.LWS(500, 160, dtype=torch.float64, device="cpu")
    st = t._st_batch
    Mr, Mi = st.band_mats()
    assert st.band_mats()[0] is Mr
    F, L = st.n_bins, st.L
    assert Mr.shape == (2 * st.Q - 1, F + 2 * L, F) and Mr.dtype == torch.float64
    n = np.arange(F)
    for dr in range(2 * st.Q - 1):
        for dk in range(2 * L + 1):
            np.testing.assert_array_equal(Mr[dr, n + dk, n].numpy(), st.Wr[dr, dk].numpy())
            np.testing.assert_array_equal(Mi[dr, n + dk, n].numpy(), st.Wi[dr, dk].numpy())
    assert int((Mr != 0).sum()) == int((st.Wr != 0).sum())


@pytest.mark.parametrize("order", ORDERS)
def test_halo_and_mean_amp_match_lws_tpu(order):
    j, t = _procs(512, 128)
    rng = np.random.default_rng(3)
    S = _spec(3, (2, 20, 257))
    halo = tuple(rng.standard_normal((2, 3, 257)) for _ in range(4))
    mean = rng.uniform(0.5, 2.0, 2)
    a, b = _both(S, j._st_batch, t._st_batch, lws_tpu.get_thresholds(3, 1, 0.1, 1), order,
                 halo=halo, mean_amp=mean)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    # and they matter: without them the result differs
    a0, _ = _both(S, j._st_batch, t._st_batch, lws_tpu.get_thresholds(3, 1, 0.1, 1), order)
    assert np.abs(a0 - a).max() > 1e-3


def _signal(seconds=1.0, sr_hz=16000):
    rng = np.random.default_rng(4)
    t = np.arange(int(seconds * sr_hz)) / sr_hz
    return 0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)


@pytest.mark.parametrize("order", ORDERS)
def test_processor_matches_lws_tpu(order):
    """LWS(order=...).batch_lws and nofuture_lws (the processor's own
    thresholds) against lws_tpu's processor, and the magnitudes kept."""
    j, t = _procs(512, 128, order=order, precision="highest", batch_iterations=10,
                  nofuture_iterations=2)
    A = np.abs(t.stft(_signal())).astype(np.complex128)
    for stage in ("batch_lws", "nofuture_lws"):
        want = np.asarray(getattr(j, stage)(A))
        got = getattr(t, stage)(A)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        np.testing.assert_allclose(np.abs(got), np.abs(A), rtol=1e-9, atol=1e-12)
    out = t.batch_lws(A, thresholds=lws_torch.get_thresholds(20, 1, 0.1, 1))
    assert float(t.get_consistency(out)) > float(t.get_consistency(A)) + 5


@pytest.mark.parametrize("order", ORDERS)
def test_processor_macro_chunks_match_lws_tpu(order):
    """Past _MACRO_T frames the Jacobi orders run in macro chunks with
    frozen real-neighbour halos and the whole signal's mean, as lws_tpu's
    _macro_sweeps does (here at a small _MACRO_T on both)."""
    j, t = _procs(512, 128, order=order, precision="highest")
    for p in (j, t):
        p._MACRO_T, p._MACRO_CHUNK = 40, 25
    S = _spec(5, (1, 90, 257))
    thr = lws_torch.get_thresholds(3, 1, 0.1, 1)
    want = np.asarray(j.batch_lws(S, thresholds=thr))
    got = t.batch_lws(S, thresholds=thr)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    whole = lws_torch.LWS(512, 128, order=order, dtype=torch.float64, device="cpu")
    assert np.abs(whole.batch_lws(S, thresholds=thr) - got).max() > 1e-6  # seams exist


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("fn", ["batch_lws", "nofuture_lws"])
def test_free_functions_match_lws_tpu(fn, order):
    t = lws_torch.LWS(512, 128, device="cpu")
    A = np.abs(t.stft(_signal(0.5))).astype(np.complex128)
    thr = lws_torch.get_thresholds(4, 10, 0.1, 1)
    want = np.asarray(getattr(lws_tpu, fn)(A, t.W if fn == "batch_lws" else t.W_ai, thr,
                                            order=order))
    got = getattr(lws_torch, fn)(A, t.W if fn == "batch_lws" else t.W_ai, thr, order=order,
                                 device="cpu")
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_unknown_order_raises():
    with pytest.raises(ValueError, match="order"):
        lws_torch.LWS(512, 128, order="red-black", device="cpu")
    t = lws_torch.LWS(512, 128, device="cpu")
    A = np.ones((4, 257), np.complex128)
    with pytest.raises(ValueError, match="order"):
        lws_torch.batch_lws(A, t.W, [1.0], order="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown sweep order"):
        tbatch.lws_sweeps(torch.ones(4, 257), torch.zeros(4, 257), t._st_batch, [1.0],
                          order="bogus")


def test_precision_reaches_the_sweeps(monkeypatch):
    """LWS(precision=...) reaches lws_sweeps for both sweep stages; the
    online stage ignores the order, as lws_tpu's does."""
    import lws_torch.processor as procmod
    calls = []
    real = procmod.lws_sweeps

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(procmod, "lws_sweeps", spy)
    t = lws_torch.LWS(512, 128, order="jacobi_mxu", precision="highest", device="cpu",
                      nofuture_iterations=1, online_iterations=1, batch_iterations=2,
                      look_ahead=1)
    A = np.abs(_spec(6, (8, 257))).astype(np.complex64)
    t.run_lws(A)
    assert [(c["order"], c["precision"]) for c in calls] == [("jacobi_mxu", "highest")] * 2


def test_matmul_precision_is_local():
    """On CUDA "high" allows TF32 inside the block and the caller's setting
    comes back after it, also when the block raises; the CPU is never
    changed. (torch's setting is readable without a card.)"""
    before = torch.get_float32_matmul_precision()
    with matmul_precision(torch.device("cpu"), "high"):
        assert torch.get_float32_matmul_precision() == before
    cuda = torch.device("cuda")
    for prec, want in ((None, "highest"), ("highest", "highest"), ("high", "high")):
        with matmul_precision(cuda, prec):
            assert torch.get_float32_matmul_precision() == want
        assert torch.get_float32_matmul_precision() == before
    with pytest.raises(RuntimeError, match="inside"):
        with matmul_precision(cuda, "high"):
            raise RuntimeError("inside")
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError, match="precision"):
        with matmul_precision(cuda, "bfloat16"):
            pass


def test_reduced_precision_warns():
    with pytest.warns(UserWarning, match="TF32"):
        lws_torch.LWS(512, 128, order="jacobi_mxu", precision="high", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        lws_torch.LWS(512, 128, order="jacobi_mxu", precision="default", device="cpu")


@pytest.mark.parametrize("precision", [None, "highest"])
def test_full_precision_does_not_warn(precision):
    """None is full float32 on CUDA (TF32 off, PyTorch's default), so unlike
    lws_tpu the port does not warn at the default."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lws_torch.LWS(512, 128, order="jacobi_mxu", precision=precision, device="cpu")
