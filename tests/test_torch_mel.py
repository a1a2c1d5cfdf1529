"""lws_torch.mel against lws_tpu.mel, on the CPU in float64.

The filterbank is the port's copy of lws_tpu's numpy code and must equal
it bit for bit (Slaney and HTK scales, both norms, fmin / fmax). The
projections are one matmul each; the port's (torch) and lws_tpu's (XLA)
sum the bins in their own BLAS order, so they agree to a few ulps, not bit
for bit. mel_vocoder_pipeline runs the processor's 3-stage run_lws from
zero phase, where a few ulps of difference in the magnitudes grow along the
online stage's commit chain, so the pipeline is compared by consistency,
as tests/test_torch_processor.py compares the whole slice.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu.mel as jmel
from lws_tpu import LWS as JLWS
from lws_torch import mel as tmel

torch.set_num_threads(1)


@pytest.mark.parametrize("args", [
    (80, 1024, 16000),
    (80, 2048, 22050),
    (40, 512, 16000, 0.0, None, True, None),
    (64, 1024, 16000, 100.0, 7000.0, True, "slaney"),
    (128, 4096, 48000, 30.0, 20000.0, False, None),
])
def test_filterbank_bit_equal(args):
    a, b = jmel.mel_filterbank(*args), tmel.mel_filterbank(*args)
    assert b.dtype == np.float64 and b.shape == a.shape
    np.testing.assert_array_equal(b, a)


def test_filterbank_shape_and_coverage():
    fb = tmel.mel_filterbank(80, 1024, 16000)
    assert fb.shape == (80, 513) and np.all(fb >= 0)
    assert np.all(fb.sum(axis=1) > 0)
    assert np.all(fb.sum(axis=0)[5:-5] > 0)


def test_filterbank_htk_monotone_centres():
    fb = tmel.mel_filterbank(40, 512, 16000, htk=True, norm=None)
    assert np.all(np.diff(fb.argmax(axis=1)) >= 1)


def test_projections_match_lws_tpu():
    rng = np.random.default_rng(0)
    fb = tmel.mel_filterbank(80, 1024, 16000)
    spec = np.abs(rng.standard_normal((3, 40, 513)))
    want = np.asarray(jmel.linear_to_mel(spec, fb))
    got = tmel.linear_to_mel(spec, fb, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (3, 40, 80)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    want_lin = np.asarray(jmel.mel_to_linear(want, fb))
    got_lin = tmel.mel_to_linear(want, fb, device="cpu")
    np.testing.assert_allclose(got_lin.numpy(), want_lin, rtol=0,
                               atol=1e-14 * np.abs(want_lin).max())
    assert got_lin.min() >= 1e-10  # the eps clamp


def test_round_trip_smooth_spectrum():
    """Projection + pinv inversion approximately recovers smooth spectra
    (tests/test_mel.py's bound)."""
    fb = tmel.mel_filterbank(80, 1024, 16000)
    bins = np.arange(513)
    spec = np.stack([np.exp(-((bins - c) / 90.0) ** 2) + 0.1 for c in (60, 150, 300)])
    rec = tmel.mel_to_linear(tmel.linear_to_mel(spec, fb, device="cpu"), fb).numpy()
    assert np.abs(rec - spec)[:, 10:-10].mean() < 0.08


def test_pinv_cache_and_devices():
    """The pinv is cached on the filterbank's bytes (a copy hits, another
    filterbank misses); tensors keep their device and dtype; numpy input
    goes to `device`, CUDA unless named, which raises here."""
    fb = tmel.mel_filterbank(20, 256, 8000)
    mel = torch.rand(2, 5, 20, dtype=torch.float32)
    n0 = len(tmel._PINV_CACHE)
    a = tmel.mel_to_linear(mel, fb)
    tmel.mel_to_linear(mel, fb.copy())
    assert len(tmel._PINV_CACHE) == n0 + 1
    tmel.mel_to_linear(mel, tmel.mel_filterbank(20, 256, 8000, htk=True))
    assert len(tmel._PINV_CACHE) == n0 + 2
    assert a.dtype == torch.float32 and a.shape == (2, 5, 129)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmel.linear_to_mel(np.ones((3, 129)), fb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pinv_built_and_uploaded_once(dtype):
    """Two calls on one filterbank build its pinv once and put it on the
    data's device once, and give what the pinv applied afresh on every call
    gives, bit for bit: the matmul by its transpose, clamped at eps."""
    fb = tmel.mel_filterbank(24, 320, 11025, fmin=37.0 if dtype == torch.float32 else 41.0)
    mel = torch.rand(3, 7, 24, dtype=dtype, generator=torch.Generator().manual_seed(1))
    builds, uploads = tmel.PINV_BUILDS, tmel.PINV_UPLOADS
    got = [tmel.mel_to_linear(mel, fb), tmel.mel_to_linear(mel * 0.5, fb.copy())]
    assert (tmel.PINV_BUILDS, tmel.PINV_UPLOADS) == (builds + 1, uploads + 1)
    for m, g in zip((mel, mel * 0.5), got):
        want = torch.clamp_min(m @ torch.as_tensor(np.linalg.pinv(fb).T).to("cpu", dtype),
                               1e-10)
        assert g.dtype == dtype and torch.equal(g, want)


def test_mel_vocoder_pipeline_matches_lws_tpu(golden_q4):
    """tests/test_mel.py's pipeline: 80-band mel -> linear -> 3-stage LWS
    (no-future 1, online 2, batch 10) -> waveform, a batch of two, in both
    packages."""
    g = golden_q4
    kw = dict(L=int(g.L), nofuture_iterations=1, online_iterations=2, batch_iterations=10)
    j = JLWS(int(g.fsize), int(g.fshift), dtype=jnp.float64, **kw)
    t = lws_torch.LWS(int(g.fsize), int(g.fshift), dtype=torch.float64, device="cpu", **kw)
    fb = tmel.mel_filterbank(80, t.fftsize, 16000)
    mel = np.asarray(jmel.linear_to_mel(np.abs(np.asarray(g.S)), fb))
    mel_b = np.stack([mel, mel * 0.5])

    y = tmel.mel_vocoder_pipeline(mel_b, t, fb=fb)
    y_j = np.asarray(jmel.mel_vocoder_pipeline(mel_b, j, fb=fb))
    assert y.shape == y_j.shape and torch.isfinite(y).all() and y.abs().max() > 0

    pair = tmel.mel_vocoder_pipeline(mel_b, t, fb=fb, return_spec=True)
    lin = tmel.mel_to_linear(mel_b, fb, device="cpu")
    np.testing.assert_allclose(torch.hypot(*pair).numpy(), lin.numpy(), rtol=1e-12)
    assert torch.equal(pair[0], t.run_lws((lin, torch.zeros_like(lin)))[0])
    c = t.get_consistency(pair).numpy()
    c0 = t.get_consistency((lin, torch.zeros_like(lin))).numpy()
    assert np.all(c > c0 + 5), (c, c0)
    c_j = np.asarray(j.get_consistency(jmel.mel_vocoder_pipeline(mel_b, j, fb=fb,
                                                                 return_spec=True)))
    assert abs(c.mean() - c_j.mean()) < 0.1, (c, c_j)
    # the sample rate's own filterbank
    y2 = tmel.mel_vocoder_pipeline(torch.tensor(mel_b), t, sample_rate=16000)
    assert torch.equal(y2, y)
    with pytest.raises(ValueError, match="fb or sample_rate"):
        tmel.mel_vocoder_pipeline(mel_b, t)
