"""lws_torch.stft vs the reference goldens (tests/test_stft.py's
tolerances) and vs lws_tpu.stft in float64 (1e-10), on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from lws_torch.stft import CONSISTENCY_BLOCK, LONGFORM_BLOCK, frame_signal, overlap_add

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


def test_stft_istft_match_golden_and_lws_tpu(golden):
    fsize, fshift = int(golden.fsize), int(golden.fshift)
    S = lws_torch.stft(golden.x, fsize, fshift, golden.awin, perfectrec=True, device="cpu")
    assert S.shape == golden.S.shape
    np.testing.assert_allclose(S, golden.S, atol=1e-9)
    S_j = np.asarray(lws_tpu.stft(jnp.asarray(golden.x), fsize, fshift, golden.awin,
                                  perfectrec=True))
    np.testing.assert_allclose(S, S_j, rtol=0, atol=1e-10)

    y = lws_torch.istft(golden.S, fshift, golden.swin, perfectrec=True, device="cpu")
    np.testing.assert_allclose(y, golden.istft_S, atol=1e-9)
    y_j = np.asarray(lws_tpu.istft(jnp.asarray(golden.S), fshift, golden.swin,
                                   perfectrec=True))
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-10)
    n = min(len(y), len(golden.x))  # perfect reconstruction of the round trip
    y2 = lws_torch.istft(S, fshift, golden.swin, perfectrec=True, device="cpu")
    np.testing.assert_allclose(y2[:n], golden.x[:n], atol=1e-10)


def test_consistency_matches_golden_and_lws_tpu(golden):
    args = (int(golden.fsize), int(golden.fshift), golden.awin, golden.swin)
    c = float(lws_torch.get_consistency(golden.S, *args, perfectrec=True, device="cpu"))
    if float(golden.consistency_S) > 250:  # rounding-noise regime, as test_stft
        assert c > 250
    else:
        np.testing.assert_allclose(c, float(golden.consistency_S), atol=1e-4)
    A = np.abs(golden.S).astype(np.complex128)
    cA = float(lws_torch.get_consistency(A, *args, perfectrec=True, device="cpu"))
    np.testing.assert_allclose(cA, float(golden.consistency_A), atol=1e-4)
    cA_j = float(lws_tpu.get_consistency(jnp.asarray(A), *args, perfectrec=True))
    np.testing.assert_allclose(cA, cA_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("perfectrec", [True, False])
def test_batched_layouts_match_lws_tpu(perfectrec):
    """Leading batch dims, perfectrec on/off, framepadding, a fractional hop."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 1000))
    for fsize, fshift in ((256, 128), (500, 160)):
        awin = np.hanning(fsize)
        for fp in (False, True):
            kw = dict(perfectrec=perfectrec, framepadding=fp)
            S = lws_torch.stft(x, fsize, fshift, awin, device="cpu", **kw)
            S_j = np.asarray(lws_tpu.stft(jnp.asarray(x), fsize, fshift, awin, **kw))
            assert S.shape == S_j.shape
            np.testing.assert_allclose(S, S_j, rtol=0, atol=1e-10)
        y = lws_torch.istft(S, fshift, awin, awin=awin, perfectrec=perfectrec, device="cpu")
        y_j = np.asarray(lws_tpu.istft(S_j, fshift, awin, awin=awin, perfectrec=perfectrec))
        np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-10)
        c = lws_torch.get_consistency(S, fsize, fshift, awin, awin, perfectrec=perfectrec,
                                      device="cpu")
        assert c.shape == (2, 3)


def test_ri_functions_stay_on_tensor_device():
    import torch
    x = torch.randn(2, 4000, dtype=torch.float64)
    awin = np.hanning(256)
    sr, si = lws_torch.stft_ri(x, 256, 128, awin, perfectrec=True)
    assert isinstance(sr, torch.Tensor) and sr.dtype == torch.float64 and sr.shape[-1] == 129
    y = lws_torch.istft_ri(sr, si, 128, awin, awin=awin, perfectrec=True)
    np.testing.assert_allclose(y.numpy()[:, :4000], x.numpy(), atol=1e-10)
    c = lws_torch.get_consistency_ri(sr, si, 256, 128, awin,
                                     lws_torch.synthwin(awin, 128), perfectrec=True)
    assert c.shape == (2,) and bool((c > 250).all())


def test_frame_signal_overlap_add_roundtrip():
    import torch
    rng = np.random.default_rng(7)
    for fsize, fshift in [(512, 128), (500, 160), (256, 256)]:
        M = 11
        n = (M - 1) * fshift + fsize
        x = rng.standard_normal(n)
        frames = frame_signal(torch.tensor(x), fsize, fshift, M)
        np.testing.assert_array_equal(frames[3].numpy(), x[3 * fshift:3 * fshift + fsize])
        y = overlap_add(frames, fshift).numpy()[:n]
        t = np.arange(n)
        cover = (np.minimum(t // fshift, M - 1)
                 - np.maximum(0, (t - fsize) // fshift + 1) + 1)
        np.testing.assert_allclose(y, x * cover, rtol=1e-12, atol=1e-12)


def test_long_inputs_take_the_blocked_paths():
    """Past CONSISTENCY_BLOCK frames the consistency metric, past
    LONGFORM_BLOCK the stft and istft switch to the blocked paths on their
    own (lws_tpu's limits), and agree with the one-shot functions (float64,
    a 5-bin spectrum to stay small)."""
    import importlib

    import torch
    mod = importlib.import_module("lws_torch.stft")  # lws_torch.stft is the function
    rng = np.random.default_rng(3)
    fsize, fshift = 8, 4
    awin = np.hanning(fsize)
    swin = lws_torch.synthwin(awin, fshift)
    sr, si = (torch.tensor(rng.standard_normal((CONSISTENCY_BLOCK + 1, 5))) for _ in range(2))
    c = lws_torch.get_consistency_ri(sr, si, fsize, fshift, awin, swin, perfectrec=True)
    c1 = mod._consistency(sr, si, torch.tensor(awin), torch.tensor(swin), fsize, fshift,
                          fsize, True)
    np.testing.assert_allclose(c.numpy(), c1.numpy(), rtol=0, atol=1e-9)
    x = torch.tensor(rng.standard_normal(fshift * (LONGFORM_BLOCK + 1)))
    br, bi = lws_torch.stft_ri(x, fsize, fshift, awin, perfectrec=True)
    assert br.shape[-2] > LONGFORM_BLOCK
    o = mod._stft(x, torch.tensor(awin), fsize, fshift, fsize, True)
    assert torch.equal(br, o[0]) and torch.equal(bi, o[1])
    y = lws_torch.istft_ri(br, bi, fshift, awin, awin=awin, perfectrec=True)
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="non-negative"):
        lws_torch.istft_ri(sr[:, :4], sr[:, :4], 4, np.ones(8))
