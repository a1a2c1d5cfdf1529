"""lws_torch's numpy copies of windows.py / weights.py vs lws_tpu and the
reference goldens.

The port keeps its own copies (importing lws_tpu.windows would import
jax), so every output is held np.array_equal to lws_tpu's, and to the
goldens at tests/test_windows.py's tolerances.
"""
import numpy as np

import lws_torch
import lws_tpu


def test_windows_match_lws_tpu_and_golden(golden):
    fsize, fshift = int(golden.fsize), int(golden.fshift)
    awin = lws_torch.default_window(fsize, fshift)
    np.testing.assert_array_equal(awin, lws_tpu.default_window(fsize, fshift))
    np.testing.assert_allclose(awin, golden.awin, atol=1e-13)

    swin = lws_torch.synthwin(golden.awin, fshift)
    np.testing.assert_array_equal(swin, lws_tpu.synthwin(golden.awin, fshift))
    np.testing.assert_allclose(swin, golden.swin, atol=1e-13)

    prod = golden.awin * golden.swin
    ai, af = lws_torch.build_asymmetric_windows(prod, fshift)
    ai_j, af_j = lws_tpu.build_asymmetric_windows(prod, fshift)
    np.testing.assert_array_equal(ai, ai_j)
    np.testing.assert_array_equal(af, af_j)
    np.testing.assert_allclose(ai, golden.win_ai, atol=1e-13)
    np.testing.assert_allclose(af, golden.win_af, atol=1e-13)
    assert lws_torch.overlap_factor(fsize, fshift) == lws_tpu.overlap_factor(fsize, fshift)


def test_weights_match_lws_tpu_and_golden(golden):
    fshift, L = int(golden.fshift), int(golden.L)
    for name, win in (("W", golden.awin), ("W_ai", golden.win_ai),
                      ("W_af", golden.win_af)):
        W = lws_torch.create_weights(win, golden.swin, fshift, L)
        np.testing.assert_array_equal(
            W, lws_tpu.create_weights(win, golden.swin, fshift, L), err_msg=name)
        np.testing.assert_allclose(W, golden[name], atol=1e-12, err_msg=name)


def test_stencil_expansion_matches_lws_tpu(golden):
    F = golden.S.shape[-1]
    for name in ("W", "W_ai", "W_af"):
        np.testing.assert_array_equal(
            lws_torch.build_stencil(golden[name], F),
            lws_tpu.build_stencil(golden[name], F), err_msg=name)
    assert lws_torch.W_PRUNE_THRESHOLD == lws_tpu.W_PRUNE_THRESHOLD


def test_thresholds_and_hann_match_lws_tpu():
    for args in ((100, 100, 0.1, 1), (10, 1, 0.1, 1), (0, 1, 0.1, 1), (7, 3.0, 0.25, 1.5)):
        np.testing.assert_array_equal(lws_torch.get_thresholds(*args),
                                      lws_tpu.get_thresholds(*args))
    for n, kw in ((16, {}), (17, {"symmetric": False}),
                  (16, {"symmetric": False, "use_offset": True})):
        np.testing.assert_array_equal(lws_torch.hann(n, **kw), lws_tpu.hann(n, **kw))
