"""lws_torch.LWS (the batch and no-future stages) vs the reference goldens
and lws_tpu.LWS, on the CPU in float64 (the online stage and the music
pipeline: tests/test_torch_online.py).

batch_lws at 100 sweeps runs on q4, q2 and frac (one golden per in-frame
scheme and weight kind: Q=4 ip3 jacobi, Q=2 color2x3, fractional Q), which
keeps these tests inside the tier-1 time budget.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from conftest import _load

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


def _proc(g, **kw):
    return lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                         device="cpu", **kw)


def test_nofuture_matches_golden(golden):
    p = _proc(golden)
    A = np.abs(golden.S).astype(np.complex128)
    out = p.nofuture_lws(A, thresholds=lws_torch.get_thresholds(1, 1, 0.1, 1))
    ref = golden.nofuture_i1_anyq.astype(np.complex128)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["q4", "q2", "frac"])
def test_batch_quality_parity(name):
    g = _load(name)
    p = _proc(g)
    A = np.abs(g.S).astype(np.complex128)
    out = p.batch_lws(A, thresholds=lws_torch.get_thresholds(100, 100, 0.1, 1))
    c = float(p.get_consistency(out))
    ref_c = float(g.consistency_batch)
    assert c > ref_c - 0.5, f"batch consistency {c:.2f} dB vs reference {ref_c:.2f} dB"
    np.testing.assert_allclose(np.abs(out), np.abs(A), rtol=1e-9, atol=1e-9)


def test_inner_defaults_match_lws_tpu(golden):
    for kw in ({}, {"inner_passes": 2}, {"inner_scheme": "jacobi"}):
        t = _proc(golden, **kw)
        j = lws_tpu.LWS(int(golden.fsize), int(golden.fshift), L=int(golden.L),
                        dtype=jnp.float64, **kw)
        assert (t.inner_scheme, t.inner_passes, t.batch_inner_passes, t.Q, t._Qi) == \
            (j.inner_scheme, j.inner_passes, j.batch_inner_passes, j.Q, j._Qi)
        np.testing.assert_array_equal(t.W_ai, j.W_ai)
        np.testing.assert_array_equal(t.swin, j.swin)


def test_whole_slice_matches_lws_tpu(golden_q4):
    """stft -> run_lws -> get_consistency -> istft, float64, default
    schedule (no-future 0, batch 100 sweeps at alpha=100, ip3)."""
    g = golden_q4
    t = _proc(g, nofuture_iterations=1)
    j = lws_tpu.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
                    nofuture_iterations=1)
    X_t = t.stft(g.x)
    X_j = np.asarray(j.stft(g.x))
    np.testing.assert_allclose(X_t, X_j, rtol=0, atol=1e-10)
    out_t = t.run_lws(np.abs(X_t))
    out_j = np.asarray(j.run_lws(np.abs(X_j)))
    c_t = float(t.get_consistency(out_t))
    c_j = float(j.get_consistency(out_j))
    assert abs(c_t - c_j) < 0.05, (c_t, c_j)
    y_t = t.istft(out_t)
    y_j = np.asarray(j.istft(out_j))
    assert y_t.shape == y_j.shape and np.isfinite(y_t).all()
    # pair in, pair out on the device, same values as the complex path
    pair = t.run_lws((torch.tensor(np.abs(X_t)), torch.zeros(X_t.shape, dtype=torch.float64)))
    assert isinstance(pair, tuple) and torch.is_tensor(pair[0])
    np.testing.assert_array_equal(lws_torch.merge(*pair), out_t)


def test_batched_items_match_single(golden_q4):
    g = golden_q4
    p = _proc(g)
    A1 = np.abs(g.S).astype(np.complex128)
    thr = lws_torch.get_thresholds(5, 100, 0.1, 1)
    out_b = p.batch_lws(np.stack([A1, 0.5 * A1]), thresholds=thr)
    np.testing.assert_allclose(out_b[0], p.batch_lws(A1, thresholds=thr), atol=1e-10)
    np.testing.assert_allclose(out_b[1], p.batch_lws(0.5 * A1, thresholds=thr), atol=1e-10)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lws_torch.LWS(512, 128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lws_torch.stft(np.zeros(1000), 512, 128, np.ones(512))


def test_unported_paths_raise_with_roadmap_item(golden_q4):
    # the online stage (A7) is ported: these construct as in lws_tpu
    for kw in ({"mode": "music"}, {"online_iterations": 3}):
        t = lws_torch.LWS(512, 128, device="cpu", **kw)
        j = lws_tpu.LWS(512, 128, **kw)
        assert (t.nofuture_iterations, t.online_iterations) == \
            (j.nofuture_iterations, j.online_iterations)
    # the Jacobi orders (A12) are ported: they construct; an unknown order raises
    assert lws_torch.LWS(512, 128, order="jacobi", device="cpu").order == "jacobi"
    with pytest.raises(ValueError, match="order"):
        lws_torch.LWS(512, 128, order="bogus", device="cpu")
    p = _proc(golden_q4)
    A = np.abs(golden_q4.S)
    # the device meshes (A14) are ported: a mesh of one rank needs no
    # process group, and its sweeps equal the unsharded ones (amp is
    # retaken each sweep, so to 1e-12); tests/test_torch_parallel.py has the rest
    from lws_torch.parallel import make_mesh
    np.testing.assert_allclose(p.batch_lws(A, 3, mesh=make_mesh(1, 1, device="cpu")),
                               p.batch_lws(A, 3), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="non-negative"):
        p.batch_lws(np.ones((4, 256)))
    with pytest.raises(TypeError):
        lws_torch.LWS(512, 128, device="cpu", pallas_pack=16)


def test_import_leaves_out_jax_and_lws_tpu():
    code = ("import sys, lws_torch, lws_torch.ops, lws_torch.convert, lws_torch.functional, "
            "lws_torch.entry, lws_torch.core.online, lws_torch.ops.online, lws_torch.streaming, "
            "lws_torch.ops.segmented, lws_torch.ops.packed, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lws_tpu')); print(bad); sys.exit(1 if bad else 0)")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
