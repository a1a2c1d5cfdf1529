"""The grouped sweeps (K5's plain path, lws_torch.core.batch.packed_sweeps,
and its wrapper lws_torch.ops.packed) on the CPU, against lws_tpu's
packed_lws_sweeps. The kernel's own cases are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from lws_torch.core.batch import lws_sweeps as plain_sweeps
from lws_torch.core.batch import packed_sweeps
from lws_torch.ops import packed as packed_mod
from lws_tpu.ops.pallas_packed import packed_lws_sweeps as jax_packed

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


def _two_items(g, seed):
    A = np.abs(g.S)
    S = A * np.exp(2j * np.pi * np.random.default_rng(seed).random(A.shape))
    return np.stack([S, 0.5 * S[::-1]])


def test_group_update_matches_lws_tpu(golden_q4):
    """micro=2 (T=66, 33 groups), two items, 2 sweeps at alpha=1 from random
    phases, 3 in-frame passes, float64, against lws_tpu's kernel in
    interpret mode: measured max |d| 6.2e-13 (tap order); held at 1e-9."""
    g = golden_q4
    tp = lws_tpu.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64)
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                        device="cpu")
    S = _two_items(g, 1)
    thr = lws_torch.get_thresholds(2, 1, 0.1, 1)
    jr, ji = jax_packed(jnp.asarray(S.real), jnp.asarray(S.imag), st=tp._st_batch,
                        thresholds=jnp.asarray(thr), micro=2, inner_passes=3,
                        interpret=True)
    tr, ti = packed_mod.packed_lws_sweeps(torch.tensor(S.real), torch.tensor(S.imag),
                                          own._st_batch, torch.tensor(thr), micro=2,
                                          inner_passes=3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)


def test_micro1_is_the_sweep_and_groups_differ(golden_q4):
    """micro=1 is lws_sweeps (gs) bit for bit, colors included; micro > 1
    runs jacobi passes whatever inner_scheme says (as lws_tpu), keeps the
    magnitudes, and its last, shorter group (T=66 at micro=4) is handled."""
    g = golden_q4
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                        device="cpu")
    S = _two_items(g, 2)
    sr, si = torch.tensor(S.real), torch.tensor(S.imag)
    thr = torch.tensor(lws_torch.get_thresholds(2, 1, 0.1, 1))
    st = own._st_batch
    for scheme, ip in (("jacobi", 3), ("color2x3", 1)):
        one = packed_sweeps(sr, si, st, thr, 1, ip, scheme)
        ref = plain_sweeps(sr, si, st, thr, inner_passes=ip, inner_scheme=scheme)
        assert torch.equal(one[0], ref[0]) and torch.equal(one[1], ref[1])
    j4 = packed_sweeps(sr, si, st, thr, 4, 3, "jacobi")
    c4 = packed_sweeps(sr, si, st, thr, 4, 3, "color2x3")
    assert torch.equal(j4[0], c4[0]) and torch.equal(j4[1], c4[1])
    gs = plain_sweeps(sr, si, st, thr, inner_passes=3)
    assert float((j4[0] - gs[0]).abs().max()) > 1e-6  # block Jacobi is another order
    np.testing.assert_allclose(torch.hypot(*j4).numpy(), np.abs(S), rtol=1e-12)


def test_wrapper_cpu_path_skip_and_knobs(golden_q4, monkeypatch):
    """CPU tensors take the plain version without building or counting a
    launch; a sweep no bin passes leaves the input; the TPU knobs raise."""
    def no_build(name):
        raise AssertionError("the CPU path must not build or load a kernel")
    monkeypatch.setattr("lws_torch.ops._build.load", no_build)
    g = golden_q4
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), device="cpu")
    A = torch.tensor(np.abs(g.S), dtype=torch.float32)
    Z = torch.zeros_like(A)
    before = packed_mod.LAUNCHES
    out = packed_mod.packed_lws_sweeps(A, Z, own._st_batch, torch.tensor([1e9, 1e9]), micro=3)
    assert packed_mod.LAUNCHES == before
    assert torch.equal(out[0], A) and torch.equal(out[1], Z)
    for knob in (dict(pack=8), dict(storage="bfloat16"), dict(frame_unroll=-1),
                 dict(window_carry="direct"), dict(lane_skip=True), dict(tap_chunks=2),
                 dict(interpret=True)):
        with pytest.raises(ValueError, match="TPU launch knobs"):
            packed_mod.packed_lws_sweeps(A, Z, own._st_batch, torch.ones(1), **knob)
    with pytest.raises(ValueError, match="backend"):
        packed_mod.packed_lws_sweeps(A, Z, own._st_batch, torch.ones(1), backend="cuda")


@pytest.mark.parametrize("T,F,Q,L,micro,fits", [
    (628, 257, 4, 5, 1, True),
    (628, 257, 4, 5, 4, True),
    (200_000, 2049, 4, 5, 1, True),   # T does not enter: the state is in device memory
    (100, 2049, 4, 5, 4, True),       # 6 x 4 x 2049 floats = 196,704 B
    (100, 2049, 4, 5, 5, False),      # 245,880 B > 232,448 B
    (100, 257, 17, 5, 1, False),      # Q > MAX_Q
    (100, 5, 4, 5, 1, False),         # F < L + 1
])
def test_packed_supported(T, F, Q, L, micro, fits):
    assert packed_mod.packed_supported(T, F, Q, L, micro) is fits
