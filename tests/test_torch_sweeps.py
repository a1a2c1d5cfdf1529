"""The port's sweeps on the CPU: the plain version vs lws_tpu's, the plain
version vs the Pallas kernel itself (interpret mode), and the wrapper's CPU
path. The CUDA kernel's own tests are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
from conftest import _load
from lws_torch.convert import stencil_from_numpy
from lws_torch.core.batch import lws_sweeps as plain_sweeps
from lws_torch.ops import lws_sweeps as sweeps_mod
from lws_tpu import LWS as TpuLWS
from lws_tpu.core.batch import lws_sweeps as jax_sweeps
from lws_tpu.core.stencil import split as jsplit
from lws_tpu.ops import tiled_lws_sweeps as pallas_tiled

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


def _pair_inputs(g, rng):
    A = np.abs(g.S)
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    return np.stack([S, 0.5 * S[::-1]])  # two items, different means


@pytest.mark.parametrize("name", ["q4", "q2", "frac"])
@pytest.mark.parametrize("with_halo", [False, True])
def test_plain_sweeps_match_lws_tpu_float64(name, with_halo):
    g = _load(name)
    tp = TpuLWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64)
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                        device="cpu")
    rng = np.random.default_rng(11)
    S = _pair_inputs(g, rng)
    thr = lws_torch.get_thresholds(3, 1, 0.1, 1)
    kw_j, kw_t = {}, {}
    if with_halo:
        Q1, F = own._Qi - 1, S.shape[-1]
        halo = [rng.standard_normal((2, Q1, F)) for _ in range(4)]
        # a mean_amp far below the true mean (0.2x) makes nearly every bin
        # live, where the no-future sweep is chaotic even in float64 (lws_tpu
        # against itself moves 3.7e-5 under a 1e-14 input perturbation;
        # port_tools/port_vs_reference.py)
        mean = np.array([1.3, 0.5]) * np.abs(S).mean()
        kw_j = dict(halo=tuple(jnp.asarray(h) for h in halo), mean_amp=jnp.asarray(mean))
        kw_t = dict(halo=tuple(torch.tensor(h) for h in halo), mean_amp=torch.tensor(mean))
    for st_j, st_t, ip, scheme in (
            (tp._st_batch, own._st_batch, own.batch_inner_passes, own.inner_scheme),
            (tp._st_nofuture, own._st_nofuture, 1, "jacobi")):
        jr, ji = jax_sweeps(jnp.asarray(S.real), jnp.asarray(S.imag), st_j,
                            jnp.asarray(thr), inner_passes=ip, inner_scheme=scheme, **kw_j)
        tr, ti = plain_sweeps(torch.tensor(S.real), torch.tensor(S.imag), st_t,
                              torch.tensor(thr), inner_passes=ip, inner_scheme=scheme, **kw_t)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)


def test_plain_sweeps_match_pallas_kernel_float32(golden_q4):
    """Float32, against the TPU kernel itself in interpret mode, as
    tests/test_pallas.py::test_tiled_short_run_is_exact holds it to the XLA
    path. atol=2e-3 (max amp ~59): the two sum their taps in different
    orders (Pallas sequentially per tap, the port in torch's reduction
    order), and from this zero-phase start some tap sums nearly cancel, so
    float32 rounding differences grow over the frame chain; measured 8.9e-4."""
    g = golden_q4
    tp = TpuLWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float32)
    A = np.abs(g.S).astype(np.complex64)
    thr = jnp.asarray(lws_torch.get_thresholds(2, 1, 0.1, 1), dtype=jnp.float32)
    st = tp._st_batch
    kr, ki = pallas_tiled(*jsplit(A, dtype=jnp.float32), st=st, thresholds=thr, tile=16,
                          micro=1, interpret=True, inner_scheme="jacobi",
                          inner_passes=3)
    st_t = stencil_from_numpy(np.asarray(st.Wr), np.asarray(st.Wi), st.nz, st.Q, st.L,
                              device="cpu")
    tr, ti = plain_sweeps(torch.tensor(A.real), torch.tensor(A.imag), st_t,
                          torch.tensor(np.asarray(thr)), inner_passes=3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(kr), atol=2e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ki), atol=2e-3)


def test_wrapper_cpu_tensor_takes_plain_path_without_build(golden_q4, monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must not build or load a kernel")
    monkeypatch.setattr(sweeps_mod._build, "load", no_build)
    monkeypatch.setattr(sweeps_mod._build, "build", no_build)
    g = golden_q4
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), device="cpu")
    A = torch.tensor(np.abs(g.S), dtype=torch.float32)
    Z = torch.zeros_like(A)
    thr = torch.tensor(lws_torch.get_thresholds(2, 1, 0.1, 1), dtype=torch.float32)
    before = sweeps_mod.LAUNCHES
    out = sweeps_mod.tiled_lws_sweeps(A, Z, own._st_batch, thr, 3)
    ref = plain_sweeps(A, Z, own._st_batch, thr, inner_passes=3)
    assert sweeps_mod.LAUNCHES == before
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    # backend="torch" is the same plain path
    out_t = sweeps_mod.tiled_lws_sweeps(A, Z, own._st_batch, thr, 3, backend="torch")
    assert torch.equal(out_t[0], ref[0])


@pytest.mark.parametrize("knob", [dict(storage="bfloat16"), dict(lane_fold=2),
                                  dict(tap_chunks=2), dict(micro=4, lane_skip=True),
                                  dict(lane_skip=True)])
def test_wrapper_rejects_tpu_knobs(golden_q4, knob):
    """The TPU launch knobs raise. micro is not one of them (micro > 1 runs
    lws_tpu's grouped sweeps, tests/test_torch_packed_plan.py): beside a
    knob, the error names the knob alone."""
    own = lws_torch.LWS(512, 128, device="cpu")
    A = torch.ones((4, 257))
    with pytest.raises(ValueError, match="TPU launch knobs") as err:
        sweeps_mod.tiled_lws_sweeps(A, A, own._st_batch, torch.ones(1), **knob)
    assert "micro" not in str(err.value)


def test_plain_sweep_skip_is_exact(golden_q4):
    """A sweep whose threshold no bin exceeds is skipped; the result equals
    running no sweep at all, and the schedule flags it dead."""
    g = golden_q4
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                        device="cpu")
    A = torch.tensor(np.abs(g.S))
    Z = torch.zeros_like(A)
    thr = torch.tensor([1e9, 1e9], dtype=torch.float64)
    out = plain_sweeps(A, Z, own._st_batch, thr, inner_passes=3)
    assert torch.equal(out[0], A) and torch.equal(out[1], Z)
    _, _, live = sweeps_mod.sweep_schedule(A[None], Z[None], thr)
    assert live.sum() == 0
