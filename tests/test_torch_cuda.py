"""The CUDA sweep kernel on the card, against its plain PyTorch version.

Marked `cuda`: each test skips without a CUDA card. This file imports
neither jax nor lws_tpu, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py imports jax). chip_smoke.py runs the same
comparisons at the main path's full size.
"""
import numpy as np
import pytest
import torch

import lws_torch
from lws_torch.ops import lws_sweeps as sweeps_mod

# max |kernel - plain| / max amp from a random-phase start on bench.py's
# mixture class (chip_smoke.py's TOL_CASE: the two sum their taps in
# different orders). Inputs where the no-future recursion is ill-conditioned
# are no test of the kernel: on 0.79 s clips whose chirp sweeps 3 kHz in
# under a second, lws_tpu and lws_torch already disagree by 0.45 x max amp
# in float32 on the CPU, and on white-noise magnitudes under dense sweeps by
# 1.3 x; on the 5 s mixtures by < 4e-6 (port_tools/port_vs_reference.py).
TOL = 2e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) for the hand-written kernel")
    return torch.device("cuda")


def _random_phase(proc, frames, device, seed=0):
    """The first `frames` frames of |STFT| of two 5 s tone + chirp + noise
    mixtures (bench.py::make_batch), with random phases."""
    rng = np.random.default_rng(seed)
    t = np.arange(80000) / 16000.0
    x = np.stack([0.5 * np.sin(2 * np.pi * f0 * 2 * t)
                  + 0.3 * np.sin(2 * np.pi * (f0 * 4.7) * t + 0.3 * i)
                  + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t / t[-1]) * t)
                  + 0.05 * rng.standard_normal(t.size)
                  for i, f0 in enumerate((120.0, 160.0))])
    A = np.abs(proc.stft(x))[:, :frames]
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    return (A, torch.tensor(S.real, dtype=torch.float32, device=device),
            torch.tensor(S.imag, dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("fsize,stage", [(512, "batch"), (512, "nofuture"), (256, "batch"),
                                         (512 + 64, "batch")])
def test_kernel_matches_plain(cuda_device, fsize, stage):
    """Q=4 ip3 and Q=2 color2x3 (3 dense sweeps), the no-future stencil at
    its schedule (alpha=1, 1 sweep), and a fractional hop (F=289)."""
    own = lws_torch.LWS(fsize, 128, device=cuda_device)
    st = own._st_batch if stage == "batch" else own._st_nofuture
    ip = own.batch_inner_passes if stage == "batch" else 1
    scheme = own.inner_scheme if stage == "batch" else "jacobi"
    A, sr, si = _random_phase(own, 100, cuda_device)
    sched = ((100, 100, 0.1, 1) if stage == "batch" else (1, 1, 0.1, 1))
    thr = torch.tensor(lws_torch.get_thresholds(*sched)[-3:], dtype=torch.float32,
                       device=cuda_device)
    before = sweeps_mod.LAUNCHES
    kr, ki = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, scheme)
    assert sweeps_mod.LAUNCHES == before + 1
    pr, pi = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, scheme, backend="torch")
    err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
    assert err <= TOL * A.max(), err


@pytest.mark.cuda
def test_kernel_halo_mean_and_large_q(cuda_device):
    """halo= / mean_amp= contracts, and Q=16 (weights read from device
    memory: they do not fit in shared memory)."""
    for fsize, fshift in ((512, 128), (1024, 64)):
        own = lws_torch.LWS(fsize, fshift, device=cuda_device)
        Q1, F = own._Qi - 1, own.fftsize // 2 + 1
        A, sr, si = _random_phase(own, 60, cuda_device, seed=1)
        rng = np.random.default_rng(2)
        halo = tuple(torch.tensor(rng.standard_normal((2, Q1, F)), dtype=torch.float32,
                                  device=cuda_device) for _ in range(4))
        mean = torch.tensor([1.3, 0.7], dtype=torch.float32, device=cuda_device) * sr.abs().mean()
        thr = torch.tensor(lws_torch.get_thresholds(2, 1, 0.1, 1), dtype=torch.float32,
                           device=cuda_device)
        kw = dict(halo=halo, mean_amp=mean)
        st, ip = own._st_batch, own.batch_inner_passes
        kr, ki = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, own.inner_scheme, **kw)
        pr, pi = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, own.inner_scheme,
                                             backend="torch", **kw)
        err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
        assert err <= TOL * A.max(), (fsize, fshift, err)


@pytest.mark.cuda
def test_processor_on_cuda_goes_through_kernel(cuda_device):
    own = lws_torch.LWS(512, 128, device=cuda_device)
    t = np.arange(16000) / 16000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1234 * t)).astype(np.float32)
    X = own.stft(x)
    before = sweeps_mod.LAUNCHES
    out = own.run_lws(np.abs(X))
    assert sweeps_mod.LAUNCHES >= before + 1
    np.testing.assert_allclose(np.abs(out), np.abs(X), rtol=1e-5, atol=1e-6)
    assert float(own.get_consistency(out)) > float(own.get_consistency(np.abs(X))) + 10
    with pytest.raises(TypeError, match="float32"):
        lws_torch.LWS(512, 128, device=cuda_device, dtype=torch.float64).batch_lws(
            np.abs(X), iterations=1)
