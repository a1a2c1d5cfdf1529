"""The CUDA kernels on the card (the sweep kernel, the grouped sweep
kernel, the segmented sweeps over the sweep kernel, the online kernel, the
chunked online kernel and the stream around it), against their plain
PyTorch versions.

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
from lws_torch.ops import online as online_mod
from lws_torch.ops import packed as packed_mod
from lws_torch.ops import segmented as seg_mod

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
    """halo= / mean_amp= contracts, and Q=16 (the kernel's run-time path;
    of its 31 rows of taps the centre row fits in shared memory, the rest
    are read from device memory)."""
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
def test_kernel_q32_matches_plain(cuda_device):
    """LWS(256, 8, L=3) (Q=32, past the JAX kernels' MAX_Q): the kernel's
    run-time path, 3 dense sweeps from random phases, on 300 frames."""
    own = lws_torch.LWS(256, 8, L=3, device=cuda_device)
    A, sr, si = _random_phase(own, 300, cuda_device, seed=3)
    thr = torch.tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:], dtype=torch.float32,
                       device=cuda_device)
    st, ip = own._st_batch, own.batch_inner_passes
    before = sweeps_mod.LAUNCHES
    kr, ki = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, own.inner_scheme)
    assert sweeps_mod.LAUNCHES == before + 1
    pr, pi = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, own.inner_scheme, backend="torch")
    err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
    assert err <= TOL * A.max(), err


@pytest.mark.cuda
@pytest.mark.parametrize("simplified,table", [(True, 1), (False, 0)])
def test_kernel_q8_table_matches_plain(cuda_device, simplified, table):
    """LWS(2048, 256) (Q = 8, F = 1025: the vocoder's geometry), 3 dense
    sweeps from random phases on (4, 223, 1025): the table kernel (weights
    from the period-Q table), counted in TABLE_LAUNCHES. With per-bin
    weights (use_simplifications=False, P = F) the run-time kernel runs and
    TABLE_LAUNCHES stays as it was."""
    own = lws_torch.LWS(2048, 256, use_simplifications=simplified, device=cuda_device)
    parts = [_random_phase(own, 223, cuda_device, seed=s) for s in (4, 5)]
    A = np.concatenate([p[0] for p in parts])
    sr, si = (torch.cat([p[k] for p in parts]) for k in (1, 2))
    assert tuple(sr.shape) == (4, 223, 1025)
    thr = torch.tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:], dtype=torch.float32,
                       device=cuda_device)
    st, ip = own._st_batch, own.batch_inner_passes
    before = (sweeps_mod.LAUNCHES, sweeps_mod.TABLE_LAUNCHES)
    kr, ki = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, own.inner_scheme)
    assert (sweeps_mod.LAUNCHES, sweeps_mod.TABLE_LAUNCHES) == (before[0] + 1,
                                                                before[1] + table)
    pr, pi = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, own.inner_scheme, backend="torch")
    err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
    assert err <= TOL * A.max(), err


@pytest.mark.cuda
def test_free_function_complex128_on_cuda(cuda_device):
    """numpy's default complex128 through the free batch_lws on CUDA: the
    float32 kernel, complex64 out; backend="torch" keeps float64
    (complex128); their consistency agrees within 0.1 dB."""
    own = lws_torch.LWS(512, 128, device=cuda_device)
    t = np.arange(16000) / 16000.0
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1234 * t)
    S = np.abs(own.stft(x)).astype(np.complex128)
    thr = lws_torch.get_thresholds(20, 100, 0.1, 1)
    before = sweeps_mod.LAUNCHES
    out = lws_torch.batch_lws(S, own.W, thr)
    assert sweeps_mod.LAUNCHES == before + 1
    ref = lws_torch.batch_lws(S, own.W, thr, backend="torch")
    assert out.dtype == np.complex64 and ref.dtype == np.complex128
    assert np.isfinite(out).all() and out.shape == S.shape
    d = abs(float(own.get_consistency(out)) - float(own.get_consistency(ref)))
    assert d <= 0.1, d


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


@pytest.mark.cuda
def test_online_kernel_matches_plain_sparse_golden(cuda_device):
    """The golden sparse online inputs (look_ahead=2), every frame, at
    chip_smoke.py's TOL_SPARSE: on q4 the plain float32 version moves
    1.3e-3 x max amp under a 1e-7 relative input perturbation, on q2 3.8e-7
    (port_tools/online_vs_reference.py, section sparse32)."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, tol in (("q4", 5e-3), ("q2", 1e-5)):
        with np.load(os.path.join(root, "tests", "golden", f"ref_{name}.npz")) as z:
            g = {k: z[k] for k in z.files}
        own = lws_torch.LWS(int(g["fsize"]), int(g["fshift"]), L=int(g["L"]), look_ahead=2,
                            device=cuda_device)
        S = g["online_sparse_in"]
        sr = torch.tensor(S.real, dtype=torch.float32, device=cuda_device)
        si = torch.tensor(S.imag, dtype=torch.float32, device=cuda_device)
        thr = torch.tensor(g["online_sparse_thr"], dtype=torch.float32, device=cuda_device)
        args = (sr, si, own._st_la, own._st_nofuture, own._st_af, thr, own.inner_passes,
                own.inner_scheme)
        before = online_mod.LAUNCHES
        kr, ki = online_mod.packed_rtisi_la(*args)
        assert online_mod.LAUNCHES == before + 1
        pr, pi = online_mod.packed_rtisi_la(*args, backend="torch")
        err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
        assert err <= tol * np.abs(S).max(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("fsize,iters", [(512, 10), (256, 2)])
def test_online_kernel_matches_plain_random_phase(cuda_device, fsize, iters):
    """Q=4 jacobi at 10 rounds, Q=2 color2x3 at 2: the first frames bin by
    bin, then the whole by consistency (rounding grows along the commit
    chain)."""
    own = lws_torch.LWS(fsize, 128, device=cuda_device)
    A, sr, si = _random_phase(own, 100, cuda_device, seed=3)
    thr = torch.tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1), dtype=torch.float32,
                       device=cuda_device)
    args = (sr, si, own._st_la, own._st_nofuture, own._st_af, thr, own.inner_passes,
            own.inner_scheme)
    kr, ki = online_mod.packed_rtisi_la(*args)
    pr, pi = online_mod.packed_rtisi_la(*args, backend="torch")
    err = max(float((kr[:, :6] - pr[:, :6]).abs().max()),
              float((ki[:, :6] - pi[:, :6]).abs().max()))
    assert err <= TOL * A.max(), err
    dc = (own.get_consistency((kr, ki)) - own.get_consistency((pr, pi))).abs().max()
    assert float(dc) <= 0.1, float(dc)
    np.testing.assert_allclose(torch.sqrt(kr * kr + ki * ki).cpu().numpy(), A,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_music_run_lws_on_cuda_matches_plain(cuda_device):
    """mode="music" run_lws through both kernels (K1 twice, K3 once)
    against backend="torch", by consistency."""
    own = lws_torch.LWS(512, 128, mode="music", device=cuda_device)
    plain = lws_torch.LWS(512, 128, mode="music", device=cuda_device, backend="torch")
    A, sr, si = _random_phase(own, 120, cuda_device, seed=4)
    amp = torch.tensor(A, dtype=torch.float32, device=cuda_device)
    pair = (amp, torch.zeros_like(amp))
    before = (sweeps_mod.LAUNCHES, online_mod.LAUNCHES)
    out = own.run_lws(pair)
    assert (sweeps_mod.LAUNCHES, online_mod.LAUNCHES) == (before[0] + 2, before[1] + 1)
    ref = plain.run_lws(pair)
    dc = (own.get_consistency(out) - plain.get_consistency(ref)).abs().max()
    assert float(dc) <= 0.1, float(dc)
    assert float(own.get_consistency(out).min()) > float(own.get_consistency(pair).max()) + 10


@pytest.mark.cuda
def test_online_kernel_rejects_what_it_does_not_take(cuda_device):
    """float64 raises, naming backend='torch'; LWS(4096, 512) (Q = 8,
    F = 2049, which the previous kernel refused) runs through the kernel and
    matches the plain version on its first frames."""
    own = lws_torch.LWS(512, 128, device=cuda_device, dtype=torch.float64)
    A = np.abs(np.random.default_rng(5).standard_normal((2, 30, 257)))
    with pytest.raises(ValueError, match="backend='torch'"):
        own.online_lws(A.astype(np.complex128), iterations=1)
    wide = lws_torch.LWS(4096, 512, device=cuda_device)  # F=2049, Q=8
    A, sr, si = _random_phase(wide, 20, cuda_device, seed=6)
    before = online_mod.LAUNCHES
    kr, ki = wide.online_lws((sr, si), iterations=1)
    assert online_mod.LAUNCHES == before + 1
    pr, pi = lws_torch.LWS(4096, 512, device=cuda_device, backend="torch").online_lws(
        (sr, si), iterations=1)
    err = max(float((kr[:, :6] - pr[:, :6]).abs().max()),
              float((ki[:, :6] - pi[:, :6]).abs().max()))
    assert err <= TOL * A.max(), err


def _chunked(online_mod, own, sr, si, means, thr, backend="auto"):
    """The chunked online stage over (sr, si) chunked at (17, 1, rest), then
    one drain chunk of LA frames: the committed rows of the input's frames."""
    LA = own.look_ahead
    state = online_mod.online_chunk_init(own._st_la, own._st_af, sr[:, 0], si[:, 0])
    z = torch.zeros((sr.shape[0], LA, sr.shape[-1]), device=sr.device)
    rows_r, rows_i = [], []
    T = sr.shape[1]
    for r, i, m, n_live in [(sr[:, a:b], si[:, a:b], means[:, a:b], None)
                            for a, b in ((0, 17), (17, 18), (18, T))] + [
                                (z, z, means[:, :LA], 0)]:
        cr, ci, state = online_mod.online_chunk(
            r.contiguous(), i.contiguous(), state, m.contiguous(), own._st_la,
            own._st_nofuture, own._st_af, thr, n_live, own.inner_passes, own.inner_scheme,
            backend)
        rows_r.append(cr)
        rows_i.append(ci)
    return torch.cat(rows_r, 1)[:, LA:], torch.cat(rows_i, 1)[:, LA:]


@pytest.mark.cuda
@pytest.mark.parametrize("fsize", [512, 256])
def test_chunked_kernel_equals_online_kernel(cuda_device, fsize):
    """K4 chunked at (17, 1, rest) and drained, at K3's fixed mean, equals K3
    bit for bit (Q=4 jacobi at 10 rounds, Q=2 color2x3)."""
    own = lws_torch.LWS(fsize, 128, device=cuda_device)
    A, sr, si = _random_phase(own, 100, cuda_device, seed=6)
    thr = torch.tensor(lws_torch.get_thresholds(10, 1, 0.1, 1), dtype=torch.float32,
                       device=cuda_device)
    k3 = online_mod.packed_rtisi_la(sr, si, own._st_la, own._st_nofuture, own._st_af, thr,
                                    own.inner_passes, own.inner_scheme)
    amp = torch.sqrt(sr * sr + si * si)
    means = amp.mean(dim=(-2, -1))[:, None].expand(-1, sr.shape[1])
    before = online_mod.CHUNK_LAUNCHES
    k4 = _chunked(online_mod, own, sr, si, means, thr)
    assert online_mod.CHUNK_LAUNCHES == before + 4
    assert torch.equal(k4[0], k3[0]) and torch.equal(k4[1], k3[1])


@pytest.mark.cuda
def test_stream_on_cuda_emit_and_plain(cuda_device):
    """StreamingLWS on the card: emit="device" returns CUDA tensors whose
    bytes (fetched, with and without prefetch) equal emit="host"'s; the
    kernel path agrees with the plain chunk path by consistency; a float64
    stream raises naming backend='torch', and runs with it."""
    own = lws_torch.LWS(512, 128, look_ahead=3, online_iterations=10, device=cuda_device)
    t = np.arange(16000) / 16000.0
    x = np.stack([0.5 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t) * t)
                  for f in (220.0, 330.0)]).astype(np.float32)

    def run(**kw):
        st = lws_torch.StreamingLWS(own, streams=2, block_frames=16, keep_frames=True, **kw)
        outs = [st.push_block(x[:, i:i + 4000]) for i in range(0, x.shape[-1], 4000)]
        outs.append(st.flush())
        return outs, st

    host, st_h = run(emit="host")
    y = np.concatenate(host, axis=-1)
    for prefetch in (True, False):
        before = online_mod.CHUNK_LAUNCHES
        outs, st = run(emit="device", prefetch=prefetch)
        assert online_mod.CHUNK_LAUNCHES > before
        assert all(o.is_cuda for o in outs)
        np.testing.assert_array_equal(np.concatenate([st.fetch(o) for o in outs], axis=-1), y)
    _, st_p = run(backend="torch")

    def consistency(st):
        com = torch.as_tensor(np.stack(st.committed_frames, axis=1), device=cuda_device)
        return own.get_consistency((com.real.contiguous(), com.imag.contiguous()))

    assert float((consistency(st_h) - consistency(st_p)).abs().max()) <= 0.1
    own64 = lws_torch.LWS(512, 128, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="backend='torch'"):
        lws_torch.StreamingLWS(own64)
    out = lws_torch.StreamingLWS(own64, backend="torch", block_frames=4).push(x[0, :2000])
    # 12 frames fit 2000 samples; the first LA=3 fill the look-ahead
    assert out.shape == ((12 - 3) * 128,) and np.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fsize,stage", [(512, "batch"), (512, "nofuture"), (256, "batch")])
def test_grouped_kernel_matches_plain_and_k1(cuda_device, fsize, stage):
    """K5 at micro 2 and 4 against its plain group update (3 dense sweeps,
    or the no-future schedule), one launch each; at micro = 1 the wrapper
    launches K1 once and equals it bit for bit."""
    own = lws_torch.LWS(fsize, 128, device=cuda_device)
    st = own._st_batch if stage == "batch" else own._st_nofuture
    ip = own.batch_inner_passes if stage == "batch" else 1
    scheme = own.inner_scheme if stage == "batch" else "jacobi"
    A, sr, si = _random_phase(own, 101, cuda_device, seed=7)
    sched = ((100, 100, 0.1, 1) if stage == "batch" else (1, 1, 0.1, 1))
    thr = torch.tensor(lws_torch.get_thresholds(*sched)[-3:], dtype=torch.float32,
                       device=cuda_device)
    k1 = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, scheme)
    for micro in (1, 2, 4):
        before = packed_mod.LAUNCHES, sweeps_mod.LAUNCHES
        kr, ki = packed_mod.packed_lws_sweeps(sr, si, st, thr, micro, ip, scheme)
        assert (packed_mod.LAUNCHES, sweeps_mod.LAUNCHES) == (
            before[0] + (micro > 1), before[1] + (micro == 1))
        pr, pi = packed_mod.packed_lws_sweeps(sr, si, st, thr, micro, ip, scheme,
                                              backend="torch")
        err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
        assert err <= TOL * A.max(), (micro, err)
        if micro == 1:
            assert torch.equal(kr, k1[0]) and torch.equal(ki, k1[1])


@pytest.mark.cuda
def test_micro_entry_points_run_on_k5(cuda_device):
    """lws_tpu's other entry points at micro 2 run the grouped sweeps on K5:
    tiled_lws_sweeps (one launch, equal to packed_lws_sweeps bit for bit,
    and with halo= / mean_amp=) and segmented_lws_sweeps (one launch per
    exchange block), each against its plain version."""
    own = lws_torch.LWS(512, 128, device=cuda_device)
    st, ip = own._st_batch, own.batch_inner_passes
    A, sr, si = _random_phase(own, 101, cuda_device, seed=9)
    thr = torch.tensor(lws_torch.get_thresholds(6, 1, 0.1, 1), dtype=torch.float32,
                       device=cuda_device)
    rng = np.random.default_rng(9)
    B, _, F = sr.shape
    halo = tuple(torch.tensor(rng.standard_normal((B, 3, F)) * float(A.mean()),
                              dtype=torch.float32, device=cuda_device) for _ in range(4))
    mean = torch.tensor(rng.uniform(0.5, 2.0, B) * float(A.mean()), dtype=torch.float32,
                        device=cuda_device)
    grouped = packed_mod.packed_lws_sweeps(sr, si, st, thr, 2, ip)
    for kw in ({}, dict(halo=halo, mean_amp=mean)):
        before = packed_mod.LAUNCHES, sweeps_mod.LAUNCHES
        kr, ki = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, micro=2, **kw)
        assert (packed_mod.LAUNCHES, sweeps_mod.LAUNCHES) == (before[0] + 1, before[1])
        pr, pi = sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, ip, micro=2, backend="torch", **kw)
        err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
        assert err <= TOL * A.max(), (kw.keys(), err)
        if not kw:
            assert torch.equal(kr, grouped[0]) and torch.equal(ki, grouped[1])
    seg = dict(segments=2, sweeps_per_exchange=2, micro=2, inner_passes=ip)
    before = packed_mod.LAUNCHES
    kr, ki = seg_mod.segmented_lws_sweeps(sr, si, st, thr, **seg)
    assert packed_mod.LAUNCHES == before + 3
    pr, pi = seg_mod.segmented_lws_sweeps(sr, si, st, thr, backend="torch", **seg)
    err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
    assert err <= TOL * A.max(), err


@pytest.mark.cuda
def test_segmented_kernel_matches_plain(cuda_device):
    """K2 on the kernel against K2 on the plain sweeps: two utterances in 4
    segments, an exchange every 2 sweeps over 5 sweeps (3 K1 launches)."""
    own = lws_torch.LWS(512, 128, device=cuda_device)
    A, sr, si = _random_phase(own, 150, cuda_device, seed=8)
    thr = torch.tensor(lws_torch.get_thresholds(5, 1, 0.1, 1), dtype=torch.float32,
                       device=cuda_device)
    kw = dict(segments=4, sweeps_per_exchange=2, inner_passes=own.batch_inner_passes,
              inner_scheme=own.inner_scheme)
    before = sweeps_mod.LAUNCHES
    kr, ki = seg_mod.segmented_lws_sweeps(sr, si, own._st_batch, thr, **kw)
    assert sweeps_mod.LAUNCHES == before + 3
    pr, pi = seg_mod.segmented_lws_sweeps(sr, si, own._st_batch, thr, backend="torch", **kw)
    err = max(float((kr - pr).abs().max()), float((ki - pi).abs().max()))
    assert err <= TOL * A.max(), err


@pytest.mark.cuda
def test_long_input_plan_on_cuda(cuda_device):
    """The processor on the card plans S from the SM count: with the floor
    lowered to 32 frames, 203 frames run as 6 segments (one K1 launch per
    exchange block), and backend="torch" on the card plans the same S, so
    the two agree by consistency; auto_segment=False runs one launch."""
    t = np.arange(200 * 128) / 16000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t) * t)
         ).astype(np.float32)
    procs = [lws_torch.LWS(512, 128, device=cuda_device, **kw)
             for kw in ({}, {"backend": "torch"}, {"auto_segment": False})]
    for p in procs:
        p._SEG_MIN_FRAMES = 32
    X = procs[0].stft(x)
    assert [p._auto_segments(1, X.shape[-2]) for p in procs] == [6, 6, 1]
    outs = []
    blocks = -(-30 // procs[0]._SWEEPS_PER_EXCHANGE)
    for p, launches in zip(procs, (blocks, 0, 1)):
        before = sweeps_mod.LAUNCHES
        outs.append(p.batch_lws(np.abs(X), iterations=30))
        assert sweeps_mod.LAUNCHES == before + launches
        np.testing.assert_allclose(np.abs(outs[-1]), np.abs(X), rtol=1e-5, atol=1e-6)
    c = [float(procs[0].get_consistency(o)) for o in outs]
    assert abs(c[0] - c[1]) <= 0.1, c


@pytest.mark.cuda
def test_sharded_batch_lws_runs_on_k1(cuda_device, monkeypatch):
    """batch_lws(mesh=) over a one-rank mesh (no process group needed):
    kernel=None picks the tiled route; one time shard has nothing to
    exchange, so the sweeps are one K1 launch, bit-equal to batch_lws().
    The sharded route never runs the plain sweeps on the card in place of
    K1: float64 with kernel="tiled" raises as tiled_lws_sweeps does, and
    kernel=None on a geometry K1's plan does not fit raises."""
    from lws_torch import processor
    from lws_torch.parallel import make_mesh, sharded_lws_sweeps
    own = lws_torch.LWS(512, 128, device=cuda_device)
    A, sr, si = _random_phase(own, 100, cuda_device, seed=4)
    mesh = make_mesh(1, 1, device=cuda_device)
    before = sweeps_mod.LAUNCHES
    kr, ki = own.batch_lws((sr, si), 5, mesh=mesh, sweeps_per_exchange=2)
    assert sweeps_mod.LAUNCHES == before + 1
    wr, wi = own.batch_lws((sr, si), 5)
    assert torch.equal(kr, wr) and torch.equal(ki, wi)
    thr = torch.ones(2, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="take float32"):
        sharded_lws_sweeps(sr.double(), si.double(), own._st_batch, thr, mesh, kernel="tiled")
    plan = processor.sweep_plan(257, own._Qi, own.L)
    monkeypatch.setattr(processor, "sweep_plan", lambda F, Q, L: plan._replace(bytes=1 << 30))
    with pytest.raises(ValueError, match="tiled kernel cannot run this sharded geometry"):
        own.batch_lws((sr, si), 5, mesh=mesh)


@pytest.mark.cuda
def test_dryrun_multichip_one_rank_on_cuda(cuda_device):
    """dryrun_multichip(1) spawns one NCCL rank on the card, mesh (1, 1):
    its four phases pass their own checks at lws_tpu's sizes, each sharded
    call is one K1 launch (one time shard), the no-future sweep and the
    unsharded calls one each, phase 1's online stage one K3 launch."""
    from lws_torch.entry import dryrun_multichip
    rec = dryrun_multichip(1)
    assert rec["backend"] == "nccl" and rec["mesh"] == [1, 1]
    assert [rec[p]["k1_launches"] for p in ("phase1", "phase2", "phase3", "phase4")] == [2, 2, 0, 2]
    assert rec["phase1"]["k3_launches"] == 1
    assert abs(rec["phase4"]["consistency_sharded"] - rec["phase4"]["consistency_unsharded"]) < 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("fftsize", [512, 1024, 2048, 4096])
def test_istft_and_stream_drop_edge_imaginary_parts(cuda_device, monkeypatch, fftsize):
    """The float32 iSTFT and StreamingLWS's synthesis on the card against the
    CPU float64 path, on spectra whose DC and Nyquist bins carry imaginary
    parts as large as the other bins' (a real frame cannot hold them; numpy's
    irfft, the library's, drops them; cuFFT's float32 C2R kept them at
    n = 1024, 1e-3 of the peak). The stream's online stage is made the
    identity, so the frames pushed are the frames synthesised."""
    g = torch.Generator().manual_seed(fftsize)
    sr, si = (torch.randn(2, 12, fftsize // 2 + 1, generator=g, dtype=torch.float64)
              for _ in range(2))
    ref = lws_torch.LWS(fftsize, fftsize // 4, device="cpu", dtype=torch.float64)
    own = lws_torch.LWS(fftsize, fftsize // 4, device=cuda_device)
    want = ref.istft((sr, si))
    got = own.istft((sr.float().to(cuda_device), si.float().to(cuda_device))).cpu().double()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    monkeypatch.setattr(online_mod, "online_chunk",
                        lambda fr, fi, state, *args: (fr, fi, state))
    frames = torch.complex(sr, si).transpose(0, 1)  # (N, S, F)

    def run(proc, specs):
        st = lws_torch.StreamingLWS(proc, streams=2, block_frames=4)
        return np.concatenate([st.push_frames(specs), st.flush()], axis=-1)

    want = run(ref, frames)
    got = run(own, frames.to(torch.complex64))
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
