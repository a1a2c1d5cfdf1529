"""Long inputs in lws_torch on the CPU: the blocked STFT / iSTFT /
consistency, the time-segmented sweeps (K2's plain path) and the
processor's segment plan and macro chunking, against the port's one-shot
paths and lws_tpu. The card's own cases are in tests/test_torch_cuda.py.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from conftest import _load
from lws_torch.ops import lws_sweeps as sweeps_mod
from lws_torch.ops import segmented as seg_mod
from lws_tpu.ops.pallas_packed import segmented_lws_sweeps as jax_segmented

tstft = importlib.import_module("lws_torch.stft")  # the package's `stft` is the function
jstft = importlib.import_module("lws_tpu.stft")

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


def _two_items(g, seed):
    """Golden |S| with seeded random phases, and a second item at half the
    scale, time-reversed: different means, and segments that must not mix."""
    A = np.abs(g.S)
    S = A * np.exp(2j * np.pi * np.random.default_rng(seed).random(A.shape))
    return np.stack([S, 0.5 * S[::-1]])


@pytest.mark.parametrize("perfectrec", [True, False])
def test_blocked_paths_match_oneshot_and_lws_tpu(perfectrec):
    """block=77 on (2, 300, 257) forces ragged chunks and a short tail, as
    tests/test_stft.py does for lws_tpu. Float64: the blocked STFT equals
    the one-shot per frame; the blocked iSTFT and consistency differ only
    in the addition order at the seams (1e-9), and match lws_tpu's blocked
    functions to the same."""
    p = lws_torch.LWS(512, 128, perfectrec=perfectrec, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    S = rng.standard_normal((2, 300, 257)) + 1j * rng.standard_normal((2, 300, 257))
    sr, si = torch.tensor(S.real), torch.tensor(S.imag)
    swin = torch.tensor(tstft._prep_swin(p.swin, None, p.fshift, p.fftsize))
    awin = torch.tensor(p.awin)
    args = (p.fsize, p.fshift, p.fftsize, perfectrec)
    one = tstft._consistency(sr, si, awin, swin, *args)
    blk = tstft._consistency_blocked(sr, si, awin, swin, *args, block=77)
    np.testing.assert_allclose(blk.numpy(), one.numpy(), rtol=0, atol=1e-9)
    j = jstft._consistency_blocked(jnp.asarray(S.real), jnp.asarray(S.imag),
                                   jnp.asarray(p.awin), jnp.asarray(swin.numpy()),
                                   *args, block=77)
    np.testing.assert_allclose(blk.numpy(), np.asarray(j), rtol=0, atol=1e-9)

    y1 = tstft._istft(sr, si, swin, p.fshift, p.fftsize, perfectrec)
    yb = tstft._istft_blocked(sr, si, swin, p.fshift, p.fftsize, perfectrec, block=77)
    np.testing.assert_allclose(yb.numpy(), y1.numpy(), rtol=0, atol=1e-9)
    yj = jstft._istft_blocked(jnp.asarray(S.real), jnp.asarray(S.imag),
                              jnp.asarray(swin.numpy()), p.fshift, p.fftsize, perfectrec,
                              block=77)
    np.testing.assert_allclose(yb.numpy(), np.asarray(yj), rtol=0, atol=1e-9)

    x = y1
    b = tstft._stft_blocked(x, awin, p.fsize, p.fshift, p.fftsize, perfectrec, block=77)
    o = tstft._stft(x, awin, p.fsize, p.fshift, p.fftsize, perfectrec)
    assert b[0].shape == o[0].shape
    np.testing.assert_allclose(b[0].numpy(), o[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b[1].numpy(), o[1].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("segments,with_halo", [(2, False), (4, True)])
def test_segmented_plain_matches_lws_tpu(segments, with_halo):
    """K2's plain path vs lws_tpu's segmented_lws_sweeps (its Pallas kernel
    in interpret mode, ~7 s a call here, so two of the four combinations),
    float64, golden q4 (T=66: segments=4 pads 2 edge replicas), two items, 4
    sweeps in two blocks of 2, 3 in-frame passes. Measured max |d| 8.7e-13
    (the two sum taps in different orders); held at 1e-9."""
    g = _load("q4")
    tp = lws_tpu.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64)
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                        device="cpu")
    S = _two_items(g, 3)
    thr = lws_torch.get_thresholds(4, 1, 0.1, 1)
    kw_j, kw_t = {}, {}
    if with_halo:
        rng = np.random.default_rng(4)
        halo = [rng.standard_normal((2, own._Qi - 1, S.shape[-1])) for _ in range(4)]
        mean = np.array([1.3, 0.7]) * np.abs(S).mean()
        kw_j = dict(halo=tuple(jnp.asarray(h) for h in halo), mean_amp=jnp.asarray(mean))
        kw_t = dict(halo=tuple(torch.tensor(h) for h in halo), mean_amp=torch.tensor(mean))
    kw = dict(segments=segments, sweeps_per_exchange=2, inner_passes=3)
    jr, ji = jax_segmented(jnp.asarray(S.real), jnp.asarray(S.imag), st=tp._st_batch,
                           thresholds=jnp.asarray(thr), interpret=True, **kw, **kw_j)
    tr, ti = seg_mod.segmented_lws_sweeps(torch.tensor(S.real), torch.tensor(S.imag),
                                          own._st_batch, torch.tensor(thr), **kw, **kw_t)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)


def test_one_segment_is_the_tiled_sweep(golden_q4):
    """segments=1 is the plain tiled sweep: bit-equal in one block; with an
    exchange every sweep each block recomputes |S| from its input (equal to
    rounding), so 1e-12."""
    g = golden_q4
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                        device="cpu")
    S = _two_items(g, 5)
    sr, si = torch.tensor(S.real), torch.tensor(S.imag)
    thr = torch.tensor(lws_torch.get_thresholds(3, 1, 0.1, 1))
    args = (own._st_batch, thr, own.batch_inner_passes, own.inner_scheme)
    ref = sweeps_mod.tiled_lws_sweeps(sr, si, *args)
    one = seg_mod.segmented_lws_sweeps(sr, si, own._st_batch, thr, segments=1,
                                       sweeps_per_exchange=3, inner_passes=3)
    assert torch.equal(one[0], ref[0]) and torch.equal(one[1], ref[1])
    each = seg_mod.segmented_lws_sweeps(sr, si, own._st_batch, thr, segments=1,
                                        inner_passes=3)
    np.testing.assert_allclose(each[0].numpy(), ref[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(each[1].numpy(), ref[1].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("knob", [dict(pack=8), dict(storage="bfloat16"),
                                  dict(frame_unroll=-1), dict(window_carry="direct"),
                                  dict(lane_skip=True), dict(tap_chunks=2),
                                  dict(interpret=True)])
def test_segmented_rejects_tpu_knobs(knob):
    own = lws_torch.LWS(512, 128, device="cpu")
    A = torch.ones((40, 257))
    with pytest.raises(ValueError, match="TPU launch knobs"):
        seg_mod.segmented_lws_sweeps(A, A, own._st_batch, torch.ones(1), segments=2, **knob)
    with pytest.raises(ValueError, match="frames/segment"):
        seg_mod.segmented_lws_sweeps(A, A, own._st_batch, torch.ones(1), segments=8)


def test_macro_chunking_matches_lws_tpu(golden_q4):
    """_MACRO_T / _MACRO_CHUNK set small (as tests/test_pipeline.py does):
    3 chunks of 22 frames with real-neighbour halos and the whole signal's
    mean, batch (3 sweeps) and no-future (1 sweep), float64, two items,
    against lws_tpu's processor under the same overrides: measured 9.0e-13
    and 8.6e-13."""
    g = golden_q4
    kw = dict(L=int(g.L))
    tp = lws_tpu.LWS(int(g.fsize), int(g.fshift), dtype=jnp.float64, **kw)
    own = lws_torch.LWS(int(g.fsize), int(g.fshift), dtype=torch.float64, device="cpu", **kw)
    for p in (tp, own):
        p._MACRO_T, p._MACRO_CHUNK = 30, 25
    A = np.abs(_two_items(g, 6)).astype(np.complex128)
    for stage, thr in (("batch_lws", lws_torch.get_thresholds(3, 1, 0.1, 1)),
                       ("nofuture_lws", lws_torch.get_thresholds(1, 1, 0.1, 1))):
        out_j = np.asarray(getattr(tp, stage)(A, thresholds=thr))
        out_t = getattr(own, stage)(A, thresholds=thr)
        np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.abs(out_t), np.abs(A), rtol=1e-12)


def test_macro_chunks_against_unchunked(golden_q4):
    """Chunked at 2 x 33 frames against unchunked, one sweep: the first
    chunk's bottom halo holds its real neighbours at stage entry, which is
    what the unchunked sweep reads there, so the first chunk is bit-equal;
    the second chunk's top halo is the stage entry instead of this sweep's
    values, so it differs (the seam lws_tpu accepts)."""
    g = golden_q4
    mk = lambda: lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L),  # noqa: E731
                               dtype=torch.float64, device="cpu")
    whole, chunked = mk(), mk()
    chunked._MACRO_T, chunked._MACRO_CHUNK = 40, 40
    A = np.abs(_two_items(g, 7)).astype(np.complex128)
    thr = lws_torch.get_thresholds(1, 1, 0.1, 1)
    ow, oc = whole.batch_lws(A, thresholds=thr), chunked.batch_lws(A, thresholds=thr)
    np.testing.assert_array_equal(oc[:, :33], ow[:, :33])
    assert np.abs(oc[:, 33:] - ow[:, 33:]).max() > 1e-3 * np.abs(A).max()


@pytest.mark.parametrize("B,T,n_sm,S", [
    (1, 29535, 132, 8),    # bench.py's longform row: lws_tpu's cap of 8
    (1, 29535, 16, 8),
    (1, 29535, 6, 6),      # capped by the idle SMs
    (1, 5626, 132, 2),     # 120 s at 48 kHz / hop 1024
    (1, 4095, 132, 1),     # under two 2048-frame segments
    (32, 628, 132, 1),     # the batch path: no idle SM pair per utterance
    (64, 100000, 132, 2),
    (70, 100000, 132, 1),
    (1, 100000, 0, 1),     # the CPU
])
def test_auto_segments_plan(B, T, n_sm, S):
    p = lws_torch.LWS(512, 128, device="cpu")
    assert p._n_sm == 0 and p._auto_segments(B, T) == 1  # on the CPU, S = 1
    p._n_sm = n_sm  # the card's SM count
    assert p._auto_segments(B, T) == S
    off = lws_torch.LWS(512, 128, device="cpu", auto_segment=False)
    off._n_sm = n_sm
    assert off._auto_segments(B, T) == 1


def test_processor_runs_the_planned_segments(golden_q4, monkeypatch):
    """Given an SM count (here forced on the CPU, with a 16-frame floor),
    batch_lws runs the segmented sweeps with the planned S and the
    processor's exchange cadence, equal bit for bit to the direct call."""
    g = golden_q4
    p = lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                      device="cpu")
    p._n_sm, p._SEG_MIN_FRAMES = 132, 16
    A = np.abs(_two_items(g, 8))
    calls = []
    real = seg_mod.segmented_lws_sweeps

    def spy(*a, **kw):
        calls.append(kw["segments"])
        return real(*a, **kw)

    monkeypatch.setattr("lws_torch.processor.segmented_lws_sweeps", spy)
    thr = lws_torch.get_thresholds(12, 1, 0.1, 1)
    out = p.batch_lws(A, thresholds=thr)
    assert calls == [min(132 // 2, 66 // 16)]
    sr = torch.tensor(A)
    ref = real(sr, torch.zeros_like(sr), p._st_batch, torch.tensor(thr), segments=4,
               sweeps_per_exchange=p._SWEEPS_PER_EXCHANGE, inner_passes=p.batch_inner_passes,
               inner_scheme=p.inner_scheme)
    np.testing.assert_array_equal(out, lws_torch.merge(*ref))
