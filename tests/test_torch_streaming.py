"""lws_torch.StreamingLWS and the chunked online stage on the CPU, float64,
against lws_tpu's StreamingLWS on its per-frame "xla" backend (lws_tpu's
plain reference for the chunked kernel; never its Pallas interpret mode)
and against the port's own offline online stage, on golden q4 (Q=4,
jacobi) at 3 online rounds. lws_tpu compiles its stream step once (~9 s);
one lws_tpu stream serves every comparison. The CUDA kernel's own tests are
in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from conftest import _load
from lws_torch.core.online import online_chunk, online_chunk_init, rtisi_la
from lws_torch.ops import online as online_mod
from lws_tpu.streaming import StreamingLWS as JaxStream

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)

ITERS = 3
SNAP = 20  # lws_tpu runs this many frames before the port takes over
# max |port - lws_tpu| / max amp of the committed frames, fixed mean,
# float64: measured 4.5e-7 (the two frame loops sum their taps in different
# orders, and the commit chain amplifies it, as the offline scans' 7.5e-7 on
# q4: tests/test_torch_online.py::TOL_SCAN)
TOL_FRAMES = 1e-5
# the same for the audio of a ragged push + flush with the running mean,
# over max |audio|: measured 2.2e-8 (tail 2.1e-8); lws_tpu's own
# separate-program band is rtol 1e-3 / atol 1e-4
# (tests/test_streaming.py:290-293)
TOL_AUDIO = 1e-6
# lws_tpu's window carried into the port after SNAP frames, then the port
# alone: measured 2.9e-10 x max amp against lws_tpu's own run
TOL_CARRIED = 1e-8


def _proc(g, **kw):
    return lws_torch.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=torch.float64,
                         device="cpu", online_iterations=ITERS, **kw)


def _ragged(x, seed=0):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(x):
        n = int(rng.integers(50, 700))
        yield x[i:i + n]
        i += n


def _run(stream, x, chunk):
    outs = [stream.push(x[..., i:i + chunk]) for i in range(0, x.shape[-1], chunk)]
    return np.concatenate(outs + [stream.flush()], axis=-1)


@pytest.fixture(scope="module")
def q4():
    """golden q4, its |STFT| and the mean the offline online stage uses."""
    g = _load("q4")
    p = _proc(g)
    A = np.abs(p.stft(g.x))
    At = torch.tensor(A)
    mean = float(torch.sqrt(At * At).mean())  # rtisi_la's own expression
    return g, p, A, mean


@pytest.fixture(scope="module")
def jax_run(q4):
    """One lws_tpu stream, compiled once: push_frame of every |STFT| frame
    at the fixed mean (its window after SNAP frames kept), flush; then,
    reset to the running mean, a ragged push of the signal and flush."""
    g, _, A, mean = q4
    j = lws_tpu.LWS(int(g.fsize), int(g.fshift), L=int(g.L), dtype=jnp.float64,
                    online_iterations=ITERS)
    s = JaxStream(j, iterations=ITERS, mean_amp=mean, keep_frames=True, backend="xla")
    snap = None
    for i in range(A.shape[0]):
        s.push_frame(A[i])
        if i + 1 == SNAP:
            snap = dict(win_r=np.array(s._win_r), win_i=np.array(s._win_i),
                        amp_w=np.array(s._amp_w), amp_sum=np.array(s._amp_sum),
                        frames_seen=s._frames_seen)
    s.flush()
    frames = np.stack(s.committed_frames)
    s.reset()
    s.mean_amp = None  # the running mean, on the same compiled step
    audio = np.concatenate([s.push(c) for c in _ragged(np.asarray(g.x))] + [s.flush()])
    return dict(frames=frames, snap=snap, audio=audio)


@pytest.mark.parametrize("name", ["q4", "q2"])
def test_online_chunk_chunked_matches_rtisi_la(name):
    """The plain chunked stage, chunked at (17, 1, rest) plus a drain chunk
    of LA frames at rtisi_la's fixed mean, commits what rtisi_la computes
    (measured: bit-equal; held to 1e-12 x max amp), on Q=4 jacobi and Q=2
    color2x3 from random phases."""
    g = _load(name)
    p = _proc(g)
    A = np.abs(g.S)
    S = A * np.exp(2j * np.pi * np.random.default_rng(1).random(A.shape))
    sr, si = torch.tensor(S.real)[None], torch.tensor(S.imag)[None]
    thr = torch.tensor(lws_torch.get_thresholds(ITERS, 1, 0.1, 1))
    args = (p._st_la, p._st_nofuture, p._st_af, thr)
    kw = dict(inner_passes=p.inner_passes, inner_scheme=p.inner_scheme)
    ref_r, ref_i = rtisi_la(sr, si, *args, **kw)
    T, LA = A.shape[0], p.look_ahead
    means = torch.sqrt(sr * sr + si * si).mean(dim=(-2, -1))[:, None].expand(1, T)
    state = online_chunk_init(p._st_la, p._st_af, sr[:, 0], si[:, 0])
    drain = torch.zeros((1, LA, A.shape[1]), dtype=torch.float64)
    rows = []
    for r, i, m, n_live in [(sr[:, a:b], si[:, a:b], means[:, a:b], None)
                            for a, b in ((0, 17), (17, 18), (18, T))] + [
                                (drain, drain, means[:, :LA], 0)]:
        cr, ci, state = online_chunk(r, i, state, m, *args, n_live=n_live, **kw)
        rows.append(torch.complex(cr, ci))
    assert state.seen == T + LA
    out = torch.cat(rows, dim=1)[0, LA:].numpy()
    tol = 1e-12 * A.max()
    np.testing.assert_allclose(out, torch.complex(ref_r, ref_i)[0].numpy(), rtol=0, atol=tol)


def test_push_frame_matches_lws_tpu_and_offline(q4, jax_run):
    """Frame by frame at the fixed mean, then flush: every frame is
    committed, bit-equal to the port's offline online_lws (the same frame
    loop) and within TOL_FRAMES of lws_tpu's per-frame stream."""
    g, p, A, mean = q4
    s = lws_torch.StreamingLWS(p, iterations=ITERS, mean_amp=mean, keep_frames=True)
    for i in range(A.shape[0]):
        s.push_frame(A[i])
    s.flush()
    got = np.stack(s.committed_frames)
    assert got.shape == A.shape
    np.testing.assert_array_equal(got, p.online_lws(A.astype(np.complex128)))
    np.testing.assert_allclose(got, jax_run["frames"], rtol=0, atol=TOL_FRAMES * A.max())


def test_push_ragged_then_flush_matches_lws_tpu_audio(q4, jax_run):
    """Ragged pushes of the signal with the running mean, then flush: the
    same audio as lws_tpu's stream, the overlap-add tail included."""
    g, p, _, _ = q4
    s = lws_torch.StreamingLWS(p, iterations=ITERS)
    y = np.concatenate([s.push(c) for c in _ragged(np.asarray(g.x))] + [s.flush()])
    ref = jax_run["audio"]
    assert y.shape == ref.shape
    top = np.abs(ref).max()
    tail = p.fsize - p.fshift
    assert np.abs(ref[-p.fsize:-p.fsize + tail]).max() > 1e-3 * top  # real signal there
    np.testing.assert_allclose(y, ref, rtol=0, atol=TOL_AUDIO * top)


def test_chunk_size_invariance(q4):
    """With a fixed mean a chunk boundary is invisible to the arithmetic:
    any push chunking, blocked or not, commits the same frames bit for bit;
    the audio differs only in the order of the overlap-add sums (measured
    1.6e-16 x max |audio|, held to 1e-12)."""
    g, p, _, mean = q4
    x = np.asarray(g.x)
    runs = []
    for chunk, bf in ((len(x), 0), (700, 0), (700, 32), (128, 8)):
        s = lws_torch.StreamingLWS(p, iterations=ITERS, mean_amp=mean, keep_frames=True,
                                   block_frames=bf)
        y = _run(s, x, chunk)
        runs.append((y, np.stack(s.committed_frames)))
    y0, f0 = runs[0]
    for y, f in runs[1:]:
        np.testing.assert_array_equal(f, f0)
        assert y.shape == y0.shape
        np.testing.assert_allclose(y, y0, rtol=0, atol=1e-12 * np.abs(y0).max())


def test_streams_two_match_single(q4):
    """streams=2 in lockstep equals each stream alone (running mean per
    stream); measured bit-equal, held to 1e-10 x max |audio|."""
    g, p, _, _ = q4
    x = np.asarray(g.x)
    X = np.stack([x, 0.5 * x + 0.01 * np.sin(np.arange(len(x)))])
    s2 = lws_torch.StreamingLWS(p, iterations=ITERS, streams=2)
    y2 = _run(s2, X, 3000)
    for k in range(2):
        y1 = _run(lws_torch.StreamingLWS(p, iterations=ITERS), X[k], 3000)
        assert y2[k].shape == y1.shape
        np.testing.assert_allclose(y2[k], y1, rtol=0, atol=1e-10 * np.abs(y1).max())


def test_stream_state_carried_from_lws_tpu(q4, jax_run):
    """lws_tpu's window after SNAP frames, carried across by
    convert.stream_state_from_numpy; the port pushes the rest and commits
    what lws_tpu's own stream committed (TOL_CARRIED)."""
    g, p, A, mean = q4
    snap = jax_run["snap"]
    state, asum, count = lws_torch.stream_state_from_numpy(
        **snap, Q=p._Qi, L=p.L, LA=p.look_ahead, device="cpu", dtype=torch.float64)
    assert state.seen == count == SNAP
    assert state.ring_r.shape == (1, p.look_ahead + p._Qi, A.shape[1])
    s = lws_torch.StreamingLWS(p, iterations=ITERS, mean_amp=mean, keep_frames=True)
    s._state, s._asum, s._count = state, asum, count
    s._frames_seen = s._live_seen = count
    for i in range(SNAP, A.shape[0]):
        s.push_frame(A[i])
    s.flush()
    got = np.stack(s.committed_frames)
    want = jax_run["frames"][SNAP - p.look_ahead:]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_CARRIED * A.max())


def test_stream_stats_latency_and_emit(q4):
    """StreamStats fields, latency_frames, the pipeline fill, reset, and
    emit="device" (tensors; fetch gives the host-emit bits, with and
    without prefetch)."""
    g, p, _, mean = q4
    x = np.asarray(g.x)[:6000]
    s = lws_torch.StreamingLWS(p, iterations=2, block_frames=8)
    assert s.latency_frames == p.look_ahead + 1
    assert s.push(np.zeros(p.fsize - 1)).size == 0  # no frame yet
    s.reset()
    assert s._frames_seen == 0
    s.stats.reset()
    ys = [s.push(x[:3000]), s.push(x[3000:]), s.flush()]
    rep = s.stats.summary(sample_rate=16000)
    assert rep["pushes"] == 2  # flush is not a timed push
    assert rep["samples"] == sum(len(v) for v in ys[:2]) > 0
    assert rep["frames"] == rep["samples"] // p.fshift and rep["wall_s"] > 0
    assert rep["p99_s"] >= rep["p50_s"] > 0 and rep["realtime_factor"] > 0
    host = np.concatenate(ys)
    for prefetch in (True, False):
        d = lws_torch.StreamingLWS(p, iterations=2, block_frames=8, emit="device",
                                   prefetch=prefetch)
        outs = [d.push(x[:3000]), d.push(x[3000:]), d.flush()]
        assert all(torch.is_tensor(o) for o in outs)
        np.testing.assert_array_equal(np.concatenate([d.fetch(o) for o in outs]), host)


def test_online_chunk_wrapper_checks(q4):
    """The wrapper's CPU path is the plain chunk; the TPU lane skip raises;
    the dtype gate raises naming backend='torch'; F = 8193 is taken, its
    ring in device memory, and the amp rows sit in shared memory beside the
    ring where they fit."""
    g, p, A, _ = q4
    sr = torch.tensor(A[None, :10])
    si = torch.zeros_like(sr)
    state = online_mod.online_chunk_init(p._st_la, p._st_af, sr[:, 0], si[:, 0])
    thr = torch.tensor(lws_torch.get_thresholds(2, 1, 0.1, 1))
    args = (sr, si, state, sr.mean(dim=-1), p._st_la, p._st_nofuture, p._st_af, thr)
    kr, ki, ks = online_mod.online_chunk(*args)
    pr, pi, ps = online_chunk(*args)
    assert torch.equal(kr, pr) and torch.equal(ki, pi) and torch.equal(ks.ring_r, ps.ring_r)
    assert ks.seen == 10 and state.seen == 0  # the state passed in is left as it was
    with pytest.raises(ValueError, match="lane_skip"):
        online_mod.online_chunk(*args, lane_skip=True)
    with pytest.raises(ValueError, match="backend='torch'"):
        online_mod.check_online(257, 4, 5, 3, torch.float64, chunk=True)
    online_mod.check_online(8193, 4, 5, 3, torch.float32, chunk=True)
    assert not online_mod.online_plan(8193, 4, 5, 3, chunk=True).ring
    assert online_mod.online_plan(257, 4, 5, 3, chunk=True).bytes == \
        online_mod.online_plan(257, 4, 5, 3).bytes + 4 * 4 * 257
