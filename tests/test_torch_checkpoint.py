"""lws_torch.checkpoint: the cases of tests/test_checkpoint.py on the port,
and checkpoints carried between the two packages, on the CPU in float64.

- resuming an interrupted run reproduces the uninterrupted checkpointed run
  bit for bit;
- chunked execution is quality-identical to the single-call stage;
- a checkpoint of another job is refused, never resumed;
- a failed chunk is retried from the state before it, also when the fault
  shows only when the result is fetched;
- the fingerprint equals lws_tpu's for the same job, so an npz written by
  either package resumes in the other.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
import lws_tpu.checkpoint as jck
from lws_torch import checkpoint as tck

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def proc():
    return lws_torch.LWS(512, 128, batch_iterations=12, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def spec(proc):
    rng = np.random.default_rng(11)
    x = (np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)
         + 0.1 * rng.standard_normal(16000))
    return np.abs(proc.stft(x)).astype(np.complex128)


def test_chunked_matches_single_call_quality(proc, spec, tmp_path):
    full = proc.batch_lws(spec, iterations=12)
    chunked = tck.resumable_lws(proc, spec, stage="batch", iterations=12,
                                checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=5)
    assert chunked.dtype == np.complex128 and chunked.shape == spec.shape
    np.testing.assert_allclose(np.abs(chunked), np.abs(spec), rtol=1e-9, atol=1e-12)
    assert abs(float(proc.get_consistency(full)) - float(proc.get_consistency(chunked))) < 0.05
    assert not os.path.exists(tmp_path / "c.npz")  # cleaned up on success


class Boom(RuntimeError):
    pass


def _interrupt_after(n):
    def bomb(done, total):
        if done >= n:
            raise Boom()
    return bomb


def test_resume_bitexact_after_interruption(proc, spec, tmp_path):
    path = str(tmp_path / "resume.npz")
    ref = tck.resumable_lws(proc, spec, stage="batch", iterations=12, checkpoint_path=path,
                            checkpoint_every=4)
    with pytest.raises(Boom):
        tck.resumable_lws(proc, spec, stage="batch", iterations=12, checkpoint_path=path,
                          checkpoint_every=4, progress=_interrupt_after(8))
    assert tck.load_checkpoint(path)[2] == 8
    out = tck.resumable_lws(proc, spec, stage="batch", iterations=12, checkpoint_path=path,
                            checkpoint_every=4)
    np.testing.assert_array_equal(out, ref)
    assert not os.path.exists(path)


def test_fingerprint_mismatch_refused(proc, spec, tmp_path):
    path = str(tmp_path / "fp.npz")
    z = np.zeros((3, 5), np.float32)
    tck.save_checkpoint(path, z, torch.zeros(3, 5), 2, fingerprint="deadbeef")
    with pytest.raises(tck.CheckpointMismatch):
        tck.resumable_lws(proc, spec, stage="batch", iterations=12, checkpoint_path=path,
                          checkpoint_every=4)
    got = tck.load_checkpoint(path)  # without a fingerprint: inspection
    assert got is not None and got[2] == 2 and isinstance(got[1], np.ndarray)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".ckpt-")]  # no temp left


def test_transient_failure_retried(proc, spec, tmp_path, monkeypatch):
    calls = {"n": 0}
    real = proc.batch_lws

    def flaky(S, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated device loss")
        return real(S, **kw)

    monkeypatch.setattr(proc, "batch_lws", flaky)
    with pytest.warns(UserWarning, match="retry 1/2"):
        out = tck.resumable_lws(proc, spec, stage="batch", iterations=8,
                                checkpoint_path=str(tmp_path / "r.npz"), checkpoint_every=4,
                                max_retries=2)
    monkeypatch.undo()
    ref = tck.resumable_lws(proc, spec, stage="batch", iterations=8, checkpoint_every=4)
    np.testing.assert_array_equal(out, ref)


def test_lazy_failure_retries_from_prechunk_state(proc, spec, tmp_path, monkeypatch):
    """A fault that shows only when the result reaches the host (a CUDA
    fault surfaces at the copy) retries from the state before the chunk,
    not from the failed call's output (which would apply the chunk's
    thresholds twice)."""
    armed = {"on": True}

    class LazyFault:
        def __init__(self, t):
            self._arr = t.numpy()

        def __array__(self, dtype=None, copy=None):
            if armed["on"]:
                armed["on"] = False
                raise RuntimeError("simulated lazy device fault")
            return self._arr if dtype is None else self._arr.astype(dtype)

    real = proc.batch_lws
    calls = {"n": 0}

    def flaky(S, **kw):
        calls["n"] += 1
        out = real(S, **kw)
        return (LazyFault(out[0]), LazyFault(out[1])) if calls["n"] == 2 else out

    monkeypatch.setattr(proc, "batch_lws", flaky)
    with pytest.warns(UserWarning, match="retry 1/2"):
        out = tck.resumable_lws(proc, spec, stage="batch", iterations=8,
                                checkpoint_path=str(tmp_path / "lf.npz"), checkpoint_every=4)
    monkeypatch.undo()
    ref = tck.resumable_lws(proc, spec, stage="batch", iterations=8, checkpoint_every=4)
    np.testing.assert_array_equal(out, ref)


def test_retries_exhausted_raises(proc, spec, monkeypatch):
    def dead(S, **kw):
        raise RuntimeError("permanent failure")

    monkeypatch.setattr(proc, "batch_lws", dead)
    with pytest.raises(RuntimeError, match="permanent failure"), pytest.warns(UserWarning):
        tck.resumable_lws(proc, spec, stage="batch", iterations=8, checkpoint_every=4,
                          max_retries=2)


def test_nofuture_stage_and_pair_io(proc, spec, tmp_path):
    pair = (torch.tensor(spec.real), torch.tensor(spec.imag))
    out = tck.resumable_lws(proc, pair, stage="nofuture", iterations=6,
                            checkpoint_path=str(tmp_path / "nf.npz"), checkpoint_every=3)
    assert isinstance(out, tuple) and len(out) == 2 and out[0].dtype == np.float64
    c0 = float(proc.get_consistency(out))
    c1 = float(proc.get_consistency(proc.nofuture_lws(spec, iterations=6)))
    assert abs(c0 - c1) < 0.3 and c0 > 10


def test_stage_and_mesh_contract(proc, spec):
    with pytest.raises(ValueError, match="unsupported stage"):
        tck.resumable_lws(proc, spec, stage="online", iterations=4)
    with pytest.raises(ValueError, match="batch stage only"):
        tck.resumable_lws(proc, spec, stage="nofuture", iterations=2, mesh=object())
    # forwarded to batch_lws: a mesh of one rank, no process group
    from lws_torch.parallel import make_mesh
    out = tck.resumable_lws(proc, spec, iterations=4, checkpoint_every=2,
                            mesh=make_mesh(1, 1, device="cpu"))
    np.testing.assert_allclose(out, tck.resumable_lws(proc, spec, iterations=4,
                                                      checkpoint_every=2), rtol=0, atol=1e-12)


def test_fingerprint_equals_lws_tpu():
    t32 = lws_torch.LWS(512, 128, device="cpu")
    t64 = lws_torch.LWS(512, 128, dtype=torch.float64, device="cpu")
    j32 = lws_tpu.LWS(512, 128, dtype=jnp.float32)
    j64 = lws_tpu.LWS(512, 128, dtype=jnp.float64)
    thr = lws_tpu.get_thresholds(12, 100, 0.1, 1)
    for t, j in ((t32, j32), (t64, j64)):
        for stage in ("batch", "nofuture"):
            assert (tck._fingerprint(t, stage, torch.Size((2, 63, 257)), thr)
                    == jck._fingerprint(j, stage, (2, 63, 257), thr))
    assert tck._fingerprint(t32, "batch", (2, 63, 257), thr) != \
        tck._fingerprint(t64, "batch", (2, 63, 257), thr)


@pytest.mark.parametrize("writer", ["lws_tpu", "lws_torch"])
def test_checkpoint_crosses_packages(spec, tmp_path, writer):
    """A run interrupted after 8 of 12 sweeps in one package resumes in the
    other: the last chunk starts from the npz's state, so the result is
    the reader's uninterrupted checkpointed run within 1e-9 x max amp (the
    two packages' float64 sweeps differ in the last bits)."""
    t = lws_torch.LWS(512, 128, batch_iterations=12, dtype=torch.float64, device="cpu")
    j = lws_tpu.LWS(512, 128, batch_iterations=12, dtype=jnp.float64)
    first, then = (jck, tck) if writer == "lws_tpu" else (tck, jck)
    procs = {jck: j, tck: t}
    path = str(tmp_path / "x.npz")
    with pytest.raises(Boom):
        first.resumable_lws(procs[first], spec, iterations=12, checkpoint_path=path,
                            checkpoint_every=4, progress=_interrupt_after(8))
    assert then.load_checkpoint(path)[2] == 8
    out = np.asarray(then.resumable_lws(procs[then], spec, iterations=12,
                                        checkpoint_path=path, checkpoint_every=4))
    assert not os.path.exists(path)  # resumed, not refused, and cleaned up
    ref = np.asarray(then.resumable_lws(procs[then], spec, iterations=12, checkpoint_every=4))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9 * np.abs(spec).max())
