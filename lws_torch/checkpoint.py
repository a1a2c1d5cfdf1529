"""Checkpoint / resume / failure recovery for long-running LWS jobs.

Counterpart of lws_tpu/checkpoint.py. The whole iteration state of a sweep
stage is the evolving (sr, si) planes and the sweep index (the magnitudes
are invariant under LWS updates), so a job can be cut at any sweep
boundary, persisted and resumed bit for bit. `resumable_lws` runs the
processor's batch or no-future stage in chunks of `checkpoint_every`
sweeps with

- atomic checkpoints (a temp file in the target directory, then a rename:
  a crash while writing never corrupts the previous checkpoint);
- a fingerprint of the job (geometry, stage, shape, dtype, threshold
  schedule), equal to lws_tpu's for the same job, so a stale or foreign
  checkpoint is refused and an npz written by either package resumes in
  the other;
- retries: a chunk that fails (a CUDA fault, an out-of-memory race) runs
  again from the state before the chunk, up to `max_retries` times.

The state is fetched to the host inside the `try`, so a fault that surfaces
only when the card synchronises is retried and never applies a chunk twice.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import time
import warnings

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "resumable_lws", "CheckpointMismatch"]


class CheckpointMismatch(RuntimeError):
    """A checkpoint exists but was written by an incompatible job."""


def _np_dtype(proc):
    """The processor's real dtype as numpy's (np.float32 / np.float64)."""
    return np.dtype(str(proc.rdtype).removeprefix("torch."))


def _fingerprint(proc, stage, shape, thresholds):
    h = hashlib.sha256()
    h.update(repr((proc.fsize, proc.fshift, proc.fftsize, stage,
                   tuple(int(n) for n in shape), str(_np_dtype(proc)))).encode())
    h.update(np.ascontiguousarray(np.asarray(thresholds, np.float64)).tobytes())
    return h.hexdigest()[:32]


def _host(x):
    """A tensor or array as a host numpy array (waits for the card)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_checkpoint(path, sr, si, it, fingerprint=""):
    """Atomically persist the sweep state: the (sr, si) planes (tensors or
    arrays, stored as host arrays) and the iteration index."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, sr=_host(sr), si=_host(si), it=np.int64(it),
                     fingerprint=np.str_(fingerprint), wall=np.float64(time.time()))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path, fingerprint=None):
    """Load a checkpoint; returns (sr, si, it) as host arrays, or None if
    absent. With `fingerprint`, a checkpoint of another job raises
    CheckpointMismatch."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        got = str(z["fingerprint"])
        if fingerprint is not None and got != fingerprint:
            raise CheckpointMismatch(
                f"checkpoint {path} was written by a different job "
                f"(fingerprint {got} != expected {fingerprint}); delete it "
                "or point checkpoint_path elsewhere")
        return z["sr"], z["si"], int(z["it"])


def resumable_lws(proc, S, stage="batch", iterations=None, thresholds=None,
                  checkpoint_path=None, checkpoint_every=25, max_retries=2,
                  cleanup=True, progress=None, mesh=None, **stage_kwargs):
    """Run a multi-sweep LWS stage with periodic checkpoints and retries.

    proc: an `lws_torch.LWS` processor. S: a complex array or an (sr, si)
    pair, as the stage methods take. stage: "batch" or "nofuture" (the
    online stage is one pass over frames and does not cut into chunks of
    sweeps; StreamingLWS carries its state). If a valid checkpoint exists at
    `checkpoint_path`, the run resumes from its iteration. checkpoint_every:
    sweeps per chunk, one stage call each. progress: an optional callback
    (done, total) after each chunk. cleanup: delete the checkpoint on
    success. mesh / **stage_kwargs: forwarded to the stage (mesh=, kernel=,
    sweeps_per_exchange= to the time-sharded batch stage, as lws_tpu).

    Returns a host complex array for a complex array, a host (sr, si) pair
    of arrays for a pair, as lws_tpu does.
    """
    if stage not in ("batch", "nofuture"):
        raise ValueError(f"unsupported stage {stage!r} (batch or nofuture)")
    stage_fn = getattr(proc, f"{stage}_lws")
    if mesh is not None:
        if stage != "batch":
            raise ValueError("mesh sharding applies to the batch stage only")
        stage_kwargs = dict(stage_kwargs, mesh=mesh)
    if iterations is None:
        iterations = getattr(proc, f"{stage}_iterations")
    if thresholds is None:
        from .windows import get_thresholds
        thresholds = get_thresholds(
            iterations, *(getattr(proc, f"{stage}_{k}") for k in ("alpha", "beta", "gamma")))
    thr = np.asarray(thresholds, dtype=np.float64)
    n = thr.shape[0]
    dtype = _np_dtype(proc)

    was_pair = proc._is_pair(S)
    sr, si = proc._as_pair(S)
    fp = _fingerprint(proc, stage, sr.shape, thr)

    start = 0
    if checkpoint_path is not None:
        state = load_checkpoint(checkpoint_path, fingerprint=fp)
        if state is not None:
            csr, csi, start = state
            if start > n:
                raise CheckpointMismatch(
                    f"checkpoint at iteration {start} exceeds the requested {n} iterations")
            sr, si = np.asarray(csr, dtype=dtype), np.asarray(csi, dtype=dtype)

    every = max(1, int(checkpoint_every))
    k = start
    while k < n:
        chunk = thr[k:k + every]
        attempt = 0
        while True:
            try:
                # (sr, si) stay the state before the chunk until its result
                # is on the host: a CUDA fault can surface only at the copy,
                # and a retry from the failed call's output would apply the
                # chunk's thresholds twice
                nsr, nsi = stage_fn((sr, si), thresholds=chunk, **stage_kwargs)
                sr, si = _host(nsr), _host(nsi)
                break
            except (KeyboardInterrupt, CheckpointMismatch, NotImplementedError):
                raise
            except Exception as e:  # noqa: BLE001 - device and runtime faults
                attempt += 1
                if attempt > max_retries:
                    raise
                warnings.warn(
                    f"lws_torch.checkpoint: {stage} chunk at iteration {k} failed "
                    f"({type(e).__name__}: {e}); retry {attempt}/{max_retries} from the "
                    "state before the chunk")
        k += chunk.shape[0]
        if checkpoint_path is not None and k < n:
            save_checkpoint(checkpoint_path, sr, si, k, fingerprint=fp)
        if progress is not None:
            progress(k, n)

    if checkpoint_path is not None and cleanup and os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    sr, si = _host(sr).astype(dtype, copy=False), _host(si).astype(dtype, copy=False)
    return (sr, si) if was_pair else sr + 1j * si
