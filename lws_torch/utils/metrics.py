"""Observability: per-stage metrics and device profiling.

Counterpart of lws_tpu/utils/metrics.py. `run_with_metrics` runs the
3-stage pipeline and returns per-stage numbers (wall time, consistency dB,
real-time factor); each stage's wall is the host clock around the stage and
a `torch.cuda.synchronize` of the processor's device (no synchronise off
CUDA), so it holds the stage's device work. `trace` wraps `torch.profiler`
(CPU and, where there is a card, CUDA activities) and writes a Chrome trace
of the block into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["StageMetrics", "run_with_metrics", "trace"]


@dataclass
class StageMetrics:
    stage: str
    wall_s: float
    consistency_db: float
    audio_seconds: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_s if self.wall_s > 0 else float("inf")

    def __str__(self):
        rt = f", {self.realtime_factor:8.1f}x realtime" if self.audio_seconds else ""
        return (f"{self.stage:10s}: {self.wall_s * 1000:8.1f} ms, "
                f"{self.consistency_db:7.2f} dB{rt}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_with_metrics(proc, S, sample_rate: float | None = None):
    """Run no-future -> online -> batch with per-stage instrumentation.

    S: magnitude (or complex) spectrogram(s), (..., T, F), or an (sr, si)
    pair. Returns (recovered, [StageMetrics]) with the input's consistency
    first; `recovered` has the input's form (host complex array or pair).
    """
    pair = proc._as_pair(S)
    n_frames = pair[0].shape[-2]
    batch = int(np.prod(pair[0].shape[:-2])) if pair[0].ndim > 2 else 1
    audio_s = (batch * n_frames * proc.fshift / sample_rate) if sample_rate else 0.0

    def consistency(p):
        return float(proc.get_consistency(p).mean())

    metrics = [StageMetrics("input", 0.0, consistency(pair), audio_s)]
    stages = [("no-future", proc.nofuture_lws),
              ("online", proc.online_lws),
              ("batch", proc.batch_lws)]
    for name, fn in stages:
        _sync(proc.device)
        t0 = time.perf_counter()
        pair = fn(pair)
        _sync(proc.device)
        wall = time.perf_counter() - t0
        metrics.append(StageMetrics(name, wall, consistency(pair), audio_s))
    out = pair if proc._is_pair(S) else proc._ret(pair, False)
    return out, metrics


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with torch.profiler and write its Chrome
    trace to `log_dir`/trace-<pid>-<ns>.json (view in Perfetto or
    chrome://tracing):

        with lws_torch.utils.trace("traces"):
            proc.batch_lws(S)

    CUDA activities are recorded where a card is present; the block's device
    work is synchronised before the trace is written.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
