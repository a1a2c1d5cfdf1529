"""The three ways to run StreamingLWS, with their latency and throughput.

The port's version of examples/streaming_serve.py, on 8 streams:

1. throughput: emit="device", one chunk launch per 64-frame block, pushes
   in 0.5 s chunks, the audio collected after the last push;
2. low latency: emit="device", block_frames=1: a push enqueues one 8 ms hop
   and the consumer reads its audio a few pushes behind;
3. host-synchronous: emit="host", each push returns its audio on the host
   (block_frames=8, 64 ms of audio per push).

    python -m lws_torch.examples.streaming_serve [seconds] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from lws_torch import LWS, StreamingLWS


def make_audio(streams, secs, sr_hz):
    t = np.arange(int(secs * sr_hz)) / sr_hz
    rng = np.random.default_rng(0)
    return np.stack([
        0.5 * np.sin(2 * np.pi * (140 + 30 * i) * t)
        + 0.3 * np.sin(2 * np.pi * (140 + 30 * i) * 4.1 * t)
        + 0.02 * rng.standard_normal(t.size)
        for i in range(streams)
    ]).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seconds", nargs="?", type=float, default=5.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    secs, streams, sr_hz, hop = args.seconds, 8, 16000, 128
    x = make_audio(streams, secs, sr_hz)
    proc = LWS(512, 128, look_ahead=3, online_iterations=10, device=args.device)

    # 1. throughput: one launch per 64-frame block, collected at the end
    s = StreamingLWS(proc, streams=streams, emit="device", block_frames=64)
    chunk = 8000
    for i in range(0, x.shape[-1], chunk):  # warm-up (kernel build, first launches)
        s.push_block(x[:, i:i + chunk])
    s.flush()
    s.reset()
    t0 = time.perf_counter()
    outs = [s.push_block(x[:, i:i + chunk]) for i in range(0, x.shape[-1], chunk)]
    outs.append(s.flush())
    audio = np.concatenate([s.fetch(o) for o in outs if o.shape[-1]], axis=-1)
    wall = time.perf_counter() - t0
    print(f"throughput point : {streams * secs:.0f} s of audio in {wall * 1e3:.0f} ms "
          f"({streams * secs / wall:.0f} audio-s/s, {audio.shape[-1]} samples per stream)")

    # 2. low latency: one hop per push, the consumer `lag` pushes behind
    lo = StreamingLWS(proc, streams=streams, emit="device", block_frames=1)
    for i in range(0, 16 * hop, hop):  # warm-up, fills the look-ahead
        lo.push_block(x[:, i:i + hop])
    lo.stats.reset()
    n_push, lag, pending = 64, 8, []
    t0 = time.perf_counter()
    for i in range(16 * hop, (16 + n_push) * hop, hop):
        pending.append(lo.push_block(x[:, i:i + hop]))
        if len(pending) > lag:
            lo.fetch(pending.pop(0))
    for o in pending:
        lo.fetch(o)
    amort = (time.perf_counter() - t0) / n_push
    p = lo.stats.summary()
    print(f"low-latency point: enqueue p50 {p['p50_s'] * 1e3:.2f} ms, amortised "
          f"{amort * 1e3:.2f} ms per 8 ms hop ({hop / sr_hz / amort:.2f} x real time)")

    # 3. host-synchronous: 8 frames (64 ms of audio) per push
    sy = StreamingLWS(proc, streams=streams, emit="host", block_frames=8)
    sy.push_block(x[:, :8 * hop * 8])  # warm-up: 8 blocks
    sy.stats.reset()
    for i in range(8 * hop * 8, min(8 * hop * 40, x.shape[-1]), 8 * hop):
        sy.push_block(x[:, i:i + 8 * hop])
    p = sy.stats.summary()
    quantum_ms = 8 * hop / sr_hz * 1e3
    print(f"host-sync point  : p50 {p['p50_s'] * 1e3:.2f} ms per {quantum_ms:.0f} ms push "
          f"({'real time' if p['p50_s'] * 1e3 < quantum_ms else 'not real time'})")


if __name__ == "__main__":
    main()
