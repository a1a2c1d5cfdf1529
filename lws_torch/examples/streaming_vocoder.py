"""Streaming vocoder serving: mel frames in, committed audio out.

The port's version of examples/streaming_vocoder.py: a stand-in acoustic
model emits mel frames; each block of frames is inverted to linear
magnitudes (`mel_to_linear`) and pushed through N streams of online
RTISI-LA in one chunk launch (`StreamingLWS.push_frames`), and committed
audio comes back at a fixed latency of look_ahead + 1 frames. Per-push
latency percentiles come from StreamingLWS.stats.

    python -m lws_torch.examples.streaming_vocoder [n_streams] [seconds] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

import lws_torch
from lws_torch.mel import linear_to_mel, mel_filterbank, mel_to_linear


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("streams", nargs="?", type=int, default=4)
    ap.add_argument("seconds", nargs="?", type=float, default=5.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    streams, secs = args.streams, args.seconds
    sr_hz, fsize, fshift, n_mels = 16000, 512, 128, 80

    # stand-in acoustic model: mel spectrograms of synthetic voiced mixtures
    # (in production these frames arrive from a TTS decoder)
    t = np.arange(int(secs * sr_hz)) / sr_hz
    rng = np.random.default_rng(0)
    x = np.stack([
        0.5 * np.sin(2 * np.pi * (140 + 30 * i) * t)
        + 0.3 * np.sin(2 * np.pi * (140 + 30 * i) * 4.1 * t)
        + 0.02 * rng.standard_normal(t.size)
        for i in range(streams)
    ])
    proc = lws_torch.LWS(fsize, fshift, look_ahead=3, online_iterations=10,
                         device=args.device)
    fb = mel_filterbank(n_mels, fsize, sr_hz)
    sr, si = proc.stft_ri(x)
    mel_frames = linear_to_mel((sr * sr + si * si).sqrt(), fb)  # (S, T, n_mels)
    T = mel_frames.shape[1]
    print(f"{streams} streams x {T} mel frames ({secs:.1f} s at {sr_hz} Hz) on {proc.device}")

    block = 16
    stream = lws_torch.StreamingLWS(proc, streams=streams, emit="host", block_frames=block)
    print(f"block {block} frames, latency {stream.latency_frames} frames "
          f"({stream.latency_frames * fshift / sr_hz * 1000:.0f} ms)")
    # warm-up: the first launch builds the kernel; keep it out of the report
    stream.push_frames(mel_frames.new_zeros((block, streams, fsize // 2 + 1)))
    stream.flush()
    stream.reset()
    stream.stats.reset()

    audio = []
    for i in range(0, T - T % block, block):
        # a block of decoded mel frames -> linear magnitudes -> one launch
        lin = mel_to_linear(mel_frames[:, i:i + block], fb)
        out = stream.push_frames(lin.transpose(0, 1))  # (block, S, F)
        if out.shape[-1]:
            audio.append(out)
    audio.append(stream.flush())
    y = np.concatenate([a for a in audio if a.shape[-1]], axis=-1)

    rep = stream.stats.summary(sample_rate=sr_hz)
    rt = rep["realtime_factor"]
    print(f"emitted {y.shape[-1] / sr_hz:.2f} s per stream; per-push latency "
          f"p50 {rep['p50_s'] * 1e3:.2f} ms, p95 {rep['p95_s'] * 1e3:.2f} ms, "
          f"p99 {rep['p99_s'] * 1e3:.2f} ms; {rt:.1f} x real time per stream "
          f"({rt * streams:.1f} x in all)")


if __name__ == "__main__":
    main()
