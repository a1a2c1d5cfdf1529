"""End-to-end phase recovery demo and timing harness.

The port's version of examples/run_lws.py (the reference MATLAB demo,
matlab/run_lws.m): load or synthesise audio, take its magnitude STFT, run
the three LWS stages with per-stage wall time and consistency
(`lws_torch.utils.run_with_metrics`), and write the recovered audio.

    python -m lws_torch.examples.run_lws [input.wav] [output.wav] [--device cpu]

Without an input a synthetic tone + chirp is used (the reference ships no
test file either, run_lws.m:58).
"""
from __future__ import annotations

import argparse

import numpy as np

import lws_torch
from lws_torch.io import read_wav, write_wav
from lws_torch.utils import run_with_metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", help="a wav file (default: a synthetic 5 s signal)")
    ap.add_argument("output", nargs="?", default="recovered.wav")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.input:
        x, sr = read_wav(args.input)
    else:
        sr = 16000
        t = np.arange(5 * sr) / sr
        x = (0.5 * np.sin(2 * np.pi * 330 * t)
             + 0.3 * np.sin(2 * np.pi * 990 * t)
             + 0.25 * np.sin(2 * np.pi * (200 + 2500 * t / t[-1]) * t))

    # the reference demo's configuration: 512-point FFT, hop 128 (Q = 4),
    # L = 5 (matlab/run_lws.m:48-55); music mode = no-future + online + batch
    proc = lws_torch.LWS(512, 128, mode="music", device=args.device)
    X = proc.stft(x)
    S = np.abs(X).astype("complex64")
    print(f"spectrogram {X.shape} on {proc.device}")
    S, metrics = run_with_metrics(proc, S, sample_rate=sr)
    for m in metrics:
        print(m)
    y = proc.istft(S)
    write_wav(args.output, y, sr)
    print(f"wrote {args.output} ({len(y) / sr:.2f} s)")


if __name__ == "__main__":
    main()
