#!/usr/bin/env python3
"""The port's quality against the reference, on the CPU in float64: the
counterpart of tools/quality_report.py for lws_torch's plain path.

    JAX_PLATFORMS=cpu python port_tools/quality_report.py

Two tables, each with its gates; exits 1 when a gate fails:

  goldens   the six reference goldens (tests/golden/ref_*.npz) through
            lws_torch.LWS(..., dtype=float64, device="cpu") at
            tests/test_pipeline.py's gates: batch (100 sweeps from |S|) >
            the reference C core's consistency - 0.5 dB, online (no-future
            1, online 10) > reference - 1.0, run_lws (no-future 1, online
            10, batch 100) > reference - 0.4, and the mean run_lws delta
            over the six > 0 dB. The no-future column is shown ungated.
  oracle    the three bench-scale anchors of tests/test_oracle.py:101-153
            (bench q4 (628, 257) at 100 sweeps, the longform slice (519,
            2049) at 30, vocoder q8 (223, 1025) at 100; bench.py-style
            mixtures from a seed): the port's batch_lws against the float64
            C++ oracle of the reference loops (lws_tpu.oracle, built with
            g++) on the same |S| and weights, gate port > oracle - 0.25 dB,
            magnitudes kept to 1e-8.

It imports lws_tpu for its oracle only; the port's side runs lws_torch
alone. A few minutes on the CPU (the anchors' plain frame loops).
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import torch  # noqa: E402

import lws_torch  # noqa: E402
from lws_torch import get_thresholds  # noqa: E402
from lws_tpu import oracle  # noqa: E402

F64 = torch.float64
GATES = dict(batch=-0.5, online=-1.0, run=-0.4, oracle=-0.25)


def proc(fsize, fshift, **kw):
    return lws_torch.LWS(fsize, fshift, dtype=F64, device="cpu", **kw)


def consistency(p, S):
    return float(np.mean(p.get_consistency(S)))


def goldens():
    """(rows, failures): one row per golden, its consistencies and the
    reference C core's."""
    rows, fails = [], []
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "ref_*.npz"))):
        name = os.path.basename(path)[4:-4]
        with np.load(path) as z:
            g = {k: z[k] for k in z.files}
        fs, sh, L = int(g["fsize"]), int(g["fshift"]), int(g["L"])
        p = proc(fs, sh, L=L, nofuture_iterations=1, online_iterations=10)
        A = np.abs(g["S"]).astype(np.complex128)
        S0 = p.nofuture_lws(A, thresholds=get_thresholds(1, 1, 0.1, 1))
        S1 = p.online_lws(S0, thresholds=get_thresholds(10, 1, 0.1, 1))
        B = p.batch_lws(A, thresholds=get_thresholds(100, 100, 0.1, 1))
        R = p.run_lws(A)
        row = dict(name=name, Q=int(g["Q"]), frac=g["W"].shape[0] != int(g["Q"]), L=L,
                   nofuture=(consistency(p, S0), float(g["consistency_nofuture_anyq"])),
                   online=(consistency(p, S1), float(g["consistency_online"])),
                   batch=(consistency(p, B), float(g["consistency_batch"])),
                   run=(consistency(p, R), float(g["consistency_run"])))
        for stage in ("batch", "online", "run"):
            c, ref = row[stage]
            if not c > ref + GATES[stage]:
                fails.append(f"{name} {stage}: {c:.4f} dB vs reference {ref:.4f} "
                             f"(gate {GATES[stage]:+g} dB)")
        if not np.allclose(np.abs(B), np.abs(A), rtol=1e-9, atol=1e-9):
            fails.append(f"{name} batch: magnitudes not kept")
        rows.append(row)
    mean = float(np.mean([r["run"][0] - r["run"][1] for r in rows]))
    if not mean > 0:
        fails.append(f"mean run_lws delta {mean:+.4f} dB (gate > 0)")
    return rows, mean, fails


def bench_mixture(n, sr_hz, seed):
    """tests/test_oracle.py's bench.py-style mixture (tone + tone + chirp +
    noise), same seed and formula."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr_hz
    return (0.5 * np.sin(2 * np.pi * 240 * t)
            + 0.3 * np.sin(2 * np.pi * 1128 * t)
            + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t / t[-1]) * t)
            + 0.05 * rng.standard_normal(n))


# name, (fsize, fshift), (samples, rate, seed), sweeps: tests/test_oracle.py:101-153
ANCHORS = (("bench q4", (512, 128), (80000, 16000, 0), 100),
           ("longform slice", (4096, 1024), (int(11.0 * 48000), 48000, 4), 30),
           ("vocoder q8", (2048, 256), (int(2.5 * 22050), 22050, 3), 100))


def anchors():
    rows, fails = [], []
    for name, (fs, sh), (n, rate, seed), sweeps in ANCHORS:
        p = proc(fs, sh)
        A = np.abs(p.stft(bench_mixture(n, rate, seed))).astype(np.complex128)
        thr = get_thresholds(sweeps, 100, 0.1, 1)
        out = p.batch_lws(A, thresholds=thr)
        ref = oracle.oracle_sweeps(A, p.W, thr)
        c, c_ref = consistency(p, out), consistency(p, ref)
        mag = float(np.abs(np.abs(out) - np.abs(A)).max())
        rows.append(dict(name=name, shape=A.shape, sweeps=sweeps, port=c, oracle=c_ref, mag=mag))
        if not c > c_ref + GATES["oracle"]:
            fails.append(f"{name}: {c:.4f} dB vs oracle {c_ref:.4f} (gate {GATES['oracle']:+g})")
        if mag > 1e-8:
            fails.append(f"{name}: magnitudes off by {mag:.3e} (tol 1e-8)")
    return rows, fails


def main():
    if not oracle.available():
        print("quality_report: the g++ oracle (lws_tpu.oracle) does not build here",
              file=sys.stderr)
        return 2
    print(f"lws_torch plain path, float64, CPU (torch {torch.__version__})\n")
    rows, mean, fails = goldens()
    print("| config | Q | frac | L | nofuture (ref) | online (ref, gate -1.0) | "
          "batch-100 (ref, gate -0.5) | run_lws (ref, gate -0.4) | run_lws delta |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        cells = " | ".join(f"{r[k][0]:.4f} ({r[k][1]:.4f})"
                           for k in ("nofuture", "online", "batch", "run"))
        print(f"| {r['name']} | {r['Q']} | {'y' if r['frac'] else ''} | {r['L']} | {cells} | "
              f"{r['run'][0] - r['run'][1]:+.3f} |")
    for k in ("batch", "online", "run"):
        d = [r[k][0] - r[k][1] for r in rows]
        print(f"{k}: port - reference from {min(d):+.3f} to {max(d):+.3f} dB")
    print(f"mean run_lws delta vs reference: {mean:+.3f} dB (gate > 0)\n")
    arows, afails = anchors()
    print("| anchor | (T, F) | sweeps | port dB | oracle dB | delta (gate -0.25) | "
          "max ||out| - |in|| |")
    print("|---|---|---|---|---|---|---|")
    for r in arows:
        print(f"| {r['name']} | {r['shape']} | {r['sweeps']} | {r['port']:.4f} | "
              f"{r['oracle']:.4f} | {r['port'] - r['oracle']:+.3f} | {r['mag']:.1e} |")
    fails += afails
    print("\n" + ("every gate passed" if not fails else "FAILED: " + "; ".join(fails)))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
