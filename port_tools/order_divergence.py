#!/usr/bin/env python3
"""How far two correct tap-summation orders of the Gauss-Seidel sweep drift
apart: lws_tpu's sequential `update_frame` (the order of the CUDA kernel)
against lws_torch's vectorised plain version, on the CPU.

This is the measurement behind chip_smoke.py's kernel-vs-plain tolerances:
from a zero-phase start (|X| with phase 0) many tap sums nearly cancel and
either order picks their phase, while from random-phase starts the two
orders stay close. Uses bench.py's mixture class at the main path's frame
count.

    JAX_PLATFORMS=cpu python port_tools/order_divergence.py [--full]

--full adds the 100-sweep consistency comparison (about a minute).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lws_torch  # noqa: E402
import lws_tpu  # noqa: E402
from chip_smoke import make_batch  # noqa: E402
from lws_torch.core.batch import lws_sweeps as torch_sweeps  # noqa: E402
from lws_tpu.core.batch import lws_sweeps as jax_sweeps  # noqa: E402


def both(start_r, start_i, fs, thr, dtype, passes=None):
    """(sequential, vectorised) results of the batch sweeps, numpy complex."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    pj = lws_tpu.LWS(fs, 128, dtype=jdt)
    pt = lws_torch.LWS(fs, 128, dtype=dtype, device="cpu")
    ip = pt.batch_inner_passes if passes is None else passes
    jr, ji = jax_sweeps(jnp.asarray(start_r, jdt), jnp.asarray(start_i, jdt), pj._st_batch,
                        jnp.asarray(thr, jdt), inner_passes=ip, inner_scheme=pt.inner_scheme)
    tr, ti = torch_sweeps(torch.tensor(start_r, dtype=dtype), torch.tensor(start_i, dtype=dtype),
                          pt._st_batch, torch.tensor(thr, dtype=dtype), inner_passes=ip,
                          inner_scheme=pt.inner_scheme)
    return (np.asarray(jr) + 1j * np.asarray(ji), tr.numpy() + 1j * ti.numpy(), pt)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    x = make_batch(4, 80000, 16000, np.random.default_rng(1))
    rng = np.random.default_rng(5)
    dense = lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:]
    sparse = lws_torch.get_thresholds(3, 1, 0.1, 1)
    for fs in (512, 256):
        sr, si = lws_torch.LWS(fs, 128, device="cpu").stft_ri(x)
        A = torch.sqrt(sr * sr + si * si).numpy()
        ph = rng.uniform(0, 2 * np.pi, A.shape)
        for start, (r0, i0) in (("zero-phase", (A, np.zeros_like(A))),
                                ("random-phase", (A * np.cos(ph), A * np.sin(ph)))):
            for sched, thr in (("alpha=100 last 3", dense), ("alpha=1 first 3", sparse)):
                a, b, _ = both(r0, i0, fs, thr, torch.float32)
                d = np.abs(a - b)
                print(f"LWS({fs},128) {tuple(A.shape)} float32 {start:12s} {sched}: "
                      f"max|d|/max amp {d.max() / A.max():.3g}, bins off by >1e-3 "
                      f"relative {np.mean(d / np.maximum(A, 1e-30) > 1e-3):.3g}")
    # float64 from a zero-phase start, one dense sweep
    sr, si = lws_torch.LWS(512, 128, device="cpu", dtype=torch.float64).stft_ri(
        x[:2].astype(np.float64))
    A = torch.sqrt(sr * sr + si * si).numpy()
    a, b, _ = both(A, np.zeros_like(A), 512, dense[:1], torch.float64, passes=3)
    print(f"LWS(512,128) {tuple(A.shape)} float64 zero-phase, 1 dense sweep: bins off by "
          f">1e-2 relative {np.mean(np.abs(a - b) / np.maximum(A, 1e-30) > 1e-2):.3g}")
    if args.full:
        x0 = make_batch(32, 80000, 16000, np.random.default_rng(0))[:2]
        pt = lws_torch.LWS(512, 128, device="cpu")
        sr, si = pt.stft_ri(x0)
        A = torch.sqrt(sr * sr + si * si).numpy()
        a, b, pt = both(A, np.zeros_like(A), 512, lws_torch.get_thresholds(100, 100, 0.1, 1),
                        torch.float32)
        ca = pt.get_consistency(a.astype(np.complex64))
        cb = pt.get_consistency(b.astype(np.complex64))
        print(f"main path utterances 0-1, 100 sweeps, float32: consistency {ca} vs {cb} dB, "
              f"max |d| {np.abs(ca - cb).max():.3g} dB")


if __name__ == "__main__":
    main()
