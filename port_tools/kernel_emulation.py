#!/usr/bin/env python3
"""A numpy emulation of the control flow of lws_torch/csrc/lws_sweeps.cu,
held against the plain PyTorch sweeps (lws_torch.core.batch.lws_sweeps) in
float64 on the CPU.

The emulation follows the kernel step by step: the padded state with frozen
halo rows, the conjugate reflection of the frequency margins on read, the
off-centre taps in (dr, dk) order, the centre-row passes ping-ponged between
two buffers (jacobi falls back to the original centre row, colorKxR to the
evolving one), and the per-(utterance, sweep) live flags and thresholds of
the wrapper. Agreement to float64 rounding shows that the kernel's schedule
computes what the plain version computes; only the card can show that the
CUDA code follows the emulation (chip_smoke.py).

    python port_tools/kernel_emulation.py

Runs the golden geometries q4, q2, frac and q8 on 20 frames, each with the
batch stencil at its default in-frame scheme, the no-future stencil and the
batch stencil at one jacobi pass, with and without halo= / mean_amp=.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lws_torch  # noqa: E402
from lws_torch.core.batch import lws_sweeps  # noqa: E402
from lws_torch.ops.lws_sweeps import _schedule_args, sweep_schedule  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "tests", "golden")


def read_bins(row_r, row_i, j, F):
    """The kernel's read_bin for all bins at once: conjugate reflection
    outside [0, F-1]."""
    jj = np.where(j < 0, -j, np.where(j > F - 1, 2 * (F - 1) - j, j))
    sign = np.where((j < 0) | (j > F - 1), -1.0, 1.0)
    return row_r[jj], sign * row_i[jj]


def phase(fr, fi, a, th, fb_r, fb_i, mask=True):
    a2 = fr * fr + fi * fi
    scale = a / np.sqrt(np.where(a2 > 0, a2, 1.0))
    cond = (a > th) & (a2 > 0) & mask
    return np.where(cond, fr * scale, fb_r), np.where(cond, fi * scale, fb_i)


def emulate(sr, si, st, thresholds, inner_passes, inner_scheme, halo=None, mean_amp=None):
    B, T, F = sr.shape
    Q1, R, K, L = st.Q - 1, 2 * st.Q - 1, 2 * st.L + 1, st.L
    amp, thr, live = (t.numpy() for t in sweep_schedule(sr, si, torch.as_tensor(thresholds),
                                                         mean_amp))
    passes, color_k, rounds, has_centre = _schedule_args(st, inner_passes, inner_scheme)
    n_pass = (color_k * rounds if color_k > 0 else passes) if has_centre else 0
    Wr, Wi = st.Wr.numpy(), st.Wi.numpy()
    planes = []
    for plane, top, bot in ((sr.numpy(), 0, 2), (si.numpy(), 1, 3)):
        x = np.empty((B, T + 2 * Q1, F))
        x[:, Q1:Q1 + T] = plane
        x[:, :Q1] = plane[:, :1] if halo is None else halo[top].numpy()
        x[:, Q1 + T:] = plane[:, -1:] if halo is None else halo[bot].numpy()
        planes.append(x)
    xr, xi = planes
    n = np.arange(F)

    def taps(row_r, row_i, dr, tr, ti):
        """Adds row dr's taps to (tr, ti), one by one in dk order."""
        for dk in range(K):
            br, bi = read_bins(row_r, row_i, n + dk - L, F)
            wr, wi = Wr[dr, dk], Wi[dr, dk]
            tr = tr + (wr * br - wi * bi)
            ti = ti + (wr * bi + wi * br)
        return tr, ti

    for b in range(B):
        Xr, Xi = xr[b], xi[b]
        for it in range(len(thresholds)):
            if not live[b, it]:
                continue
            th = thr[b, it]
            for m in range(T):
                a, cen = amp[b, m], m + Q1
                tr, ti = np.zeros(F), np.zeros(F)
                for dr in range(R):
                    if dr != Q1:
                        tr, ti = taps(Xr[m + dr], Xi[m + dr], dr, tr, ti)
                if n_pass == 0:
                    Xr[cen], Xi[cen] = phase(tr, ti, a, th, Xr[cen], Xi[cen])
                    continue
                src = (Xr[cen].copy(), Xi[cen].copy())
                for p in range(n_pass):
                    cr, ci = taps(*src, Q1, np.zeros(F), np.zeros(F))
                    if color_k > 0:
                        new = phase(tr + cr, ti + ci, a, th, *src, mask=n % color_k == p % color_k)
                    else:
                        new = phase(tr + cr, ti + ci, a, th, Xr[cen], Xi[cen])
                    if p + 1 == n_pass:
                        Xr[cen], Xi[cen] = new
                    else:
                        src = new
    return xr[:, Q1:Q1 + T], xi[:, Q1:Q1 + T]


def main():
    rng = np.random.default_rng(0)
    thr = lws_torch.get_thresholds(3, 1, 0.1, 1)
    worst = 0.0
    for name in ("q4", "q2", "frac", "q8"):
        g = dict(np.load(os.path.join(GOLDEN, f"ref_{name}.npz")))
        p = lws_torch.LWS(int(g["fsize"]), int(g["fshift"]), L=int(g["L"]),
                          dtype=torch.float64, device="cpu")
        A = np.abs(g["S"])[None, :20]
        A = np.concatenate([A, 0.5 * A * rng.random(A.shape)])
        sr = torch.tensor(A)
        si = torch.tensor(rng.standard_normal(A.shape) * 0.1)
        for st, ip, scheme in ((p._st_batch, p.batch_inner_passes, p.inner_scheme),
                               (p._st_nofuture, 1, "jacobi"),
                               (p._st_batch, 1, "jacobi")):
            Q1 = st.Q - 1
            halo = tuple(torch.tensor(rng.standard_normal((2, Q1, A.shape[-1])))
                         for _ in range(4))
            for h, mean in ((None, None), (halo, torch.tensor([1.5, 0.3]))):
                er, ei = emulate(sr, si, st, thr, ip, scheme, h, mean)
                pr, pi = lws_sweeps(sr, si, st, torch.tensor(thr), inner_passes=ip,
                                    inner_scheme=scheme, halo=h, mean_amp=mean)
                d = max(np.abs(er - pr.numpy()).max(), np.abs(ei - pi.numpy()).max())
                worst = max(worst, d)
                print(f"{name} Q={st.Q} {scheme} passes={ip} centre={st.has_centre} "
                      f"halo/mean={h is not None}: max|emulation - plain| {d:.3g}")
    print(f"worst {worst:.3g}")


if __name__ == "__main__":
    main()
