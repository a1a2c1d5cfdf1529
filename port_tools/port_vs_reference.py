#!/usr/bin/env python3
"""The disagreements between lws_torch's plain sweeps and lws_tpu found
while porting (logged in ROADMAP.md, Queue C), measured on the CPU.

    JAX_PLATFORMS=cpu python port_tools/port_vs_reference.py [SECTION ...]

Sections (a few minutes in all; all of them without arguments):
  nofuture-mean   no-future, float64, golden q4 with random phases, explicit
                  halo= and mean_amp= at 1.3 / 0.2 and 1.3 / 0.5 of the mean:
                  port vs lws_tpu, and lws_tpu against itself under a 1e-14
                  relative perturbation of the input;
  nofuture-f32    the one no-future sweep in float32 from the magnitudes of
                  0.8 s and 5 s bench mixtures (zero and random phase) and of
                  white noise (float32 and float64), max |d| / max amp;
  pallas          the plain port against the Pallas kernel itself
                  (lws_tpu.ops.tiled_lws_sweeps, interpret=True), float32,
                  golden q4, 2 sweeps at alpha=1, ip3;
  parity          batch_lws at 100 sweeps in float64 on every golden:
                  consistency of lws_tpu, of the port and of the reference C
                  core (the golden's consistency_batch);
  q32             LWS(256, 8, L=3) (Q=32, tests/test_oracle.py's geometry
                  and input), float64, 3 sweeps at alpha=1 from random
                  phases: the plain port against lws_tpu's Gauss-Seidel
                  sweeps (jitted; ~35 s of XLA compile), bin by bin, and both
                  against the reference float64 oracle (lws_tpu.oracle) by
                  consistency from the magnitudes.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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
from lws_tpu.ops import tiled_lws_sweeps  # noqa: E402

GOLDENS = ("q4", "q2", "frac", "q8", "q3", "q4L2")


def golden(name):
    return dict(np.load(os.path.join(ROOT, "tests", "golden", f"ref_{name}.npz")))


def nofuture(S, thr, dtype, **kw):
    """(lws_tpu, lws_torch) real parts after the no-future sweeps of S."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    pj = lws_tpu.LWS(512, 128, dtype=jdt)
    pt = lws_torch.LWS(512, 128, dtype=dtype, device="cpu")
    kj = {k: (tuple(jnp.asarray(h, jdt) for h in v) if k == "halo" else jnp.asarray(v, jdt))
          for k, v in kw.items()}
    kt = {k: (tuple(torch.tensor(h, dtype=dtype) for h in v) if k == "halo"
              else torch.tensor(v, dtype=dtype)) for k, v in kw.items()}
    jr = jax_sweeps(jnp.asarray(S.real, jdt), jnp.asarray(S.imag, jdt), pj._st_nofuture,
                    jnp.asarray(thr, jdt), **kj)[0]
    tr = torch_sweeps(torch.tensor(S.real, dtype=dtype), torch.tensor(S.imag, dtype=dtype),
                      pt._st_nofuture, torch.tensor(thr, dtype=dtype), **kt)[0]
    return np.asarray(jr), tr.numpy()


def nofuture_mean():
    rng = np.random.default_rng(11)
    A = np.abs(golden("q4")["S"])
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    S = np.stack([S, 0.5 * S[::-1]])
    thr = lws_torch.get_thresholds(3, 1, 0.1, 1)
    halo = [rng.standard_normal((2, 3, A.shape[-1])) for _ in range(4)]
    scale = np.abs(S).mean()
    for mm in ((1.3, 0.2), (1.3, 0.5)):
        mean = np.array(mm) * scale
        jr, tr = nofuture(S, thr, torch.float64, halo=halo, mean_amp=mean)
        print(f"nofuture-mean float64 q4 mean_amp {mm} x mean: port vs lws_tpu "
              f"max|d| {np.abs(tr - jr).max():.3g}")
        jp, _ = nofuture(S * (1 + 1e-14), thr, torch.float64, halo=halo, mean_amp=mean)
        print(f"nofuture-mean float64 q4 mean_amp {mm} x mean: lws_tpu vs lws_tpu with "
              f"input x (1 + 1e-14) max|d| {np.abs(jp - jr).max():.3g}")


def nofuture_f32():
    proc = lws_torch.LWS(512, 128, device="cpu")
    thr = lws_torch.get_thresholds(1, 1, 0.1, 1)
    for n in (12672, 80000):
        worst = {}
        for seed in (0, 1, 2):
            rng = np.random.default_rng(seed)
            A = np.abs(proc.stft(make_batch(2, n, 16000, rng)))
            for start in ("zero", "random"):
                S = A if start == "zero" else A * np.exp(2j * np.pi * rng.random(A.shape))
                jr, tr = nofuture(S, thr, torch.float32)
                rel = np.abs(jr - tr).max() / A.max()
                worst[start] = max(worst.get(start, 0.0), rel)
        for start, rel in worst.items():
            print(f"nofuture-f32 bench mixture {n / 16000:g} s, seeds 0-2, {start} phase: "
                  f"port vs lws_tpu max|d| / max amp {rel:.3g}")
    rng = np.random.default_rng(0)
    A = np.abs(rng.standard_normal((2, 100, 257)))
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    dense = lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:]
    for sched, th in (("1 sweep alpha=1", thr), ("alpha=100 last 3", dense)):
        for dtype in (torch.float32, torch.float64):
            jr, tr = nofuture(S, th, dtype)
            print(f"nofuture-f32 white-noise magnitudes (2, 100, 257) {sched} {dtype}: port vs "
                  f"lws_tpu max|d| / max amp {np.abs(jr - tr).max() / A.max():.3g}")


def pallas():
    g = golden("q4")
    p = lws_tpu.LWS(int(g["fsize"]), int(g["fshift"]), L=int(g["L"]), dtype=jnp.float32)
    A = np.abs(g["S"]).astype(np.float32)
    thr = np.asarray(lws_tpu.get_thresholds(2, 1, 0.1, 1), np.float32)
    kr, _ = tiled_lws_sweeps(jnp.asarray(A), jnp.zeros_like(jnp.asarray(A)), st=p._st_batch,
                             thresholds=jnp.asarray(thr), tile=16, micro=1, interpret=True,
                             inner_scheme=p.inner_scheme, inner_passes=p.batch_inner_passes)
    st = lws_torch.convert.stencil_from_numpy(
        np.asarray(p._st_batch.Wr), np.asarray(p._st_batch.Wi), p._st_batch.nz, 4, int(g["L"]),
        device="cpu")
    tr, _ = torch_sweeps(torch.tensor(A), torch.zeros(A.shape), st, torch.tensor(thr),
                         inner_passes=p.batch_inner_passes, inner_scheme=p.inner_scheme)
    print(f"pallas float32 golden q4, 2 sweeps alpha=1, ip{p.batch_inner_passes}: plain port "
          f"vs the Pallas kernel (interpret) max|d| {np.abs(np.asarray(kr) - tr.numpy()).max():.3g}")


def parity():
    thr = lws_tpu.get_thresholds(100, 100, 0.1, 1)
    for name in GOLDENS:
        g = golden(name)
        A = np.abs(g["S"]).astype(np.complex128)
        args = (int(g["fsize"]), int(g["fshift"]))
        j = lws_tpu.LWS(*args, L=int(g["L"]), dtype=jnp.complex128)
        t = lws_torch.LWS(*args, L=int(g["L"]), dtype=torch.float64, device="cpu")
        cj = float(j.get_consistency(j.batch_lws(A, thresholds=thr)))
        ct = float(t.get_consistency(t.batch_lws(A, thresholds=thr)))
        print(f"parity float64 {name}, 100 sweeps: lws_tpu {cj:.4f} dB, port {ct:.4f} dB "
              f"(|d| {abs(cj - ct):.2g}), reference C core {float(g['consistency_batch']):.4f} dB")


def q32():
    from lws_tpu import oracle
    j = lws_tpu.LWS(256, 8, L=3, dtype=jnp.float64)
    t = lws_torch.LWS(256, 8, L=3, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(13).standard_normal(2400)
    A = np.abs(j.stft(x)).astype(np.complex128)
    S = A * np.exp(2j * np.pi * np.random.default_rng(3).random(A.shape))
    thr = lws_tpu.get_thresholds(3, 1, 0.1, 1)
    sweep = jax.jit(lambda r, i, th: jax_sweeps(r, i, j._st_batch, th,
                                                inner_passes=t.batch_inner_passes,
                                                inner_scheme=t.inner_scheme))
    kr, ki = sweep(jnp.asarray(S.real), jnp.asarray(S.imag), jnp.asarray(thr))
    oj = np.asarray(kr) + 1j * np.asarray(ki)
    ot = t.batch_lws(S, thresholds=thr)
    print(f"q32 float64 LWS(256, 8, L=3) {A.shape}, Q={t._Qi}, 3 sweeps alpha=1 from random "
          f"phases: port vs lws_tpu max|d|/max amp {np.abs(oj - ot).max() / np.abs(A).max():.3g}")
    for n in (3, 5):
        th = lws_tpu.get_thresholds(n, 1, 0.1, 1)
        c = [float(t.get_consistency(v)) for v in (t.batch_lws(A, thresholds=th),
                                                   oracle.oracle_sweeps(A, j.W, th))]
        print(f"q32 from |X|, {n} sweeps alpha=1: port {c[0]:.4f} dB, oracle {c[1]:.4f} dB "
              f"(d {c[0] - c[1]:+.4f})")


SECTIONS = dict(nofuture_mean=nofuture_mean, nofuture_f32=nofuture_f32, pallas=pallas,
                parity=parity, q32=q32)

if __name__ == "__main__":
    for name in sys.argv[1:] or SECTIONS:
        SECTIONS[name.replace("-", "_")]()
