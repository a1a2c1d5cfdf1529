#!/usr/bin/env python3
"""The port's online stage and music pipeline against lws_tpu, on the CPU.

    JAX_PLATFORMS=cpu python port_tools/online_vs_reference.py [section ...]

Sections (all by default):
  scan    lws_torch.core.online.rtisi_la vs lws_tpu.core.online.rtisi_la,
          float64, input golden.nofuture_i1, 2 rounds (alpha=1), LA=3, the
          lws_tpu stencils carried across (convert.stencil_from_numpy), on
          q4 (jacobi), q2 (color2x3) and frac; max |d| and max |d| / max amp
          (the tolerance of tests/test_torch_online.py);
  sparse  LWS.online_lws on every golden's online_sparse_in (look_ahead=2,
          float64): max |d| to online_sparse_out, port and lws_tpu;
  sparse32  the same inputs in float32 (q4, q2): the plain version against
          the float64 golden and against itself under a 1e-7 relative
          perturbation of the input (chip_smoke.py's TOL_SPARSE);
  music   lws_tpu.LWS(1024, 256, mode="music") and the port's plain
          version (device="cpu"), float32, on utterances 0-1 of
          chip_smoke.py's music inputs (bench.py::make_batch, 32 x 5 s at
          16 kHz, seed 1): consistency after each stage (mean and per
          utterance) and wall times. chip_smoke.py's MUSIC_JAX_DB floor is
          lws_tpu's final mean here. Several minutes;
  stream  lws_tpu.StreamingLWS (backend "xla", its per-frame path) and the
          port's StreamingLWS (device="cpu", the plain chunk path), float32,
          LWS(512, 128, look_ahead=3, online_iterations=10), on streams 0-1
          of chip_smoke.py's streaming inputs (bench.py::bench_streaming: 8
          x 5 s at 16 kHz, seed 5) pushed in 0.5 s chunks, then flush:
          consistency of the committed spectrogram (mean and per stream),
          committed frame counts and wall times. chip_smoke.py's
          STREAM_JAX_DB floor is lws_tpu's mean here;
  longform  lws_tpu.LWS(4096, 1024) and the port's plain version
          (device="cpu"), float32, batch_lws (100 sweeps, alpha=100) on the
          first LONG_PREFIX_SECONDS of chip_smoke.py's longform signal
          (bench.py::bench_longform: one 630 s stream at 48 kHz, seed 4):
          consistency of |X| and of the result, and wall times.
          chip_smoke.py's LONG_JAX_DB floor is lws_tpu's result here.
          Several minutes.
"""
from __future__ import annotations

import os
import sys
import time

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
from chip_smoke import (  # noqa: E402
    LONG_FSHIFT,
    LONG_FSIZE,
    LONG_PREFIX_SECONDS,
    LONG_RATE,
    LONG_SECONDS,
    LONG_SEED,
    MUSIC_B,
    MUSIC_SECONDS,
    MUSIC_SEED,
    SAMPLE_RATE,
    STREAM_B,
    STREAM_BLOCK,
    STREAM_CHUNK,
    STREAM_SECONDS,
    STREAM_SEED,
    make_batch,
)
from lws_torch.convert import stencil_from_numpy  # noqa: E402
from lws_torch.core.online import rtisi_la as torch_rtisi_la  # noqa: E402
from lws_tpu.core.online import rtisi_la as jax_rtisi_la  # noqa: E402

torch.set_num_threads(1)


def golden(name):
    return dict(np.load(os.path.join(ROOT, "tests", "golden", f"ref_{name}.npz")))


def carried(st):
    return stencil_from_numpy(np.asarray(st.Wr), np.asarray(st.Wi), st.nz, st.Q, st.L,
                              device="cpu", dtype=torch.float64)


def scan():
    for name in ("q4", "q2", "frac"):
        g = golden(name)
        tp = lws_tpu.LWS(int(g["fsize"]), int(g["fshift"]), L=int(g["L"]),
                         dtype=jnp.float64)
        S = g["nofuture_i1"].astype(np.complex128)
        thr = lws_torch.get_thresholds(2, 1, 0.1, 1)
        jr, ji = jax_rtisi_la(jnp.asarray(S.real), jnp.asarray(S.imag),
                              st_la=tp._st_la, st_ai=tp._st_nofuture, st_af=tp._st_af,
                              thresholds=jnp.asarray(thr), inner_passes=tp.inner_passes,
                              inner_scheme=tp.inner_scheme)
        tr, ti = torch_rtisi_la(torch.tensor(S.real), torch.tensor(S.imag),
                                [carried(s) for s in tp._st_la], carried(tp._st_nofuture),
                                carried(tp._st_af), torch.tensor(thr),
                                inner_passes=tp.inner_passes, inner_scheme=tp.inner_scheme)
        d = max(np.abs(tr.numpy() - np.asarray(jr)).max(),
                np.abs(ti.numpy() - np.asarray(ji)).max())
        print(f"scan {name} ({tp.inner_scheme}): port vs lws_tpu rtisi_la, float64, "
              f"max|d| {d:.3e}, / max amp {d / np.abs(S).max():.3e}", flush=True)


def sparse():
    for name in ("q4", "q2", "frac", "q3", "q4L2", "q8"):
        g = golden(name)
        kw = dict(L=int(g["L"]), look_ahead=2)
        t = lws_torch.LWS(int(g["fsize"]), int(g["fshift"]), dtype=torch.float64,
                          device="cpu", **kw)
        j = lws_tpu.LWS(int(g["fsize"]), int(g["fshift"]), dtype=jnp.float64, **kw)
        ref = g["online_sparse_out"]
        out_t = t.online_lws(g["online_sparse_in"], thresholds=g["online_sparse_thr"])
        out_j = np.asarray(j.online_lws(g["online_sparse_in"],
                                        thresholds=g["online_sparse_thr"]))
        print(f"sparse {name}: max|port - golden| {np.abs(out_t - ref).max():.3e}, "
              f"max|lws_tpu - golden| {np.abs(out_j - ref).max():.3e}", flush=True)


def sparse32():
    """The golden sparse inputs in float32: the plain version against the
    float64 golden, and against itself under a 1e-7 relative perturbation
    of the input (float32's rounding step)."""
    rng = np.random.default_rng(0)
    for name in ("q4", "q2"):
        g = golden(name)
        t = lws_torch.LWS(int(g["fsize"]), int(g["fshift"]), L=int(g["L"]), look_ahead=2,
                          device="cpu")
        S = g["online_sparse_in"]
        top = np.abs(S).max()
        out = t.online_lws(S.astype(np.complex64), thresholds=g["online_sparse_thr"])
        Sp = S * (1 + 1e-7 * rng.standard_normal(S.shape))
        outp = t.online_lws(Sp.astype(np.complex64), thresholds=g["online_sparse_thr"])
        print(f"sparse32 {name}: max|plain f32 - golden| / max amp "
              f"{np.abs(out - g['online_sparse_out']).max() / top:.3e}; plain f32 under a "
              f"1e-7 relative input perturbation moves {np.abs(out - outp).max() / top:.3e}",
              flush=True)


def music():
    x = make_batch(MUSIC_B, int(MUSIC_SECONDS * SAMPLE_RATE), SAMPLE_RATE,
                   np.random.default_rng(MUSIC_SEED))[:2]
    j = lws_tpu.LWS(1024, 256, mode="music", dtype=jnp.float32)
    t = lws_torch.LWS(1024, 256, mode="music", device="cpu")
    A = np.abs(t.stft(x))  # float32, fed to both
    print(f"music: LWS(1024, 256, mode='music') on utterances 0-1, |X| {A.shape} "
          f"{A.dtype}", flush=True)
    for label, proc, conv in (("lws_tpu", j, np.asarray), ("port plain", t, np.asarray)):
        S = A.astype(np.complex64)
        cs = [proc.get_consistency(S)]
        t0 = time.perf_counter()
        for stage in (proc.nofuture_lws, proc.online_lws, proc.batch_lws):
            S = conv(stage(S))
            cs.append(conv(proc.get_consistency(S)))
        wall = time.perf_counter() - t0
        cs = [np.asarray(c) for c in cs]
        print(f"  {label}: consistency by stage (input, no-future, online, batch) means "
              + ", ".join(f"{float(c.mean()):.4f}" for c in cs)
              + f" dB; final per utterance {np.round(cs[-1], 4).tolist()}; "
              f"{wall:.1f} s", flush=True)


def stream():
    x = make_batch(STREAM_B, int(STREAM_SECONDS * SAMPLE_RATE), SAMPLE_RATE,
                   np.random.default_rng(STREAM_SEED))[:2]
    kw = dict(look_ahead=3, online_iterations=10)
    j = lws_tpu.LWS(512, 128, dtype=jnp.float32, **kw)
    t = lws_torch.LWS(512, 128, device="cpu", **kw)
    from lws_tpu.streaming import StreamingLWS as JaxStream
    runs = (("lws_tpu xla", j, JaxStream(j, streams=2, keep_frames=True, backend="xla")),
            ("port plain", t, lws_torch.StreamingLWS(t, streams=2, keep_frames=True,
                                                     block_frames=STREAM_BLOCK)))
    for label, proc, s in runs:
        t0 = time.perf_counter()
        outs = [s.push(x[:, i:i + STREAM_CHUNK]) for i in range(0, x.shape[-1], STREAM_CHUNK)]
        outs.append(s.flush())
        wall = time.perf_counter() - t0
        y = np.concatenate([np.asarray(o) for o in outs], axis=-1)
        com = np.stack(s.committed_frames, axis=1)  # (streams, frames, F)
        c = np.asarray(proc.get_consistency(com))
        print(f"stream {label}: {com.shape[1]} committed frames per stream, audio "
              f"{y.shape}, consistency mean {float(c.mean()):.4f} dB, per stream "
              f"{np.round(c, 4).tolist()}; {wall:.1f} s", flush=True)


def longform():
    x = make_batch(1, int(LONG_SECONDS * LONG_RATE), LONG_RATE,
                   np.random.default_rng(LONG_SEED))[:, :int(LONG_PREFIX_SECONDS * LONG_RATE)]
    j = lws_tpu.LWS(LONG_FSIZE, LONG_FSHIFT, dtype=jnp.float32)
    t = lws_torch.LWS(LONG_FSIZE, LONG_FSHIFT, device="cpu")
    A = np.abs(t.stft(x)).astype(np.complex64)  # float32 magnitudes, fed to both
    print(f"longform: LWS({LONG_FSIZE}, {LONG_FSHIFT}) batch_lws on the first "
          f"{LONG_PREFIX_SECONDS:g} s, |X| {A.shape}; consistency of |X| "
          f"{float(np.asarray(t.get_consistency(A))[0]):.4f} dB", flush=True)
    for label, proc in (("lws_tpu", j), ("port plain", t)):
        t0 = time.perf_counter()
        out = np.asarray(proc.batch_lws(A))
        wall = time.perf_counter() - t0
        c = float(np.asarray(proc.get_consistency(out))[0])
        print(f"  {label}: consistency {c:.4f} dB; {wall:.1f} s", flush=True)


def main(argv):
    sections = {"scan": scan, "sparse": sparse, "sparse32": sparse32, "music": music,
                "stream": stream, "longform": longform}
    for name in argv or list(sections):
        sections[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
