#!/usr/bin/env python3
"""Drive lws_torch's paths on one NVIDIA GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases, in order:
  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. the build of every kernel from lws_torch/csrc, one nvcc per source, all
     started together (timed, with the ptxas register / shared-memory
     report);
  3. each kernel against its plain version on the card, same float32
     inputs made from a numpy seed, at the paths' shapes: the sweep kernel
     (cases a-d at F=257 / 129, h at F=513, where its weights do not fit
     shared memory), the online kernel (cases e-g) and the chunked online
     kernel (case i: chunked, against the online kernel bit for bit; case
     j: against its plain version, with the running mean), and the grouped
     sweep kernel K5 (cases k: micro 2 and 4 against the plain group
     update, micro 1, which its wrapper runs on K1, against K1 and the plain
     sweeps; then its time at micro 4 on the batch path's input);
  4. the batch path at full width: LWS(512, 128) on 32 x 5 s utterances at
     16 kHz, stft -> batch_lws(|X|) (100 sweeps) -> get_consistency ->
     istft, with the launch counts of that one run, the kernel and plain
     times, and the output checks (magnitudes, consistency, agreement with
     the plain version);
  5. the music path at full width: LWS(1024, 256, mode="music") on bench.py's
     pipeline workload, stft -> run_lws(|X|) (no-future 1, online 10, batch
     100) -> get_consistency -> istft, with the launch counts of that one
     run, the consistency after each stage, the floor set by lws_tpu's own
     result, the stage and kernel times, and agreement with the plain
     version;
  6. the streaming path at full width: StreamingLWS(LWS(512, 128,
     look_ahead=3, online_iterations=10)) on bench.py's streaming workload
     (8 streams x 5 s at 16 kHz pushed in 0.5 s chunks through push_block,
     block_frames=64, emit="device", running mean) then flush, with the
     launch count of that one run, the output checks (every live frame
     committed, magnitudes, audio length, consistency against lws_tpu's own
     result and the plain chunk path, device emit against host emit), the
     stream wall and the chunked kernel's share of it, and the latency
     table of BENCHMARKS.md (host-synchronous pushes at block_frames 32 and
     8, pipelined device emit at block_frames 1);
  7. the longform path at full width: LWS(4096, 1024) on bench.py's
     longform workload (one 630 s stream at 48 kHz, F=2049), stft ->
     batch_lws(|X|) (100 sweeps, segmented by the SM-count plan) ->
     get_consistency (blocked) -> istft, with the plan S and the K1 launches
     of that one run, the wall, K1's summed time, the steps per CTA and the
     bound, the output checks; then case (a)
     (the segmented sweeps on the kernel against the plain sweeps on the
     card, a 20 s prefix), (b) the seams (the plan's S = 2 against one
     segment on a 120 s prefix) and (c) the floor set by lws_tpu's own
     result on the 20 s prefix;
  8. the kernels line (JSON), then the result line (JSON) last.

Exits non-zero, before any result line, without CUDA, without the repo's
lws_torch beside this file, or when any phase fails. Imports nothing of
jax or lws_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Kernel vs plain, max |delta| / max amp after the case's sweeps. The kernel
# sums taps one by one in (dr, dk) order, the plain version in torch's
# reduction order; the float32 rounding differences grow along the frame
# chain. port_tools/order_divergence.py measures the same two orders on the
# CPU (lws_tpu's sequential update_frame vs lws_torch's vectorised one) from
# random-phase starts at these shapes: at most 3.6e-4 (the card, which adds
# rsqrtf and its own reduction order, showed at most 6.2e-4). From a
# zero-phase start many tap sums nearly cancel and either order picks the
# phase of those bins (max|d| ~ 1.3 x max amp), so the cases start from
# seeded random phases; the zero-phase main path is compared by consistency.
TOL_CASE = 2e-3
TOL_MAGNITUDE = 1e-5   # per-bin relative |out| vs |in|
MIN_CONSISTENCY_DB = 16.5
TOL_PLAIN_DB = 0.1     # kernel vs plain consistency, utterances 0-1, 100 sweeps
TOL_RECON = 1e-4       # istft(stft(x)) vs x, float32
# Online kernel vs plain on the golden sparse inputs, max |delta| / max amp,
# float32, every frame; both are also held to the float64 golden. One bin
# per frame passes the rounds' thresholds, but the initialisation
# (threshold 0) updates every bin from strictly-past taps, and on golden q4
# bins whose tap sum nearly cancels take their phase from the rounding: the
# plain float32 version moves 1.3e-3 x max amp under a 1e-7 relative
# perturbation of its input and sits 6.0e-4 from the golden
# (port_tools/online_vs_reference.py, section sparse32). q2 moves 3.8e-7.
TOL_SPARSE = {"q4": 5e-3, "q2": 1e-5}
# Dense online runs amplify rounding along the commit chain
# (tests/test_pallas.py:122-136): the first frames are compared bin by bin,
# the rest by consistency, per utterance.
ONLINE_EARLY_FRAMES = 6
TOL_ONLINE_DB = 0.1
# lws_tpu's own result on the music path: LWS(1024, 256, mode="music"),
# float32, on the CPU, utterances 0-1 of the music inputs below, mean final
# consistency (port_tools/online_vs_reference.py, section music; the port's
# plain version there: 33.9171 dB). The card's mean on the same two
# utterances must reach it less MUSIC_MARGIN_DB.
MUSIC_JAX_DB = 33.9263
MUSIC_MARGIN_DB = 0.5
# lws_tpu's own result on the streaming path: lws_tpu.StreamingLWS (its
# per-frame "xla" backend) with LWS(512, 128, look_ahead=3,
# online_iterations=10), float32, on the CPU, streams 0-1 of the streaming
# inputs below pushed in 0.5 s chunks then flushed: mean consistency of the
# committed spectrogram (port_tools/online_vs_reference.py, section stream;
# the port's plain chunk path there: 23.3971 dB). The card's mean on the
# same two streams must reach it less STREAM_MARGIN_DB.
STREAM_JAX_DB = 23.3941
STREAM_MARGIN_DB = 0.5

# The longform path: bench.py's longform workload (bench.py:213-232), one
# 630 s stream at 48 kHz, LWS(4096, 1024) (Q=4, L=5, F=2049), 100 sweeps at
# alpha=100, float32. Its checks run on prefixes of the same signal: case
# (a) and the floor on LONG_PREFIX_SECONDS, the seams on LONG_SEAM_SECONDS
# (T = 5626, so the plan gives S = 2).
LONG_SECONDS, LONG_RATE, LONG_SEED = 630.0, 48000, 4
LONG_FSIZE, LONG_FSHIFT = 4096, 1024
LONG_PREFIX_SECONDS, LONG_SEAM_SECONDS = 20.0, 120.0
# lws_tpu's own result on the longform prefix: LWS(4096, 1024) batch_lws,
# float32, on the CPU (port_tools/online_vs_reference.py, section longform;
# the port's plain version there: 21.1933 dB too). The card must reach it
# less LONG_MARGIN_DB. The seams: the plan's segments against one segment,
# by consistency.
LONG_JAX_DB = 21.1933
LONG_MARGIN_DB = 0.5
TOL_SEAM_DB = 0.1

# Sizes: the main path at full width (bench.py's batch workload), the
# kernel-vs-plain cases at its frame count with fewer utterances.
DEVICE = "cuda"
MAIN_B, MAIN_SECONDS, SAMPLE_RATE, MAIN_SWEEPS = 32, 5.0, 16000, 100
CASE_B = 4
# The music path: bench.py's pipeline workload (bench.py:137-160).
MUSIC_B, MUSIC_SECONDS, MUSIC_SEED = 32, 5.0, 1
# The streaming path: bench.py's streaming workload (bench.py:235-354), 8
# streams x 5 s pushed in 0.5 s chunks, one chunk launch per 64 frames.
STREAM_B, STREAM_SECONDS, STREAM_SEED, STREAM_CHUNK, STREAM_BLOCK = 8, 5.0, 5, 8000, 64


def make_batch(B, n, sr_hz, rng):
    """Tone + chirp + noise mixtures (bench.py::make_batch)."""
    t = np.arange(n) / sr_hz
    xs = []
    for i in range(B):
        f0 = 120 + 40 * (i % 8)
        x = (0.5 * np.sin(2 * np.pi * f0 * 2 * t)
             + 0.3 * np.sin(2 * np.pi * (f0 * 4.7) * t + 0.3 * i)
             + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t / t[-1]) * t)
             + 0.05 * rng.standard_normal(n))
        xs.append(x)
    return np.stack(xs).astype(np.float32)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []

    def check(self, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def sync(self):
        self.torch.cuda.synchronize()


def card_lines(torch):
    print(f"card: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)


KERNELS = ("lws_sweeps", "lws_online")  # sources: K1 and K5; K3 and K4


def build_phase():
    from lws_torch.ops import _build
    t0 = time.time()
    paths = _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"build: {', '.join(f'{n}.cu' for n in KERNELS)} (one nvcc each, in parallel) "
          f"in {time.time() - t0:.1f} s")
    for name, path in paths.items():
        print(f"  {name} -> {os.path.relpath(path, ROOT)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")


def kernel_cases(s, torch, lws_torch, sweeps_mod):
    """Phase 3, the sweep kernel vs its plain version on the card. Returns
    the largest max |delta|."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    x = make_batch(CASE_B, int(MAIN_SECONDS * SAMPLE_RATE), SAMPLE_RATE, rng)
    dense = lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:]

    def random_phase(proc):
        sr, si = proc.stft_ri(x)
        amp = torch.sqrt(sr * sr + si * si)
        ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, tuple(amp.shape)),
                             dtype=torch.float32, device=dev)
        return amp * torch.cos(ph), amp * torch.sin(ph), amp

    q4 = lws_torch.LWS(512, 128, device=dev)
    q2 = lws_torch.LWS(256, 128, device=dev)
    wide = lws_torch.LWS(1024, 256, device=dev)
    in4, in2, in_wide = random_phase(q4), random_phase(q2), random_phase(wide)
    B, _, F = in4[2].shape
    Q1, scale = q4._Qi - 1, float(in4[2].mean())
    halo = tuple(torch.as_tensor(rng.standard_normal((B, Q1, F)) * scale,
                                 dtype=torch.float32, device=dev) for _ in range(4))
    mean = torch.as_tensor(rng.uniform(0.5, 2.0, B) * scale, dtype=torch.float32, device=dev)
    batch4 = (q4._st_batch, q4.batch_inner_passes, q4.inner_scheme)
    cases = [  # (name, inputs, (stencil, passes, scheme), thresholds, halo/mean)
        ("a batch Q=4 ip3 jacobi, 3 live sweeps", in4, batch4, dense, {}),
        ("b no-future v=-1, 1 sweep", in4, (q4._st_nofuture, 1, "jacobi"),
         lws_torch.get_thresholds(1, 1, 0.1, 1), {}),
        ("c batch Q=2 color2x3, 3 sweeps", in2,
         (q2._st_batch, q2.batch_inner_passes, q2.inner_scheme), dense, {}),
        ("d case a with halo= and mean_amp=", in4, batch4, dense,
         dict(halo=halo, mean_amp=mean)),
        ("h LWS(1024, 256) F=513 batch Q=4 ip3 jacobi (weights read from device "
         "memory), 3 live sweeps", in_wide,
         (wide._st_batch, wide.batch_inner_passes, wide.inner_scheme), dense, {}),
    ]
    worst = 0.0
    for name, (r0, i0, amp), (st, ip, scheme), thr, kw in cases:
        thr_t = torch.as_tensor(thr, dtype=torch.float32, device=dev)
        n_live = int(sweeps_mod.sweep_schedule(r0, i0, thr_t, kw.get("mean_amp"))[2].sum())
        kr, ki = sweeps_mod.tiled_lws_sweeps(r0, i0, st, thr_t, ip, scheme, **kw)
        pr, pi = sweeps_mod.tiled_lws_sweeps(r0, i0, st, thr_t, ip, scheme,
                                             backend="torch", **kw)
        s.sync()
        d = float(torch.maximum((kr - pr).abs(), (ki - pi).abs()).max())
        rel = d / float(amp.max())
        worst = max(worst, d)
        s.check(np.isfinite(d) and rel <= TOL_CASE,
                f"case {name} {tuple(r0.shape)}, {n_live} live (utterance, sweep) pairs: "
                f"max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g})")
    return worst


def online_cases(s, torch, lws_torch, online_mod):
    """Phase 3, the online kernel vs its plain version on the card, float32.
    Returns the largest max |delta| over what is compared bin by bin."""
    dev = torch.device(DEVICE)
    worst = 0.0
    # e: the golden sparse inputs, every frame
    for name in ("q4", "q2"):
        with np.load(os.path.join(ROOT, "tests", "golden", f"ref_{name}.npz")) as z:
            g = {k: z[k] for k in ("fsize", "fshift", "L", "online_sparse_in",
                                   "online_sparse_thr", "online_sparse_out")}
        proc = lws_torch.LWS(int(g["fsize"]), int(g["fshift"]), L=int(g["L"]),
                             look_ahead=2, device=dev)
        S = g["online_sparse_in"]
        sr = torch.tensor(S.real, dtype=torch.float32, device=dev)
        si = torch.tensor(S.imag, dtype=torch.float32, device=dev)
        thr = torch.tensor(g["online_sparse_thr"], dtype=torch.float32, device=dev)
        args = (sr, si, proc._st_la, proc._st_nofuture, proc._st_af, thr,
                proc.inner_passes, proc.inner_scheme)
        kr, ki = online_mod.packed_rtisi_la(*args)
        pr, pi = online_mod.packed_rtisi_la(*args, backend="torch")
        s.sync()
        d = float(torch.maximum((kr - pr).abs(), (ki - pi).abs()).max())
        top = float(np.abs(S).max())
        ref = g["online_sparse_out"]
        dk, dp = (float(np.abs(torch.complex(r, i).cpu().numpy() - ref).max()) / top
                  for r, i in ((kr, ki), (pr, pi)))
        worst = max(worst, d)
        s.check(np.isfinite(d) and max(d / top, dk, dp) <= TOL_SPARSE[name],
                f"case e golden {name} online_sparse (look_ahead=2, {proc.inner_scheme}) "
                f"{tuple(sr.shape)}, every frame, max|d|/max amp: kernel vs plain "
                f"{d / top:.3e}, kernel vs golden {dk:.3e}, plain vs golden {dp:.3e} "
                f"(tol {TOL_SPARSE[name]:g})")

    # f, g: dense runs from random phases on bench.py's mixture class
    rng = np.random.default_rng(2)
    x = make_batch(CASE_B, int(MAIN_SECONDS * SAMPLE_RATE), SAMPLE_RATE, rng)
    for tag, fsize, iters in (("f", 512, 10), ("g", 256, 2)):
        proc = lws_torch.LWS(fsize, 128, device=dev)
        sr, si = proc.stft_ri(x)
        amp = torch.sqrt(sr * sr + si * si)
        ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, tuple(amp.shape)),
                             dtype=torch.float32, device=dev)
        sr, si = amp * torch.cos(ph), amp * torch.sin(ph)
        thr = torch.as_tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1),
                              dtype=torch.float32, device=dev)
        args = (sr, si, proc._st_la, proc._st_nofuture, proc._st_af, thr,
                proc.inner_passes, proc.inner_scheme)
        kr, ki = online_mod.packed_rtisi_la(*args)
        pr, pi = online_mod.packed_rtisi_la(*args, backend="torch")
        s.sync()
        early = slice(0, ONLINE_EARLY_FRAMES)
        d = float(torch.maximum((kr[:, early] - pr[:, early]).abs(),
                                (ki[:, early] - pi[:, early]).abs()).max())
        rel = d / float(amp.max())
        worst = max(worst, d)
        s.check(np.isfinite(d) and rel <= TOL_CASE,
                f"case {tag} LWS({fsize}, 128) online LA={proc.look_ahead} {iters} rounds "
                f"{proc.inner_scheme} {tuple(sr.shape)}, first {ONLINE_EARLY_FRAMES} frames: "
                f"max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g})")
        dc = float((proc.get_consistency((kr, ki)) - proc.get_consistency((pr, pi))).abs().max())
        s.check(dc <= TOL_ONLINE_DB,
                f"case {tag} per-utterance consistency, kernel vs plain: max {dc:.4f} dB "
                f"(tol {TOL_ONLINE_DB})")
        mag = torch.sqrt(kr * kr + ki * ki)
        mag_rel = float(((mag - amp).abs() / amp.clamp_min(1e-30)).max())
        s.check(mag_rel <= TOL_MAGNITUDE,
                f"case {tag} magnitudes preserved: {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    return worst


def chunked(torch, online_mod, proc, sr, si, means, thr, backend="auto"):
    """The chunked online stage (K4, or its plain version with
    backend="torch") over (sr, si) (B, T, F), chunked at (17, 1, rest), then
    one drain chunk of LA frames; returns the committed rows of the input's
    frames (B, T, F)."""
    B, T, F = sr.shape
    LA = proc.look_ahead
    args = (proc._st_la, proc._st_nofuture, proc._st_af, thr)
    state = online_mod.online_chunk_init(proc._st_la, proc._st_af, sr[:, 0], si[:, 0])
    z = torch.zeros((B, LA, F), dtype=sr.dtype, device=sr.device)
    pieces = [(sr[:, a:b], si[:, a:b], means[:, a:b], None)
              for a, b in ((0, 17), (17, 18), (18, T))] + [(z, z, means[:, :LA], 0)]
    rows_r, rows_i = [], []
    for r, i, m, n_live in pieces:
        cr, ci, state = online_mod.online_chunk(
            r.contiguous(), i.contiguous(), state, m.contiguous(), *args, n_live,
            proc.inner_passes, proc.inner_scheme, backend)
        rows_r.append(cr)
        rows_i.append(ci)
    return torch.cat(rows_r, dim=1)[:, LA:], torch.cat(rows_i, dim=1)[:, LA:]


def chunk_cases(s, torch, lws_torch, online_mod):
    """Phase 3, the chunked online kernel (K4) on the card, float32, on
    (4, 628, 257) from seeded random phases, LWS(512, 128), look_ahead 3, 10
    rounds. Returns the largest max |delta| of case j's first frames."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    x = make_batch(CASE_B, int(MAIN_SECONDS * SAMPLE_RATE), SAMPLE_RATE, rng)
    proc = lws_torch.LWS(512, 128, device=dev)
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, tuple(amp.shape)),
                         dtype=torch.float32, device=dev)
    sr, si = (amp * torch.cos(ph)).contiguous(), (amp * torch.sin(ph)).contiguous()
    amp = torch.sqrt(sr * sr + si * si)  # as the wrappers compute it
    B, T, F = sr.shape
    LA = proc.look_ahead
    thr = torch.as_tensor(lws_torch.get_thresholds(10, 1, 0.1, 1), dtype=torch.float32,
                          device=dev)
    shape = f"{tuple(sr.shape)} LA={LA} 10 rounds {proc.inner_scheme}"

    # i: with K3's fixed per-utterance mean, K4 chunked and drained is K3
    k3 = online_mod.packed_rtisi_la(sr, si, proc._st_la, proc._st_nofuture, proc._st_af,
                                    thr, proc.inner_passes, proc.inner_scheme)
    fixed = amp.mean(dim=(-2, -1))[:, None].expand(B, T)
    k4 = chunked(torch, online_mod, proc, sr, si, fixed, thr)
    s.sync()
    d = max(float((k4[0] - k3[0]).abs().max()), float((k4[1] - k3[1]).abs().max()))
    s.check(d == 0.0, f"case i K4 chunked (17, 1, rest) + drain vs K3, fixed mean, {shape}: "
            f"max|d| = {d:.3e} (must be 0: bit-equal)")

    # j: the running mean of the stream, K4 against its plain version
    means = torch.cumsum(amp.mean(dim=-1), dim=1) / torch.arange(
        1, T + 1, dtype=torch.float32, device=dev)
    kr, ki = chunked(torch, online_mod, proc, sr, si, means, thr)
    pr, pi = chunked(torch, online_mod, proc, sr, si, means, thr, backend="torch")
    s.sync()
    early = slice(0, ONLINE_EARLY_FRAMES)
    worst = max(float((kr[:, early] - pr[:, early]).abs().max()),
                float((ki[:, early] - pi[:, early]).abs().max()))
    rel = worst / float(amp.max())
    s.check(np.isfinite(worst) and rel <= TOL_CASE,
            f"case j K4 vs plain online_chunk, running mean, {shape}, first "
            f"{ONLINE_EARLY_FRAMES} frames: max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g})")
    dc = float((proc.get_consistency((kr, ki)) - proc.get_consistency((pr, pi))).abs().max())
    s.check(dc <= TOL_ONLINE_DB, f"case j per-utterance consistency, K4 vs plain: max "
            f"{dc:.4f} dB (tol {TOL_ONLINE_DB})")
    mag_rel = float(((torch.sqrt(kr * kr + ki * ki) - amp).abs() / amp.clamp_min(1e-30)).max())
    s.check(mag_rel <= TOL_MAGNITUDE,
            f"case j magnitudes preserved: {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    return worst


def random_phases(torch, rng, sr, si):
    """|S| of (sr, si) with seeded random phases, and |S| itself."""
    amp = torch.sqrt(sr * sr + si * si)
    ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, tuple(amp.shape)), dtype=torch.float32,
                         device=amp.device)
    return (amp * torch.cos(ph)).contiguous(), (amp * torch.sin(ph)).contiguous(), amp


def packed_cases(s, torch, lws_torch, sweeps_mod, packed_mod):
    """Phase 3, the grouped sweep kernel (K5) on the card, float32, on
    (4, 628, 257) from seeded random phases, LWS(512, 128)'s batch stencil
    (3 in-frame jacobi passes), 12 sweeps at alpha=1: each micro against the
    plain group update, and micro = 1 (K1 behind K5's wrapper) against K1
    bit for bit. Returns the largest max |delta|."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(6)
    x = make_batch(CASE_B, int(MAIN_SECONDS * SAMPLE_RATE), SAMPLE_RATE, rng)
    proc = lws_torch.LWS(512, 128, device=dev)
    sr, si, amp = random_phases(torch, rng, *proc.stft_ri(x))
    thr = torch.as_tensor(lws_torch.get_thresholds(12, 1, 0.1, 1), dtype=torch.float32,
                          device=dev)
    sched = (proc._st_batch, thr)
    ip, scheme = proc.batch_inner_passes, proc.inner_scheme
    k1 = sweeps_mod.tiled_lws_sweeps(sr, si, *sched, ip, scheme)
    worst = 0.0
    for micro in (1, 2, 4):
        kr, ki = packed_mod.packed_lws_sweeps(sr, si, *sched, micro, ip, scheme)
        pr, pi = packed_mod.packed_lws_sweeps(sr, si, *sched, micro, ip, scheme,
                                              backend="torch")
        s.sync()
        d = float(torch.maximum((kr - pr).abs(), (ki - pi).abs()).max())
        rel = d / float(amp.max())
        worst = max(worst, d)
        s.check(np.isfinite(d) and rel <= TOL_CASE,
                f"case k K5 micro={micro} vs its plain version, {tuple(sr.shape)}, 12 sweeps "
                f"alpha=1, {ip} jacobi passes: max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g})")
        if micro == 1:
            s.check(torch.equal(kr, k1[0]) and torch.equal(ki, k1[1]),
                    "case k K5 micro=1 vs K1 on the same inputs: bit-equal")
    return worst


def packed_timing(s, torch, lws_torch, sweeps_mod, packed_mod):
    """K5 through its entry point (lws_torch.ops.packed_lws_sweeps) on the
    batch path's input, (32, 628, 257) x 100 sweeps at alpha=100 from zero
    phase, at micro 4 (micro 1 is K1, timed on the batch path): launches,
    time, bound, consistency, the plain group update's time. Returns the
    kernels-line entry."""
    dev = torch.device(DEVICE)
    B, secs, iters, micro = MAIN_B, MAIN_SECONDS, MAIN_SWEEPS, 4
    x = make_batch(B, int(secs * SAMPLE_RATE), SAMPLE_RATE, np.random.default_rng(0))
    proc = lws_torch.LWS(512, 128, device=dev)
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    thr = torch.as_tensor(lws_torch.get_thresholds(iters, 100, 0.1, 1), dtype=torch.float32,
                          device=dev)
    st, ip, scheme = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme
    T, F = amp.shape[-2:]

    # one run of the K5 entry point, counted
    packed_mod.LAUNCHES = 0
    out = packed_mod.packed_lws_sweeps(*pair, st, thr, micro, ip, scheme)
    s.sync()
    launches = packed_mod.LAUNCHES
    s.check(launches == 1, f"lws_packed kernel launches in the K5 run (micro {micro}): "
            f"{launches} (expected 1)")
    c = proc.get_consistency(out)
    mag_rel = float(((torch.sqrt(out[0] ** 2 + out[1] ** 2) - amp).abs()
                     / amp.clamp_min(1e-30)).max())
    s.check(mag_rel <= TOL_MAGNITUDE and bool(torch.isfinite(c).all()),
            f"K5 micro={micro}: magnitudes {mag_rel:.2e} (tol {TOL_MAGNITUDE:g}), "
            f"consistency mean {float(c.mean()):.3f} dB")
    ms = cuda_ms(torch, lambda: packed_mod.packed_lws_sweeps(*pair, st, thr, micro, ip,
                                                             scheme), 3)
    s.sync()
    t0 = time.perf_counter()
    plain = packed_mod.packed_lws_sweeps(*pair, st, thr, micro, ip, scheme, backend="torch")
    s.sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    d01 = float((proc.get_consistency(plain)[:2] - c[:2]).abs().max())
    s.check(d01 <= TOL_PLAIN_DB, f"K5 micro={micro} vs its plain version, consistency of "
            f"utterances 0-1: {d01:.4f} dB (tol {TOL_PLAIN_DB})")
    live = sweeps_mod.sweep_schedule(*pair, thr)[2]
    bound_ms, bound_by, flops, nbytes, _ = sweep_bound(st, ip, live, T, F, B)
    serial = int(live.sum(dim=1).max()) * (-(-T // micro)) * (1 + ip)
    print(f"K5 (grouped sweeps) on {tuple(amp.shape)} x {iters} sweeps, micro={micro}: "
          f"{ms:.2f} ms ({serial} steps per CTA -> {1e3 * ms / serial:.3f} us per step); "
          f"plain {plain_ms:.1f} ms; bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} "
          f"flop, {nbytes:.4g} B); consistency {float(c.mean()):.3f} dB")
    return dict(name="lws_packed", route="cuda", source="lws_torch/csrc/lws_sweeps.cu",
                replaces="lws_tpu/ops/pallas_packed.py:683", launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                micro=micro, shape=[B, int(T), int(F)], sweeps=iters, serial_steps=serial,
                consistency_db=float(c.mean()))


def cuda_ms(torch, fn, reps):
    """Median CUDA-event time of fn() over reps, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sweep_bound(st, passes, live, T, F, B):
    """(bound_ms, bound_by, flops, bytes, serial steps): the least time the
    card needs for the sweeps these inputs need (live sweeps only): 8 flops
    per live tap and bin (complex multiply-add), centre taps once per pass,
    ~12 flops of epilogue per pass; each input and output plane touched
    once."""
    c = st.Q - 1
    n_off = int(st.nz.sum() - st.nz[c].sum())
    n_c = int(st.nz[c].sum())
    per_bin = 8 * n_off + passes * (8 * n_c + 12)
    live_sweeps = int(live.sum())
    flops = float(live_sweeps) * T * F * per_bin
    nbytes = 4.0 * (4 * B * T * F + 2 * st.Wr.numel() + live.numel())
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    serial = int(live.sum(dim=1).max()) * T * (1 + passes)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes, serial)


def online_bound(proc, online_mod, T, F, B, iters, frames=None, launches=None):
    """(bound_ms, bound_by, flops, bytes, row updates per CTA) of one online
    stage: 8 flops per live tap and bin (complex multiply-add), ~12 flops of
    epilogue per bin and pass (colors update a 1/k share of the bins per
    pass), over the row updates the stage runs for T live frames (frames
    before the start are skipped); each input and output plane touched
    once, the weight sets read once. For K4 over a stream (launches given):
    `frames` frames through the kernel (drains included; they update
    nothing), each launch reading the weight sets and the state once and
    writing the state once, and a threshold per frame and round."""
    sets = [proc._st_nofuture, proc._st_af, *proc._st_la]
    _, _, _, counts = online_mod.online_weight_sets(proc._st_la, proc._st_nofuture,
                                                    proc._st_af)
    from lws_torch.core.stencil import _parse_colors
    colors = proc.inner_scheme != "jacobi"
    if colors:
        _, rounds = _parse_colors(proc.inner_scheme)

    def per_bin(s):
        n_off, n_cen = (int(v) for v in counts[s])
        if n_cen == 0:
            return 8 * n_off + 12
        if colors:
            return 8 * n_off + rounds * (8 * n_cen + 12)  # k passes, 1/k of the bins each
        return 8 * n_off + proc.inner_passes * (8 * n_cen + 12)

    LA = proc.look_ahead
    updates = {0: T, 1: iters * T}
    updates.update({2 + d - 1: iters * (T - d) for d in range(1, LA + 1)})
    flops = float(B * F * sum(n * per_bin(s) for s, n in updates.items()))
    weights = 2 * len(sets) * sets[0].Wr.numel()
    if launches is None:
        nbytes = 4.0 * (5 * B * T * F + weights + B * iters)
    else:
        state = 2 * B * (2 * (LA + proc._Qi) + LA + 1) * F  # read and written
        nbytes = 4.0 * (5 * B * frames * F + B * frames * iters
                        + launches * (weights + state))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes, sum(updates.values()))


def music_path(s, torch, lws_torch, sweeps_mod, online_mod):
    """Phase 5. Returns the kernels-line entry for lws_online and the
    music-path numbers of lws_sweeps."""
    dev = torch.device(DEVICE)
    B, secs, sr_hz = MUSIC_B, MUSIC_SECONDS, SAMPLE_RATE
    x = make_batch(B, int(secs * sr_hz), sr_hz, np.random.default_rng(MUSIC_SEED))
    proc = lws_torch.LWS(1024, 256, mode="music", device=dev)

    # one run of the music path, through the user entry points, counted
    sweeps_mod.LAUNCHES = 0
    online_mod.LAUNCHES = 0
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    out = proc.run_lws(pair)
    c_out = proc.get_consistency(out)
    y = proc.istft(out)
    s.sync()
    launches = {"lws_sweeps": sweeps_mod.LAUNCHES, "lws_online": online_mod.LAUNCHES}
    T, F = amp.shape[-2:]
    print(f"music path: LWS(1024, 256, mode='music') on {B} x {secs:g} s, spectrogram "
          f"{tuple(amp.shape)}, no-future {proc.nofuture_iterations} + online "
          f"{proc.online_iterations} (look_ahead {proc.look_ahead}, {proc.inner_scheme}, "
          f"inner_passes {proc.inner_passes}) + batch {proc.batch_iterations} "
          f"(batch_inner_passes {proc.batch_inner_passes})")
    for name, n in launches.items():
        s.check(n >= 1, f"{name} kernel launches in the music-path run: {n} "
                f"(expected {2 if name == 'lws_sweeps' else 1})")

    # the same stages one by one: consistency after each, stage times
    stages, walls, cs = [pair], [], [proc.get_consistency(pair)]
    for stage in (proc.nofuture_lws, proc.online_lws, proc.batch_lws):
        s.sync()
        t0 = time.perf_counter()
        stages.append(stage(stages[-1]))
        s.sync()
        walls.append(time.perf_counter() - t0)
        cs.append(proc.get_consistency(stages[-1]))
    means = [float(c.mean()) for c in cs]
    print("  consistency by stage (input, no-future, online, batch): "
          + " -> ".join(f"{m:.3f}" for m in means) + " dB; stage walls "
          + ", ".join(f"{1e3 * w:.2f}" for w in walls) + " ms")
    s.check(means[0] < means[1] < means[2] < means[3],
            "consistency rises at every stage")
    same = max(float((stages[-1][k] - out[k]).abs().max()) for k in (0, 1))
    print(f"  run_lws vs the stages one by one: max|d| {same:.3e}")

    mag = torch.sqrt(out[0] ** 2 + out[1] ** 2)
    mag_rel = float(((mag - amp).abs() / amp.clamp_min(1e-30)).max())
    s.check(mag_rel <= TOL_MAGNITUDE,
            f"magnitudes preserved: max per-bin relative error {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    finite = bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()
                  and torch.isfinite(y).all())
    n = x.shape[-1]
    recon = float((proc.istft((sr, si))[:, :n] - torch.as_tensor(x, device=dev)).abs().max())
    # the synthesis covers whole hops: 80000 samples at hop 256 come back as 80128
    s.check(finite and y.shape[0] == B and n <= y.shape[-1] < n + proc.fshift,
            f"finite outputs, istft shape {tuple(y.shape)} for {n} samples at hop {proc.fshift}")
    s.check(recon <= TOL_RECON,
            f"istft(stft(x)) reconstructs x: max|d| {recon:.2e} (tol {TOL_RECON:g})")
    c01 = float(c_out[:2].mean())
    print(f"  final consistency: mean {float(c_out.mean()):.3f} dB over {B} (min "
          f"{float(c_out.min()):.3f}, max {float(c_out.max()):.3f}); utterances 0-1 "
          f"{c01:.4f} dB")
    s.check(c01 >= MUSIC_JAX_DB - MUSIC_MARGIN_DB,
            f"utterances 0-1 {c01:.4f} dB >= lws_tpu's {MUSIC_JAX_DB} - {MUSIC_MARGIN_DB} dB")

    # run_lws wall, median of 3
    run_walls = []
    for _ in range(3):
        s.sync()
        t0 = time.perf_counter()
        proc.run_lws(pair)
        s.sync()
        run_walls.append(time.perf_counter() - t0)
    wall = float(np.median(run_walls))
    print(f"  run_lws wall (median of 3): {wall * 1e3:.2f} ms -> {B * secs / wall:.1f} audio-s/s")

    # the online kernel alone (its wrapper) on the no-future output, its
    # bound, and the plain online stage on the same input
    on_thr = torch.as_tensor(lws_torch.get_thresholds(proc.online_iterations, 1, 0.1, 1),
                             dtype=torch.float32, device=dev)
    on_args = (*stages[1], proc._st_la, proc._st_nofuture, proc._st_af, on_thr,
               proc.inner_passes, proc.inner_scheme)
    ms = cuda_ms(torch, lambda: online_mod.packed_rtisi_la(*on_args), 3)
    s.sync()
    t0 = time.perf_counter()
    plain_on = online_mod.packed_rtisi_la(*on_args, backend="torch")
    s.sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    dc_on = float((proc.get_consistency(plain_on) - cs[2]).abs().max())
    bound_ms, bound_by, flops, nbytes, updates = online_bound(
        proc, online_mod, T, F, B, proc.online_iterations)
    print(f"  online kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (per-utterance consistency "
          f"kernel vs plain max {dc_on:.4f} dB), bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops:.4g} flop, {nbytes:.4g} B), {updates} serial row updates per CTA -> "
          f"{1e3 * ms / updates:.3f} us per row update")

    # the sweep kernel at F=513 (weights read from device memory): the
    # batch stage alone on the online output
    st = proc._st_batch
    b_thr = torch.as_tensor(lws_torch.get_thresholds(proc.batch_iterations, 100, 0.1, 1),
                            dtype=torch.float32, device=dev)
    ip = proc.batch_inner_passes
    b_ms = cuda_ms(torch, lambda: sweeps_mod.tiled_lws_sweeps(*stages[2], st, b_thr, ip,
                                                              proc.inner_scheme), 3)
    live = sweeps_mod.sweep_schedule(*stages[2], b_thr)[2]
    b_bound, b_by, b_flops, _, b_serial = sweep_bound(st, ip, live, T, F, B)
    print(f"  batch-stage sweep kernel (F={F}) {b_ms:.2f} ms, bound {b_bound:.4f} ms by "
          f"{b_by} ({b_flops:.4g} flop), {b_serial} serial steps per CTA -> "
          f"{1e3 * b_ms / b_serial:.3f} us per step")

    # the whole path against the plain version on utterances 0-1
    plain_proc = lws_torch.LWS(1024, 256, mode="music", device=dev, backend="torch")
    p_pair = (amp[:2], torch.zeros_like(amp[:2]))
    p_stages, p_walls = [p_pair], []
    for stage in (plain_proc.nofuture_lws, plain_proc.online_lws, plain_proc.batch_lws):
        s.sync()
        t0 = time.perf_counter()
        p_stages.append(stage(p_stages[-1]))
        s.sync()
        p_walls.append(time.perf_counter() - t0)
    c_plain = plain_proc.get_consistency(p_stages[-1])
    d01 = float((c_plain - c_out[:2]).abs().max())
    print(f"  plain music path, utterances 0-1: {float(c_plain.mean()):.4f} dB, stage walls "
          + ", ".join(f"{1e3 * w:.1f}" for w in p_walls) + f" ms; |kernels - plain| {d01:.4f} dB")
    s.check(d01 <= TOL_PLAIN_DB,
            f"kernels vs plain consistency of run_lws, utterances 0-1: {d01:.4f} dB "
            f"(tol {TOL_PLAIN_DB})")

    online_entry = dict(
        name="lws_online", route="cuda", source="lws_torch/csrc/lws_online.cu",
        replaces="lws_tpu/ops/pallas_packed.py:985", launches=launches["lws_online"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=[B, int(T), int(F)], rounds=proc.online_iterations,
        look_ahead=proc.look_ahead, row_updates=updates)
    music_sweeps = dict(launches=launches["lws_sweeps"], batch_stage_ms=b_ms,
                        batch_stage_bound_ms=b_bound, shape=[B, int(T), int(F)],
                        run_lws_ms=1e3 * wall, audio_s_per_s=B * secs / wall,
                        consistency_db=float(c_out.mean()))
    return online_entry, music_sweeps


class KernelTimer:
    """CUDA events around each call of a wrapper, summed: installed on the
    wrapper's module while a run is timed (StreamingLWS calls it there)."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.fn = getattr(module, name)
        self.events = []

    def __enter__(self):
        def timed(*args, **kw):
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(*args, **kw)
            b.record()
            self.events.append((a, b))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self):
        self.torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.events))


def stream_path(s, torch, lws_torch, online_mod):
    """Phase 6. Returns the kernels-line entry for the chunked online
    kernel (K4)."""
    from lws_torch.stft import frame_signal
    dev = torch.device(DEVICE)
    B, secs, sr_hz, chunk = STREAM_B, STREAM_SECONDS, SAMPLE_RATE, STREAM_CHUNK
    x = make_batch(B, int(secs * sr_hz), sr_hz, np.random.default_rng(STREAM_SEED))
    proc = lws_torch.LWS(512, 128, look_ahead=3, online_iterations=10, device=dev)
    fsize, fshift, LA = proc.fsize, proc.fshift, proc.look_ahead

    def stream(**kw):
        kw = dict(dict(streams=B, block_frames=STREAM_BLOCK, emit="device"), **kw)
        return lws_torch.StreamingLWS(proc, **kw)

    def run(st, xs=x):
        """push_block the 0.5 s chunks, flush, and collect the audio on the
        host (inside a timed run: a caller needs the bytes)."""
        st.reset()
        outs = [st.push_block(xs[:, i:i + chunk]) for i in range(0, xs.shape[-1], chunk)]
        outs.append(st.flush())
        return np.concatenate([st.fetch(o) for o in outs], axis=-1)

    # one run of the streaming path, through the user entry points, counted
    st = stream(keep_frames=True)
    online_mod.CHUNK_LAUNCHES = 0
    y = run(st)
    s.sync()
    launches = online_mod.CHUNK_LAUNCHES
    live = -(-x.shape[-1] // fshift)  # frames holding samples, all committed
    print(f"streaming path: StreamingLWS(LWS(512, 128, look_ahead={LA}, "
          f"online_iterations=10), streams={B}, block_frames={STREAM_BLOCK}, "
          f"emit='device') on {B} x {secs:g} s pushed in {chunk}-sample chunks, then "
          f"flush: {st._frames_seen} frames through the kernel ({live} live)")
    s.check(launches >= 1 and launches == st._frames_seen // STREAM_BLOCK,
            f"lws_online_chunk kernel launches in the streaming run: {launches} (one per "
            f"{STREAM_BLOCK}-frame block of push_block and flush: "
            f"{st._frames_seen // STREAM_BLOCK})")

    com = np.stack(st.committed_frames, axis=1)  # (B, frames, F) complex64
    s.check(com.shape[1] == live, f"committed frames per stream {com.shape[1]} (live {live})")
    n_out = live * fshift + fsize
    s.check(bool(np.isfinite(y).all()) and y.shape == (B, n_out),
            f"finite audio {y.shape} (expected ({B}, {n_out}): a hop per committed frame "
            f"plus the {fsize}-sample tail)")
    xt = torch.as_tensor(x, device=dev)
    frames = frame_signal(xt, fsize, fshift, live) * torch.as_tensor(
        proc.awin, dtype=torch.float32, device=dev)
    A = torch.fft.rfft(frames, n=proc.fftsize, dim=-1).abs()
    com_t = torch.as_tensor(com, device=dev)
    # per-bin relative error; the stream's rfft ran block by block, so bins
    # under 1e-6 x max |STFT| are held to that floor instead of their own size
    mag_rel = float(((com_t.abs() - A).abs() / A.clamp_min(1e-6 * float(A.max()))).max())
    s.check(mag_rel <= TOL_MAGNITUDE,
            f"magnitudes of the committed frames vs |STFT|: {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    pair = (com_t.real.contiguous(), com_t.imag.contiguous())
    c = proc.get_consistency(pair)
    c01 = float(c[:2].mean())
    c_in = float(proc.get_consistency((A, torch.zeros_like(A))).mean())
    print(f"  consistency of the committed spectrogram: |STFT| alone {c_in:.3f} dB -> mean "
          f"{float(c.mean()):.3f} dB over {B} (min {float(c.min()):.3f}, max "
          f"{float(c.max()):.3f}); streams 0-1 {c01:.4f} dB")
    s.check(c01 >= STREAM_JAX_DB - STREAM_MARGIN_DB,
            f"streams 0-1 {c01:.4f} dB >= lws_tpu's {STREAM_JAX_DB} - {STREAM_MARGIN_DB} dB")

    # device emit against host emit, with and without prefetch: same bits
    y_host = run(stream(emit="host"))
    y_nopf = run(stream(prefetch=False))
    s.check(np.array_equal(y, y_host) and np.array_equal(y, y_nopf),
            "emit='device' (prefetch on / off) and emit='host' give bit-identical audio")

    # the stream wall: median of 7 runs after a warm-up run
    st = stream()
    run(st)
    walls = []
    for _ in range(7):
        s.sync()
        t0 = time.perf_counter()
        run(st)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    with KernelTimer(torch, online_mod, "online_chunk") as kt:
        s.sync()
        t0 = time.perf_counter()
        run(st)
        s.sync()
        timed_wall = time.perf_counter() - t0
    ms = kt.ms()
    print(f"  stream wall (median of 7): {1e3 * wall:.2f} ms -> {B * secs / wall:.1f} audio-s/s; "
          f"walls {', '.join(f'{1e3 * w:.1f}' for w in sorted(walls))} ms; K4 (its wrapper, "
          f"CUDA events, summed over the {len(kt.events)} calls of one run) {ms:.3f} ms = "
          f"{100 * ms / (1e3 * timed_wall):.1f}% of that run's {1e3 * timed_wall:.2f} ms")

    # the plain chunk path (backend="torch") on the same streams
    sp = stream(backend="torch", keep_frames=True)
    with KernelTimer(torch, online_mod, "online_chunk") as pt:
        t0 = time.perf_counter()
        y_plain = run(sp)
        s.sync()
        plain_wall = time.perf_counter() - t0
    plain_ms = pt.ms()
    com_p = torch.as_tensor(np.stack(sp.committed_frames, axis=1), device=dev)
    c_p = proc.get_consistency((com_p.real.contiguous(), com_p.imag.contiguous()))
    dcs = (c - c_p).abs()
    print(f"  plain chunk path: stream wall {1e3 * plain_wall:.1f} ms, its online_chunk "
          f"{plain_ms:.1f} ms; consistency mean {float(c_p.mean()):.3f} dB, |K4 - plain| per "
          f"stream {', '.join(f'{float(v):.4f}' for v in dcs)} dB; audio shape "
          f"{y_plain.shape}")
    s.check(float(dcs[:2].max()) <= TOL_ONLINE_DB and y_plain.shape == y.shape,
            f"K4 vs plain chunk path, streams 0-1: per-stream consistency max "
            f"{float(dcs[:2].max()):.4f} dB (tol {TOL_ONLINE_DB})")

    # latency table (BENCHMARKS.md): host-synchronous pushes at 32 and 8
    # frames a block, and the pipelined block_frames=1 device-emit point
    # K4's time per launch (CUDA events around its wrapper) rides along
    lat = {}
    for bf, n_push in ((32, 16), (8, 64)):
        sl = stream(emit="host", block_frames=bf)
        n = bf * fshift * 8  # warm-up: 8 blocks
        sl.push_block(x[:, :n])
        sl.stats.reset()
        with KernelTimer(torch, online_mod, "online_chunk") as kt:
            for i in range(n, min(n + bf * fshift * n_push, x.shape[-1]), bf * fshift):
                sl.push_block(x[:, i:i + bf * fshift])
        sm = sl.stats.summary()
        lat[bf] = dict(mode="sync", **{f"p{q}_ms": 1e3 * sm[f"p{q}_s"] for q in (50, 95, 99)},
                       pushes=sm["pushes"], k4_ms_per_launch=kt.ms() / len(kt.events))
    sp1 = stream(block_frames=1)
    hop, n_warm, n_push = fshift, 16, 128
    outs = [sp1.push_block(x[:, i:i + hop]) for i in range(0, n_warm * hop, hop)]
    sp1.fetch(outs[-1])
    s.sync()
    per, amorts, pos = [], [], n_warm * hop
    with KernelTimer(torch, online_mod, "online_chunk") as kt:
        for _ in range(3):
            t0 = time.perf_counter()
            last = None
            for _ in range(n_push):
                t1 = time.perf_counter()
                last = sp1.push_block(x[:, pos:pos + hop])
                per.append(time.perf_counter() - t1)
                pos = (pos + hop) % (x.shape[-1] - hop)
            sp1.fetch(last)  # the drain: amortised time includes it
            amorts.append((time.perf_counter() - t0) / n_push)
    amort = float(np.median(amorts))
    lat[1] = dict(mode="pipelined", **{f"p{q}_ms": 1e3 * float(np.percentile(per, q))
                                       for q in (50, 95, 99)},
                  pushes=len(per), k4_ms_per_launch=kt.ms() / len(kt.events),
                  amortized_ms=1e3 * amort, rt_factor=(hop / sr_hz) / amort)
    for bf, row in lat.items():
        print(f"  latency block_frames={bf} ({bf * hop / sr_hz * 1e3:g} ms of audio per push, "
              f"{row['mode']}, {row['pushes']} pushes): p50 {row['p50_ms']:.3f}, p95 "
              f"{row['p95_ms']:.3f}, p99 {row['p99_ms']:.3f} ms; K4 {row['k4_ms_per_launch']:.3f} "
              f"ms per launch"
              + (f"; amortised {row['amortized_ms']:.3f} ms per {hop / sr_hz * 1e3:g} ms hop "
                 f"(drain included) -> {row['rt_factor']:.2f} x real time"
                 if bf == 1 else ""))

    T_live = live
    bound_ms, bound_by, flops, nbytes, updates = online_bound(
        proc, online_mod, T_live, int(com.shape[-1]), B, 10,
        frames=launches * STREAM_BLOCK, launches=launches)
    print(f"  K4 bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} flop, {nbytes:.4g} B over "
          f"{launches} launches); {updates} row updates per CTA -> "
          f"{1e3 * ms / updates:.3f} us per row update")
    return dict(name="lws_online_chunk", route="cuda", source="lws_torch/csrc/lws_online.cu",
                replaces="lws_tpu/ops/pallas_packed.py:1180", launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=[B, launches * STREAM_BLOCK, int(com.shape[-1])], live_frames=T_live,
                rounds=10, look_ahead=LA, row_updates=updates, stream_wall_ms=1e3 * wall,
                audio_s_per_s=B * secs / wall, consistency_db=float(c.mean()), latency=lat)


def main_path(s, torch, lws_torch, sweeps_mod):
    """Phase 4. Returns lws_sweeps' numbers on the batch path's run."""
    dev = torch.device(DEVICE)
    B, secs, sr_hz, iters = MAIN_B, MAIN_SECONDS, SAMPLE_RATE, MAIN_SWEEPS
    x = make_batch(B, int(secs * sr_hz), sr_hz, np.random.default_rng(0))
    proc = lws_torch.LWS(512, 128, device=dev)

    # one run of the main path, through the user entry points, counted
    sweeps_mod.LAUNCHES = 0
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    c_in = proc.get_consistency(pair)
    out = proc.batch_lws(pair)
    c_out = proc.get_consistency(out)
    y = proc.istft(out)
    s.sync()
    launches = sweeps_mod.LAUNCHES
    T, F = amp.shape[-2:]
    print(f"main path: LWS(512, 128) on {B} x {secs:g} s, spectrogram {tuple(amp.shape)}, "
          f"{iters} sweeps, batch_inner_passes={proc.batch_inner_passes}, "
          f"inner_scheme={proc.inner_scheme}")
    s.check(launches >= 1, f"lws_sweeps kernel launches in the main-path run: {launches}")

    # output checks
    mag = torch.sqrt(out[0] ** 2 + out[1] ** 2)
    mag_rel = float(((mag - amp).abs() / amp.clamp_min(1e-30)).max())
    s.check(mag_rel <= TOL_MAGNITUDE,
            f"magnitudes preserved: max per-bin relative error {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    finite = bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()
                  and torch.isfinite(y).all())
    s.check(finite and tuple(y.shape) == (B, x.shape[-1]),
            f"finite outputs, istft shape {tuple(y.shape)}")
    c_mean = float(c_out.mean())
    print(f"  consistency: input {float(c_in.mean()):.3f} dB -> output {c_mean:.3f} dB "
          f"(min {float(c_out.min()):.3f}, max {float(c_out.max()):.3f})")
    s.check(c_mean >= MIN_CONSISTENCY_DB,
            f"mean consistency {c_mean:.3f} dB >= {MIN_CONSISTENCY_DB} dB")
    sx, si_x = proc.stft_ri(x)
    recon = float((proc.istft((sx, si_x)) - torch.as_tensor(x, device=dev)).abs().max())
    s.check(recon <= TOL_RECON, f"istft(stft(x)) reconstructs x: max|d| {recon:.2e} (tol {TOL_RECON:g})")

    # batch_lws wall, median of 3
    walls = []
    for _ in range(3):
        s.sync()
        t0 = time.perf_counter()
        proc.batch_lws(pair)
        s.sync()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    print(f"  batch_lws wall (median of 3): {wall * 1e3:.2f} ms -> "
          f"{B * secs / wall:.1f} audio-s/s")

    # the kernel alone (its wrapper) and the plain version, same inputs
    st = proc._st_batch
    thr = torch.as_tensor(lws_torch.get_thresholds(iters, 100, 0.1, 1),
                          dtype=torch.float32, device=dev)
    ip, scheme = proc.batch_inner_passes, proc.inner_scheme
    kernel = lambda: sweeps_mod.tiled_lws_sweeps(*pair, st, thr, ip, scheme)  # noqa: E731
    ms = cuda_ms(torch, kernel, 3)
    s.sync()
    t0 = time.perf_counter()
    plain = sweeps_mod.tiled_lws_sweeps(*pair, st, thr, ip, scheme, backend="torch")
    s.sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    c_plain = proc.get_consistency(plain)
    d01 = float((c_out[:2] - c_plain[:2]).abs().max())
    dall = float((c_out - c_plain).abs().max())
    print(f"  plain version: mean {float(c_plain.mean()):.3f} dB; |kernel - plain| "
          f"utterances 0-1 {d01:.4f} dB, all {dall:.4f} dB")
    s.check(d01 <= TOL_PLAIN_DB,
            f"kernel vs plain consistency, utterances 0-1: {d01:.4f} dB (tol {TOL_PLAIN_DB})")

    live = sweeps_mod.sweep_schedule(*pair, thr)[2]
    bound_ms, bound_by, flops, nbytes, serial = sweep_bound(st, ip, live, T, F, B)
    print(f"  kernel {ms:.2f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({flops:.4g} flop, {nbytes:.4g} B, live sweeps per utterance "
          f"{int(live.sum(dim=1).min())}-{int(live.sum(dim=1).max())}), "
          f"serial barrier steps per CTA {serial} -> {1e3 * ms / serial:.3f} us per step")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=[B, int(T), int(F)], sweeps=iters,
                live_sweeps=int(live.sum()), serial_steps=serial)


def longform_path(s, torch, lws_torch, sweeps_mod, seg_mod):
    """Phase 7. Returns the longform numbers of lws_sweeps (K1 under the
    segmented sweeps, K2)."""
    dev = torch.device(DEVICE)
    n = int(LONG_SECONDS * LONG_RATE)
    x = make_batch(1, n, LONG_RATE, np.random.default_rng(LONG_SEED))
    proc = lws_torch.LWS(LONG_FSIZE, LONG_FSHIFT, device=dev)
    st, ip, scheme = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme
    thr = torch.as_tensor(lws_torch.get_thresholds(MAIN_SWEEPS, 100, 0.1, 1),
                          dtype=torch.float32, device=dev)

    # one run of the longform path, through the user entry points, counted;
    # CUDA events around each K1 call (its wrapper)
    sweeps_mod.LAUNCHES = 0
    with KernelTimer(torch, sweeps_mod, "tiled_lws_sweeps") as kt:
        sr, si = proc.stft_ri(x)
        amp = torch.sqrt(sr * sr + si * si)
        pair = (amp, torch.zeros_like(amp))
        c_in = proc.get_consistency(pair)
        s.sync()
        t0 = time.perf_counter()
        out = proc.batch_lws(pair)
        s.sync()
        wall = time.perf_counter() - t0
        c_out = proc.get_consistency(out)
        y = proc.istft(out)
        s.sync()
    launches = sweeps_mod.LAUNCHES
    k1_ms = kt.ms()
    T, F = amp.shape[-2:]
    S = proc._auto_segments(1, T)
    blocks = -(-MAIN_SWEEPS // proc._SWEEPS_PER_EXCHANGE) if S > 1 else 1
    print(f"longform path: LWS({LONG_FSIZE}, {LONG_FSHIFT}) on 1 x {LONG_SECONDS:g} s at "
          f"{LONG_RATE} Hz, spectrogram {tuple(amp.shape)}, {MAIN_SWEEPS} sweeps, "
          f"batch_inner_passes={ip}; plan S = {S} ({proc._n_sm} SMs)")
    s.check(S > 1 and launches == blocks,
            f"lws_sweeps kernel launches in the longform run: {launches} (S = {S}: one per "
            f"{proc._SWEEPS_PER_EXCHANGE}-sweep block, expected {blocks})")

    # steps and bound: each segment's live sweeps (its max |S| against the
    # whole signal's mean thresholds), Tseg frames each
    Tseg = -(-T // S)
    a_pad = torch.cat([amp, amp[:, -1:].expand(1, S * Tseg - T, F)], dim=1)
    seg_max = a_pad.reshape(S, Tseg, F).amax(dim=(-2, -1))
    live = (seg_max[:, None] > thr[None, :] * amp.mean()).to(torch.int32)
    bound_ms, bound_by, flops, nbytes, steps = sweep_bound(st, ip, live, Tseg, F, S)
    print(f"  batch_lws wall {1e3 * wall:.2f} ms -> {LONG_SECONDS / wall:.1f} audio-s/s; K1 "
          f"(its wrapper, CUDA events, summed over {len(kt.events)} calls) {k1_ms:.2f} ms; "
          f"{steps} steps per CTA ({Tseg} frames per segment, live sweeps per segment "
          f"{int(live.sum(dim=1).min())}-{int(live.sum(dim=1).max())}) -> "
          f"{1e3 * k1_ms / steps:.3f} us per step; bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops:.4g} flop; {nbytes:.4g} B would take {1e3 * nbytes / PEAK_BYTES_S:.4f} ms)")
    mag_rel = float(((torch.sqrt(out[0] ** 2 + out[1] ** 2) - amp).abs()
                     / amp.clamp_min(1e-30)).max())
    s.check(mag_rel <= TOL_MAGNITUDE,
            f"magnitudes preserved: max per-bin relative error {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    finite = bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()
                  and torch.isfinite(y).all())
    s.check(finite and y.shape[0] == 1 and n <= y.shape[-1] < n + proc.fshift,
            f"finite outputs, istft shape {tuple(y.shape)} for {n} samples at hop {proc.fshift}")
    c0, c1 = float(c_in[0]), float(c_out[0])
    print(f"  consistency (blocked): |X| {c0:.4f} dB -> {c1:.4f} dB")
    s.check(c1 > c0 + 5, f"consistency rises: {c0:.4f} -> {c1:.4f} dB")
    del out, y

    # (a) the segmented sweeps on the kernel against the plain sweeps on the
    # card: the 20 s prefix, random phases, 4 segments, an exchange every 5
    # sweeps, 12 sweeps at alpha=1 (K1's first case at F=2049)
    rng = np.random.default_rng(9)
    prefix = x[:, :int(LONG_PREFIX_SECONDS * LONG_RATE)]
    psr, psi = proc.stft_ri(prefix)
    r0, i0, pamp = random_phases(torch, rng, psr, psi)
    thr12 = torch.as_tensor(lws_torch.get_thresholds(12, 1, 0.1, 1), dtype=torch.float32,
                            device=dev)
    kw = dict(segments=4, sweeps_per_exchange=5, inner_passes=ip, inner_scheme=scheme)
    before = sweeps_mod.LAUNCHES
    kr, ki = seg_mod.segmented_lws_sweeps(r0, i0, st, thr12, **kw)
    s.sync()
    a_launches = sweeps_mod.LAUNCHES - before
    a_ms = cuda_ms(torch, lambda: seg_mod.segmented_lws_sweeps(r0, i0, st, thr12, **kw), 3)
    s.sync()
    t0 = time.perf_counter()
    pr, pi = seg_mod.segmented_lws_sweeps(r0, i0, st, thr12, backend="torch", **kw)
    s.sync()
    a_plain_ms = 1e3 * (time.perf_counter() - t0)
    d = float(torch.maximum((kr - pr).abs(), (ki - pi).abs()).max())
    rel = d / float(pamp.max())
    a_live = sweeps_mod.sweep_schedule(r0, i0, thr12)[2]
    a_bound = sweep_bound(st, ip, a_live.expand(4, -1), -(-r0.shape[-2] // 4), F, 4)[0]
    s.check(np.isfinite(d) and rel <= TOL_CASE and a_launches == 3,
            f"case (a) segmented sweeps, kernel vs plain on the card, {tuple(r0.shape)}, 4 "
            f"segments, exchange every 5, 12 sweeps alpha=1, {a_launches} K1 launches: "
            f"max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g}); kernel {a_ms:.2f} ms, plain "
            f"{a_plain_ms:.1f} ms")

    # (b) the seams: the plan's S against one segment, 120 s prefix
    whole = lws_torch.LWS(LONG_FSIZE, LONG_FSHIFT, device=dev, auto_segment=False)
    bsr, bsi = proc.stft_ri(x[:, :int(LONG_SEAM_SECONDS * LONG_RATE)])
    bamp = torch.sqrt(bsr * bsr + bsi * bsi)
    bpair = (bamp, torch.zeros_like(bamp))
    S_b = proc._auto_segments(1, bamp.shape[-2])
    res = {}
    for label, p in (("plan", proc), ("one segment", whole)):
        s.sync()
        t0 = time.perf_counter()
        o = p.batch_lws(bpair)
        s.sync()
        res[label] = (float(p.get_consistency(o)[0]), time.perf_counter() - t0)
    dseam = abs(res["plan"][0] - res["one segment"][0])
    s.check(S_b > 1 and dseam <= TOL_SEAM_DB,
            f"case (b) seams, {tuple(bamp.shape)}: S = {S_b} {res['plan'][0]:.4f} dB "
            f"({1e3 * res['plan'][1]:.1f} ms) vs one segment {res['one segment'][0]:.4f} dB "
            f"({1e3 * res['one segment'][1]:.1f} ms): {dseam:.4f} dB (tol {TOL_SEAM_DB})")

    # (c) the floor: the 20 s prefix from zero phase (S = 1), against
    # lws_tpu's float32 result on the CPU
    cpair = (pamp, torch.zeros_like(pamp))
    c_floor = float(proc.get_consistency(proc.batch_lws(cpair))[0])
    s.check(c_floor >= LONG_JAX_DB - LONG_MARGIN_DB,
            f"case (c) {tuple(pamp.shape)} from zero phase (S = "
            f"{proc._auto_segments(1, pamp.shape[-2])}): {c_floor:.4f} dB >= lws_tpu's "
            f"{LONG_JAX_DB} - {LONG_MARGIN_DB} dB")
    # K1's kernels-line numbers: launches, time, bound and steps of the
    # longform run; the plain version's time is case (a)'s, the path's
    # kernel-vs-plain comparison on one input (its kernel time: case_a)
    return dict(launches=launches, ms=k1_ms, plain_ms=a_plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, serial_steps=steps, shape=[1, int(T), int(F)],
                sweeps=MAIN_SWEEPS, segments=S, sweeps_per_exchange=proc._SWEEPS_PER_EXCHANGE,
                wall_ms=1e3 * wall, audio_s_per_s=LONG_SECONDS / wall, consistency_db=c1,
                consistency_in_db=c0,
                case_a=dict(shape=[1, int(r0.shape[-2]), int(F)], segments=4, sweeps=12,
                            launches=a_launches, ms=a_ms, plain_ms=a_plain_ms,
                            bound_ms=a_bound, max_abs_err=d),
                seams_db=res["plan"][0], one_segment_db=res["one segment"][0],
                seams_ms=1e3 * res["plan"][1], one_segment_ms=1e3 * res["one segment"][1],
                floor_db=c_floor)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import lws_torch
    from lws_torch.ops import lws_sweeps as sweeps_mod
    from lws_torch.ops import online as online_mod
    from lws_torch.ops import packed as packed_mod
    from lws_torch.ops import segmented as seg_mod

    s = Smoke(torch)
    card_lines(torch)
    build_phase()
    worst = kernel_cases(s, torch, lws_torch, sweeps_mod)
    worst_online = online_cases(s, torch, lws_torch, online_mod)
    worst_chunk = chunk_cases(s, torch, lws_torch, online_mod)
    worst_packed = packed_cases(s, torch, lws_torch, sweeps_mod, packed_mod)
    batch_sweeps = main_path(s, torch, lws_torch, sweeps_mod)
    packed_entry = packed_timing(s, torch, lws_torch, sweeps_mod, packed_mod)
    online_entry, music_sweeps = music_path(s, torch, lws_torch, sweeps_mod, online_mod)
    chunk_entry = stream_path(s, torch, lws_torch, online_mod)
    longform = longform_path(s, torch, lws_torch, sweeps_mod, seg_mod)
    # K1: the longform path's run (this slice's path) at the top; the batch
    # path's run and the music path's batch stage nested, each from its own
    # run
    entry = dict(name="lws_sweeps", route="cuda", source="lws_torch/csrc/lws_sweeps.cu",
                 replaces="lws_tpu/ops/pallas_packed.py:1411", library_ms=None,
                 **longform, batch=batch_sweeps, music=music_sweeps)
    entry["max_abs_err"] = worst
    online_entry["max_abs_err"] = worst_online
    chunk_entry["max_abs_err"] = worst_chunk
    packed_entry["max_abs_err"] = worst_packed
    kernels = [entry, online_entry, chunk_entry, packed_entry]
    for e in kernels:
        e["checks"] = "pass" if not s.failures else "fail"
    print(json.dumps({"kernels": kernels}))
    if s.failures:
        print("chip_smoke: FAILED: " + "; ".join(s.failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
