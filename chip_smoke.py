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
     shared memory) and the online kernel (cases e-g);
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
  6. the kernels line (JSON), then the result line (JSON) last.

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

# Sizes: the main path at full width (bench.py's batch workload), the
# kernel-vs-plain cases at its frame count with fewer utterances.
DEVICE = "cuda"
MAIN_B, MAIN_SECONDS, SAMPLE_RATE, MAIN_SWEEPS = 32, 5.0, 16000, 100
CASE_B = 4
# The music path: bench.py's pipeline workload (bench.py:137-160).
MUSIC_B, MUSIC_SECONDS, MUSIC_SEED = 32, 5.0, 1


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


KERNELS = ("lws_sweeps", "lws_online")


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


def online_bound(proc, online_mod, T, F, B, iters):
    """(bound_ms, bound_by, flops, bytes, row updates per CTA) of one online
    stage: 8 flops per live tap and bin (complex multiply-add), ~12 flops of
    epilogue per bin and pass (colors update a 1/k share of the bins per
    pass), over the row updates the stage runs (frames before the start are
    skipped); each input and output plane touched once, the weight sets
    read once."""
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
    nbytes = 4.0 * (5 * B * T * F + 2 * len(sets) * sets[0].Wr.numel() + B * iters)
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


def main_path(s, torch, lws_torch, sweeps_mod):
    """Phase 4. Returns the kernels-line entry for lws_sweeps."""
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
    return dict(name="lws_sweeps", route="cuda", source="lws_torch/csrc/lws_sweeps.cu",
                replaces="lws_tpu/ops/pallas_packed.py:1411",
                launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                shape=[B, int(T), int(F)], sweeps=iters,
                live_sweeps=int(live.sum()), serial_steps=serial)


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

    s = Smoke(torch)
    card_lines(torch)
    build_phase()
    worst = kernel_cases(s, torch, lws_torch, sweeps_mod)
    worst_online = online_cases(s, torch, lws_torch, online_mod)
    entry = main_path(s, torch, lws_torch, sweeps_mod)
    online_entry, music_sweeps = music_path(s, torch, lws_torch, sweeps_mod, online_mod)
    # launches: the music path's run (this slice's path); the batch path's
    # own count and the batch-stage timing at F=513 ride along
    entry["launches_batch_path"] = entry["launches"]
    entry["launches"] = music_sweeps.pop("launches")
    entry["music"] = music_sweeps
    entry["max_abs_err"] = worst
    online_entry["max_abs_err"] = worst_online
    for e in (entry, online_entry):
        e["checks"] = "pass" if not s.failures else "fail"
    print(json.dumps({"kernels": [entry, online_entry]}))
    if s.failures:
        print("chip_smoke: FAILED: " + "; ".join(s.failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
