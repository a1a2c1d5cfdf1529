#!/usr/bin/env python3
"""Drive lws_torch's main path on one NVIDIA GPU and hold its kernel to its
plain PyTorch version.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases, in order:
  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. the build of every kernel of the path from lws_torch/csrc (timed, with
     the ptxas register / shared-memory report);
  3. each kernel against its plain version on the card, same float32
     inputs made from a numpy seed, at the main path's shapes;
  4. the main path at full width: LWS(512, 128) on 32 x 5 s utterances at
     16 kHz, stft -> batch_lws(|X|) (100 sweeps) -> get_consistency ->
     istft, with the launch counts of that one run, the kernel and plain
     times, and the output checks (magnitudes, consistency, agreement with
     the plain version);
  5. the kernels line (JSON), then the result line (JSON) last.

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

# Sizes: the main path at full width (bench.py's batch workload), the
# kernel-vs-plain cases at its frame count with fewer utterances.
DEVICE = "cuda"
MAIN_B, MAIN_SECONDS, SAMPLE_RATE, MAIN_SWEEPS = 32, 5.0, 16000, 100
CASE_B = 4


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


def build_phase():
    from lws_torch.ops import _build
    t0 = time.time()
    path = _build.build("lws_sweeps")
    _build.load("lws_sweeps")
    print(f"build: lws_sweeps.cu in {time.time() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def kernel_cases(s, torch, lws_torch, sweeps_mod):
    """Phase 3: kernel vs plain on the card. Returns the largest max |delta|."""
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
    in4, in2 = random_phase(q4), random_phase(q2)
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

    s = Smoke(torch)
    card_lines(torch)
    build_phase()
    worst = kernel_cases(s, torch, lws_torch, sweeps_mod)
    entry = main_path(s, torch, lws_torch, sweeps_mod)
    entry["max_abs_err"] = worst
    entry["checks"] = "pass" if not s.failures else "fail"
    print(json.dumps({"kernels": [entry]}))
    if s.failures:
        print("chip_smoke: FAILED: " + "; ".join(s.failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
