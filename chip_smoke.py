#!/usr/bin/env python3
"""Drive lws_torch's paths on one NVIDIA GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases, in order:
  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. the build of every kernel from lws_torch/csrc, one nvcc per source, all
     started together (timed, with the ptxas register / shared-memory
     report), and the launch plans of the sweep kernel, the online
     kernels and the grouped sweep kernel as the built libraries compute
     them against their Python mirrors (ops.lws_sweeps.sweep_plan,
     ops.online.online_plan, ops.packed.packed_plan);
  3. each kernel against its plain version on the card, same float32
     inputs made from a numpy seed, at the paths' shapes: the sweep kernel
     (cases a-d at F=257 / 129, h at F=513, where its weights do not all fit
     shared memory, l at Q=32 on the run-time path), the free function
     batch_lws on a complex128 spectrogram (float32 kernels, complex64
     out, against backend="torch" in float64), the online kernel (cases
     e-g) and the chunked online
     kernel (case i: chunked, against the online kernel bit for bit; case
     j: against its plain version, with the running mean), both online
     kernels at the geometries their weight-table design added (cases m-q:
     LWS(4096, 512, mode="music"), Q = 8, F = 2049, and a StreamingLWS of
     it; Q = 32; look_ahead = 10; F = 8193 with the ring in device memory;
     each against its plain version), and the grouped
     sweep kernel K5 (cases k: micro 2 and 4 against the plain group
     update, micro 1, which its wrapper runs on K1, against K1 and the plain
     sweeps; tiled_lws_sweeps and segmented_lws_sweeps at micro 2 on K5;
     the geometries K5's plan newly takes, F = 2049 at micro 5, Q = 16 and
     F = 8193; then its time at micro 4 on the batch path's input and at
     micro 2 and 4 on the music path's batch-stage input);
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
  8. fast mode: LWS(512, 128, order="jacobi_mxu") on the batch path's
     input (bench.py's fastmode row: no kernel, the plain whole-grid sweeps
     with banded torch.matmul products), its wall and consistency against
     order="jacobi" at precision=None, both orders after 5 sweeps from
     random phases, and a pure tone at precision "high" (TF32) against None;
  9. the vocoder path at full width: bench.py's vocoder row, a (1024, 223,
     80) mel through mel_vocoder_pipeline (mel_to_linear, 100 batch sweeps
     on K1's table kernel at Q = 8, F = 1025, 1024 CTAs), with the launch
     count of that one run and its table-kernel launches, audio-s/s, every
     tiled copy of the 16 unique utterances equal to its source bit for bit
     (all CTAs, all waves), the consistency of the
     first 16, K1's time, bound, plan and blocks per SM (the CUDA runtime's
     occupancy query), and K1 against its plain version on 2 utterances;
 10. resumable: resumable_lws on the batch path's input in chunks of 25
     sweeps, a fault injected after chunk 2, the resume from its checkpoint
     (bit-equal to the uninterrupted chunked run), the single call, and the
     witness of their gap: the same chunks on K1 given the input's time
     halos and mean magnitude;
 11. gradients: autograd (backend="torch") through 3 sweeps of each order
     and the iSTFT on 4 utterances with exact silence at both ends, a
     waveform L2 loss back to the magnitudes (finite, nonzero), float32
     held to float64 on the same input per well-conditioned utterance, and
     the backend="auto" call that must refuse (K1 has no backward);
 12. the sharded sweeps (lws_torch.parallel), each case's ranks spawned
     from this script, any rank's failure failing the run: (a) one NCCL
     rank, mesh (1, 1), batch_lws(mesh=) on the batch path's input (one
     time shard, nothing to exchange: one K1 launch for the 100 sweeps)
     against batch_lws() (from random phases bit for bit; from |X| by
     consistency); (b) four gloo ranks sharing the card, mesh (1, 4),
     kernel="tiled", longform's geometry on the 120 s prefix, an exchange
     every 3 sweeps (34 K1 launches per rank), against
     segmented_lws_sweeps given the same mean (from random phases, bit for
     bit) and the unsharded batch_lws (from |X|); (c) meshes (4, 1) (one
     launch a rank) and (2, 2) on the batch path's input; (d)
     order="jacobi_mxu" over (1, 4) at F = 2049; (e) scaling_report over
     the four ranks (estimate_only); (f) lws_torch.entry.dryrun_multichip
     in the four gloo ranks (mesh (2, 2), its four phases and checks at
     lws_tpu's sizes) and in the one NCCL rank (mesh (1, 1)), with each
     phase's K1 launches and phase 1's K3 launch per rank, then (not
     counted) the K1 and K3 calls it made held against their plain
     versions at its shapes and on its magnitudes from seeded random
     phases; (g) the multi-card example's two stages
     (examples.multichip.run) in both spawns, K1 and K3 launches per rank,
     and its kernels against their plain versions the same way. Then the
     multi-card example's command line once (python -m
     lws_torch.examples.multichip --ranks 4 --device cuda: rc 0 and both
     result lines). Per rank: the wall, K1's launches and K1's time (CUDA
     events); the ranks share one card, so no figure is a scaling figure;
 13. the kernels line (JSON), then the result line (JSON) last.

Every timed sweep-kernel (K1) run (the batch path, the music path's batch
stage, the longform path and its case (a)) prints its microseconds per
barrier step and per frame, its launch plan (threads, bins per thread,
the shared-memory window ring, tap planes staged, bytes) and the ptxas
registers and spills of the kernel the plan picks. The online kernels'
timed runs (K3 on the music path, K4 on the streaming run) print their
microseconds per row update, their launch plan (threads, bins per thread,
whether the ring, the weight table and K4's amp rows sit in shared memory,
bytes), and the registers and spills of the kernel picked and of every
variant of K3 and K4. The grouped sweep kernel's timed runs (K5) print
their microseconds per step, their launch plan (threads, elements per
thread, where the ring, the weight table, the centre buffers and the sums
sit, bytes, scratch) and the registers and spills of the kernel picked.

Exits non-zero, before any result line, without CUDA, without the repo's
lws_torch beside this file, or when any phase fails. Imports nothing of
jax or lws_tpu.
"""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
import warnings

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
Q32_FRAMES = 1000
# The free function on complex128 input: 2 utterances of 2 s, 30 sweeps
# (the plain float64 version runs on the card beside the kernel).
FREE_SECONDS, FREE_SWEEPS = 2.0, 30
# The music path: bench.py's pipeline workload (bench.py:137-160).
MUSIC_B, MUSIC_SECONDS, MUSIC_SEED = 32, 5.0, 1
# The streaming path: bench.py's streaming workload (bench.py:235-354), 8
# streams x 5 s pushed in 0.5 s chunks, one chunk launch per 64 frames.
STREAM_B, STREAM_SECONDS, STREAM_SEED, STREAM_CHUNK, STREAM_BLOCK = 8, 5.0, 5, 8000, 64
# Case k's geometries that K5's plan newly takes (the previous K5 kept the
# state's micro rows in shared memory and refused them): (label, LWS
# (fsize, fshift), micro, seconds of mixture at 16 kHz, sweeps at alpha=1).
K5_GEOMETRIES = (
    ("F = 2049 at micro 5, ring in device memory", (4096, 1024), 5, 2.0, 4),
    ("Q = 16 at micro 2", (1024, 64), 2, 0.5, 3),
    ("F = 8193 at micro 2, ring and centre buffers in device memory", (16384, 4096), 2, 5.0,
     3),
)

# Fast mode: bench.py's fastmode row (bench.py:357-376), LWS(512, 128,
# order="jacobi_mxu") on the batch path's input, held to order="jacobi":
# consistency within TOL_JACOBI_DB at precision=None (full float32), and
# the two within TOL_JACOBI_AMP x max amp after 5 sweeps from random phases.
# The pure tone: PURE_SECONDS of PURE_HZ at 16 kHz, 100 sweeps at alpha=100,
# jacobi_mxu at precision="high" (TF32) against None and against jacobi,
# printed. On a pure tone the two orders' float32 roundings alone move the
# result by more than TOL_JACOBI_DB (0.138 dB on an H100), so they are held
# to each other in float64, to TOL_JACOBI_F64_DB.
TOL_JACOBI_DB = 0.1
TOL_JACOBI_AMP = 1e-3
TOL_JACOBI_F64_DB = 1e-3
PURE_SECONDS, PURE_HZ = 3.0, 440.0
# The vocoder: bench.py's vocoder row (bench.py:181-210). 16 unique 2.5 s
# mixtures at 22.05 kHz, seed 3, LWS(2048, 256) (Q = 8, F = 1025), an
# 80-band Slaney mel, tiled to VOC_B utterances, then mel_to_linear and 100
# batch sweeps on K1. K1 against its plain version on VOC_CASE_B utterances
# from random phases, the schedule's last 3 sweeps.
VOC_B, VOC_UNIQUE, VOC_SECONDS, VOC_RATE, VOC_SEED = 1024, 16, 2.5, 22050, 3
VOC_FSIZE, VOC_FSHIFT, VOC_MELS, VOC_CASE_B = 2048, 256, 80, 2
# Resumable: resumable_lws on the batch path's input in chunks of
# RESUME_EVERY sweeps, a fault injected after chunk RESUME_FAULT_AFTER, the
# run resumed from its checkpoint (kept under build/, which git ignores).
# The resumed run equals the uninterrupted chunked run bit for bit and sits
# within TOL_RESUME_DB of the single-call batch_lws.
RESUME_EVERY, RESUME_FAULT_AFTER, TOL_RESUME_DB = 25, 2, 0.05
# Gradients: GRAD_B utterances of the batch path's input with GRAD_SILENCE
# seconds of exact silence at each end, GRAD_SWEEPS sweeps at alpha=1, a
# waveform L2 loss back to the magnitudes, backend="torch" on the card.
# Float64 on the same input is the witness: an utterance whose recovered
# spectrogram agrees in both precisions to GRAD_FWD_COND x max amp has its
# float32 gradient held to the float64 one to TOL_GRAD_F64 x max|g64|. On the
# CPU (port_tools/gs_grad_witness.py) gs's forwards part by 1.3e-5, 1.7e-2, 9.4e-3
# and 2.0 x max amp and its gradients by 3.4e-6, 2.6e-3 and 5.5e-3 on the
# first three; the fourth is ill-conditioned in lws_tpu as well.
GRAD_B, GRAD_SILENCE, GRAD_SWEEPS = 4, 0.25, 3
GRAD_FWD_COND, TOL_GRAD_F64 = 0.1, 2e-2


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


def ptxas_report(text):
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from an `nvcc -Xptxas -v` log."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props:
            out.setdefault(props, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def build_phase(s, sweeps_mod, online_mod):
    """Phase 2. Returns the ptxas report of both sources, one dict."""
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
    cases = [(F, Q, L, P, G) for F in (129, 257, 289, 513, 1025, 1533, 1534, 2049, 3073)
             for Q, L in ((4, 5), (2, 5), (5, 5), (8, 5), (16, 5), (32, 3))
             for P, G in ((None, None), (Q, 148))]
    differ = [c for c in cases if sweeps_mod.kernel_plan(*c) != sweeps_mod.sweep_plan(*c)]
    s.check(not differ, f"sweep kernel launch plan, built library vs Python mirror, "
            f"{len(cases)} geometries and stencils: "
            f"{'equal' if not differ else f'differ at {differ}'}")
    cases = [(F, Q, L, LA, chunk, taps, P)
             for F in (129, 257, 513, 2049, 8193)
             for Q, L, LA in ((4, 5, 3), (8, 5, 3), (32, 3, 3), (4, 5, 10))
             for chunk in (False, True)
             for taps, P in ((None, None), (216, Q), (216, F))]
    differ = [c for c in cases if online_mod.kernel_plan(*c) != online_mod.online_plan(*c)]
    s.check(not differ, f"online kernels' launch plan, built library vs Python mirror, "
            f"{len(cases)} geometries and tables: "
            f"{'equal' if not differ else f'differ at {differ}'}")
    from lws_torch.ops import packed as packed_mod
    cases = [(F, Q, L, micro, taps, P)
             for F in (129, 257, 513, 2049, 8193)
             for Q, L in ((4, 5), (2, 5), (16, 5))
             for micro in (2, 4, 5)
             for taps, P in ((None, None), (60, Q), (60, F))]
    differ = [c for c in cases if packed_mod.kernel_plan(*c) != packed_mod.packed_plan(*c)]
    s.check(not differ, f"grouped sweep kernel (K5) launch plan, built library vs Python "
            f"mirror, {len(cases)} geometries and tables: "
            f"{'equal' if not differ else f'differ at {differ}'}")
    ptxas = {}
    for name in KERNELS:
        ptxas.update(ptxas_report(paths[name].with_suffix(".log").read_text()))
    return ptxas


def k1_template(plan, Q):
    """The template arguments (KQ, KL, KNB, kRing, kAllStaged, kTable) of
    the lws_sweeps_kernel the launch plan picks (csrc/lws_sweeps.cu
    pick_kernel)."""
    if plan.table:
        return (8, 5, plan.bins, 1, 0, 1)
    if plan.fixed:
        return (Q, 5, plan.bins, 1, int(plan.bins == 1 and plan.staged == plan.taps), 0)
    if not plan.ring:
        return (0, 0, 0, 0, 0, 0)
    return (0, 0, 1 if plan.bins == 1 else 0, 1, 0, 0)


def k1_report(label, sweeps_mod, ptxas, st, F, ms, frames, passes, waves=1,
              blocks_per_sm=None):
    """Print a K1 run's microseconds per barrier step and per frame
    (`frames` serial frames per CTA, 1 + passes steps each, 1 without centre
    taps), its launch plan and its kernel's registers and spills; return
    them for the kernels line. Where the launch has more CTAs than the card
    holds at once, `blocks_per_sm` is the CUDA runtime's occupancy of the
    launched kernel (ops.lws_sweeps.kernel_occupancy) and `waves` the
    rounds of CTAs that follow from it: the per-step and per-frame times
    are then per wave, and `launch_us_per_frame` is the launch's time over
    one CTA's frames, undivided."""
    plan = sweeps_mod.stencil_plan(F, st)
    args = k1_template(plan, st.Q)
    key = "lws_sweeps_kernelI" + "".join(
        f"L{'i' if i < 3 else 'b'}{v}E" for i, v in enumerate(args))
    found = [v for k, v in ptxas.items() if key in k]
    regs = found[0] if found else {}
    steps = frames * (1 + passes if st.has_centre else 1)
    us_launch = 1e3 * ms / frames
    us_step, us_frame = 1e3 * ms / (steps * waves), us_launch / waves
    # weights one CTA reads from device memory (L2) per frame: the rows of
    # taps not staged, the centre row once per pass (8 bytes per tap and
    # bin); none with the table in shared memory
    K, rows = 2 * st.L + 1, plan.staged // (2 * st.L + 1)
    off_rows = 2 * st.Q - 2 - max(0, rows - 1)
    w_bytes = 0 if plan.table else 8 * F * K * (
        off_rows + (passes if rows == 0 and st.has_centre else 0))
    print(f"  K1 {label}: {ms:.2f} ms, {frames} frames x {steps // frames} steps per CTA"
          + (f", {waves} waves of CTAs ({blocks_per_sm} per SM by the runtime's occupancy "
             f"query; {us_launch:.3f} us per frame over the launch)" if waves > 1 else "")
          + f" -> "
          f"{us_step:.3f} us per step, {us_frame:.3f} us per frame; plan: {plan.threads} "
          f"threads x {plan.bins} bins, window ring in shared memory {plan.ring}, "
          f"{plan.staged}/{plan.taps} tap planes staged, period-Q table {plan.table}, "
          f"{plan.bytes} B; weights from device "
          f"memory {w_bytes} B per frame per CTA ({w_bytes / (1e3 * us_frame):.2f} GB/s "
          f"achieved); kernel lws_sweeps_kernel<{', '.join(map(str, args))}>: "
          f"{regs.get('registers')} registers, spill stores {regs.get('spill_stores')} B, "
          f"loads {regs.get('spill_loads')} B")
    return dict(us_per_step=us_step, us_per_frame=us_frame, launch_us_per_frame=us_launch,
                frames_per_cta=frames, waves=waves, blocks_per_sm=blocks_per_sm, threads=plan.threads, bins_per_thread=plan.bins, ring=plan.ring,
                taps_staged=plan.staged, taps=plan.taps, table=plan.table, smem_bytes=plan.bytes,
                weight_bytes_per_frame=w_bytes, kernel=list(args),
                registers=regs.get("registers"), spill_stores=regs.get("spill_stores"),
                spill_loads=regs.get("spill_loads"))


def online_template(plan):
    """The template arguments (KQ, KL, KNB, kRing) of the online kernel
    the launch plan picks (csrc/lws_online.cu pick_kernel)."""
    if plan.fixed:
        return (4, 5, plan.bins, 1)
    return (0, 0, 4 if plan.ring and plan.bins <= 4 else 16, int(plan.ring))


def online_registers(ptxas, chunk, args):
    """ptxas's {registers, spill_stores, spill_loads} of one online kernel."""
    name = "lws_online_chunk_kernel" if chunk else "lws_online_kernel"
    key = name + "I" + "".join(f"L{'i' if i < 3 else 'b'}{v}E" for i, v in enumerate(args))
    found = [v for k, v in ptxas.items() if key in k]
    return found[0] if found else {}


def online_variants(ptxas, chunk):
    """Print the registers and spills of every variant of K3 (chunk False)
    or K4 (True) that the build holds."""
    name = "lws_online_chunk_kernel" if chunk else "lws_online_kernel"
    for k, v in sorted(ptxas.items()):
        m = re.search(name + r"ILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E", k)
        if m and "registers" in v:
            print(f"    ptxas {name}<{', '.join(m.groups())}>: {v['registers']} registers, "
                  f"spill stores {v.get('spill_stores')} B, loads {v.get('spill_loads')} B")


def online_report(label, online_mod, ptxas, proc, F, chunk, ms, updates):
    """Print a K3 (chunk False) or K4 run's microseconds per row update
    (`updates` serial row updates per CTA), its launch plan and its
    kernel's registers and spills, then every variant's; return them for
    the kernels line."""
    wt = online_mod.online_weights(proc._st_la, proc._st_nofuture, proc._st_af)
    G = int(wt.dks.numel())
    plan = online_mod.online_plan(F, proc._Qi, proc.L, proc.look_ahead, chunk, G, wt.period)
    args = online_template(plan)
    regs = online_registers(ptxas, chunk, args)
    us = 1e3 * ms / updates
    name = "lws_online_chunk_kernel" if chunk else "lws_online_kernel"
    print(f"  {'K4' if chunk else 'K3'} {label}: {ms:.3f} ms, {updates} row updates per CTA "
          f"-> {us:.3f} us per row update; plan: {plan.threads} threads x {plan.bins} bins, "
          f"ring in shared memory {plan.ring}, table ({G} live taps x P = {wt.period}) in "
          f"shared memory {plan.table}, amp rows in shared memory {plan.amp}, {plan.bytes} B; "
          f"kernel {name}<{', '.join(map(str, args))}>: {regs.get('registers')} registers, "
          f"spill stores {regs.get('spill_stores')} B, loads {regs.get('spill_loads')} B")
    online_variants(ptxas, chunk)
    return dict(us_per_row_update=us, row_updates=updates, threads=plan.threads,
                bins_per_thread=plan.bins, ring=plan.ring, table=plan.table, amp_rows=plan.amp,
                live_taps=G, period=wt.period, smem_bytes=plan.bytes, kernel=list(args),
                registers=regs.get("registers"), spill_stores=regs.get("spill_stores"),
                spill_loads=regs.get("spill_loads"))


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
    q32 = lws_torch.LWS(256, 8, L=3, device=dev)  # Q=32: tests/test_oracle.py's geometry
    in4, in2, in_wide = random_phase(q4), random_phase(q2), random_phase(wide)
    # the first 0.5 s (1000 frames at hop 8), which keeps the plain version short
    in32 = tuple(t[:, :Q32_FRAMES].contiguous() for t in random_phase(q32))
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
        ("h LWS(1024, 256) F=513 batch Q=4 ip3 jacobi (weights partly read from "
         "device memory), 3 live sweeps", in_wide,
         (wide._st_batch, wide.batch_inner_passes, wide.inner_scheme), dense, {}),
        ("l LWS(256, 8, L=3) F=129 batch Q=32 (the run-time path), 3 live sweeps", in32,
         (q32._st_batch, q32.batch_inner_passes, q32.inner_scheme), dense, {}),
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


def free_function_case(s, torch, lws_torch, sweeps_mod):
    """Phase 3, the free function batch_lws on a complex128 spectrogram (numpy's
    default) on the card: backend="auto" runs the float32 kernel and returns
    complex64, backend="torch" the plain version in float64 (complex128);
    their consistency agrees within TOL_PLAIN_DB. One jacobi pass per frame,
    as the free functions run; FREE_SWEEPS sweeps on 2 x FREE_SECONDS s."""
    rng = np.random.default_rng(8)
    x = make_batch(2, int(FREE_SECONDS * SAMPLE_RATE), SAMPLE_RATE, rng)
    proc = lws_torch.LWS(512, 128, device=DEVICE)
    S = np.abs(proc.stft(x)).astype(np.complex128)
    thr = lws_torch.get_thresholds(FREE_SWEEPS, 100, 0.1, 1)
    before = sweeps_mod.LAUNCHES
    out = lws_torch.batch_lws(S, proc.W, thr)
    launched = sweeps_mod.LAUNCHES - before
    ref = lws_torch.batch_lws(S, proc.W, thr, backend="torch")
    c_out, c_ref = proc.get_consistency(out), proc.get_consistency(ref)
    d = float(np.abs(c_out - c_ref).max())
    s.check(out.dtype == np.complex64 and ref.dtype == np.complex128
            and out.shape == S.shape and bool(np.isfinite(out).all()) and launched == 1,
            f"free batch_lws on complex128 {S.shape}: backend='auto' -> {out.dtype} through "
            f"{launched} kernel launch, backend='torch' -> {ref.dtype}, finite")
    s.check(d <= TOL_PLAIN_DB,
            f"free batch_lws complex128, {FREE_SWEEPS} sweeps: consistency {float(c_out.mean()):.4f} "
            f"dB (float32 kernel) vs {float(c_ref.mean()):.4f} dB (float64 plain): max "
            f"{d:.4f} dB (tol {TOL_PLAIN_DB})")


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


# Geometries the online kernels take since their weight-table design
# (phase 3, cases m-q): (case, LWS arguments, seconds of mixture, rounds). Whole
# spectrograms (consistency needs their frame count): 164, 331, 203 and
# 43 frames.
# m: LWS(4096, 512, mode="music") (Q = 8, F = 2049: run-time kernel, table
# in shared memory beside the ring); n: a StreamingLWS of it (K4 with its
# amp rows in device memory); o: Q = 32 (table in device memory); p:
# look_ahead = 10; q: F = 8193 (ring in device memory).
NEW_ONLINE = (
    ("m", dict(awin_or_fsize=4096, fshift=512, mode="music"), 5.0, 10),
    ("o", dict(awin_or_fsize=256, fshift=8, L=3), 0.15, 2),
    ("p", dict(awin_or_fsize=512, fshift=128, look_ahead=10), 1.6, 3),
    ("q", dict(awin_or_fsize=16384, fshift=4096), 10.0, 2),
)


def new_online_cases(s, torch, lws_torch, online_mod):
    """Phase 3, cases m-q: K3 and K4 (chunked, running mean) against their
    plain versions on the card at the geometries of NEW_ONLINE, float32,
    2 mixtures from seeded random phases: the first frames bin by bin
    (TOL_CASE), every utterance by consistency (TOL_ONLINE_DB), magnitudes;
    then case n, a StreamingLWS of case m's processor against the plain
    stream. Returns the largest max |delta| of K3's and of K4's first
    frames."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(10)
    worst = {False: 0.0, True: 0.0}
    early = slice(0, ONLINE_EARLY_FRAMES)
    for tag, kw, secs, iters in NEW_ONLINE:
        proc = lws_torch.LWS(**kw, device=dev)
        x = make_batch(2, int(secs * SAMPLE_RATE), SAMPLE_RATE, rng)
        sr, si, amp = random_phases(torch, rng, *proc.stft_ri(x))
        thr = torch.as_tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1), dtype=torch.float32,
                              device=dev)
        wt = online_mod.online_weights(proc._st_la, proc._st_nofuture, proc._st_af)
        F = int(sr.shape[-1])
        plan = online_mod.online_plan(F, proc._Qi, proc.L, proc.look_ahead, True,
                                      int(wt.dks.numel()), wt.period)
        B, T = sr.shape[:2]
        means = torch.cumsum(amp.mean(dim=-1), dim=1) / torch.arange(
            1, T + 1, dtype=torch.float32, device=dev)
        before = (online_mod.LAUNCHES, online_mod.CHUNK_LAUNCHES)
        k3 = online_mod.packed_rtisi_la(sr, si, proc._st_la, proc._st_nofuture, proc._st_af,
                                        thr, proc.inner_passes, proc.inner_scheme)
        k4 = chunked(torch, online_mod, proc, sr, si, means, thr)
        launched = (online_mod.LAUNCHES - before[0], online_mod.CHUNK_LAUNCHES - before[1])
        p3 = online_mod.packed_rtisi_la(sr, si, proc._st_la, proc._st_nofuture, proc._st_af,
                                        thr, proc.inner_passes, proc.inner_scheme,
                                        backend="torch")
        p4 = chunked(torch, online_mod, proc, sr, si, means, thr, backend="torch")
        s.sync()
        head = (f"case {tag} LWS({kw['awin_or_fsize']}, {kw['fshift']}) Q={proc._Qi} "
                f"LA={proc.look_ahead} {iters} rounds {tuple(sr.shape)} (P = {wt.period}, "
                f"{int(wt.dks.numel())} live taps; K4 plan: ring in shared memory "
                f"{plan.ring}, table {plan.table}, amp rows {plan.amp})")
        s.check(launched == (1, 4), f"{head}: K3 launches {launched[0]} (1), K4 {launched[1]} "
                f"(4: chunks 17, 1, rest and the drain)")
        for chunk, (kr, ki), (pr, pi) in ((False, k3, p3), (True, k4, p4)):
            d = max(float((kr[:, early] - pr[:, early]).abs().max()),
                    float((ki[:, early] - pi[:, early]).abs().max()))
            worst[chunk] = max(worst[chunk], d)
            rel = d / float(amp.max())
            dc = float((proc.get_consistency((kr, ki))
                        - proc.get_consistency((pr, pi))).abs().max())
            mag = float(((torch.sqrt(kr * kr + ki * ki) - amp).abs()
                         / amp.clamp_min(1e-30)).max())
            s.check(np.isfinite(d) and rel <= TOL_CASE and dc <= TOL_ONLINE_DB
                    and mag <= TOL_MAGNITUDE,
                    f"{head} {'K4 chunked' if chunk else 'K3'} vs plain: first "
                    f"{ONLINE_EARLY_FRAMES} frames max|d|/max amp {rel:.3e} (tol {TOL_CASE:g}), "
                    f"per-utterance consistency max {dc:.4f} dB (tol {TOL_ONLINE_DB}), "
                    f"magnitudes {mag:.2e} (tol {TOL_MAGNITUDE:g})")
        if tag == "m":
            stream_case(s, torch, lws_torch, online_mod, proc, x)
    return worst


def stream_case(s, torch, lws_torch, online_mod, proc, x):
    """Case n: StreamingLWS of `proc` (LWS(4096, 512, mode="music")) on two
    streams of x pushed in 0.5 s chunks, block_frames 16, against the plain
    stream (backend="torch"): consistency of the committed frames per
    stream, the audio's shape."""
    B = x.shape[0]
    results = {}
    for backend in ("auto", "torch"):
        st = lws_torch.StreamingLWS(proc, streams=B, block_frames=16, keep_frames=True,
                                    backend=backend)
        before = online_mod.CHUNK_LAUNCHES
        outs = [st.push_block(x[:, i:i + 8000]) for i in range(0, x.shape[-1], 8000)]
        outs.append(st.flush())
        launched = online_mod.CHUNK_LAUNCHES - before
        com = torch.as_tensor(np.stack(st.committed_frames, axis=1), device=proc.device)
        c = proc.get_consistency((com.real.contiguous(), com.imag.contiguous()))
        results[backend] = (np.concatenate(outs, axis=-1), c, launched, st._frames_seen,
                            tuple(com.shape))
    (y, c, launched, seen, shape), (yp, cp, *_) = results["auto"], results["torch"]
    dc = float((c - cp).abs().max())
    s.check(launched >= 1 and launched == seen // 16,
            f"case n StreamingLWS(LWS(4096, 512, mode='music')), {B} streams, block_frames 16: "
            f"{launched} K4 launches for {seen} frames, committed {shape}")
    s.check(dc <= TOL_ONLINE_DB and y.shape == yp.shape and bool(np.isfinite(y).all()),
            f"case n K4 stream vs plain stream: consistency {float(c.mean()):.4f} vs "
            f"{float(cp.mean()):.4f} dB, per-stream max {dc:.4f} dB (tol {TOL_ONLINE_DB}); "
            f"audio {y.shape}")


def random_phases(torch, rng, sr, si):
    """|S| of (sr, si) with seeded random phases, and |S| itself."""
    amp = torch.sqrt(sr * sr + si * si)
    ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, tuple(amp.shape)), dtype=torch.float32,
                         device=amp.device)
    return (amp * torch.cos(ph)).contiguous(), (amp * torch.sin(ph)).contiguous(), amp


def packed_cases(s, torch, lws_torch, sweeps_mod, packed_mod, seg_mod):
    """Phase 3, the grouped sweep kernel (K5) on the card, float32, from
    seeded random phases, against the plain group update. Case k: (4, 628,
    257), LWS(512, 128)'s batch stencil (3 in-frame jacobi passes), 12
    sweeps at alpha=1, each micro, micro = 1 (K1 behind K5's wrapper)
    against K1 bit for bit; lws_tpu's other entry points at micro 2 on K5
    (tiled_lws_sweeps, one launch, equal to packed_lws_sweeps; the
    segmented sweeps, one launch per exchange block); then the geometries
    K5's plan newly takes (K5_GEOMETRIES). Returns the largest max |delta|."""
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

    def held(label, k, p, a, launched=None, expected=None):
        nonlocal worst
        s.sync()
        d = float(torch.maximum((k[0] - p[0]).abs(), (k[1] - p[1]).abs()).max())
        rel = d / float(a.max())
        worst = max(worst, d)
        counted = "" if expected is None else f", {launched} K5 launches (expected {expected})"
        s.check(np.isfinite(d) and rel <= TOL_CASE and launched == expected,
                f"case k {label}: max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g}){counted}")

    base = f"{tuple(sr.shape)}, 12 sweeps alpha=1, {ip} jacobi passes"
    grouped = {}
    for micro in (1, 2, 4):
        before = packed_mod.LAUNCHES
        kr, ki = packed_mod.packed_lws_sweeps(sr, si, *sched, micro, ip, scheme)
        launched = packed_mod.LAUNCHES - before
        pr, pi = packed_mod.packed_lws_sweeps(sr, si, *sched, micro, ip, scheme,
                                              backend="torch")
        held(f"K5 micro={micro} vs its plain version, {base}", (kr, ki), (pr, pi), amp,
             launched, int(micro > 1))
        grouped[micro] = (kr, ki)
        if micro == 1:
            s.check(torch.equal(kr, k1[0]) and torch.equal(ki, k1[1]),
                    "case k K5 micro=1 vs K1 on the same inputs: bit-equal")
    before = packed_mod.LAUNCHES
    tk = sweeps_mod.tiled_lws_sweeps(sr, si, *sched, ip, scheme, micro=2)
    launched = packed_mod.LAUNCHES - before
    tp = sweeps_mod.tiled_lws_sweeps(sr, si, *sched, ip, scheme, backend="torch", micro=2)
    held(f"tiled_lws_sweeps(micro=2) vs its plain version, {base}", tk, tp, amp, launched, 1)
    s.check(torch.equal(tk[0], grouped[2][0]) and torch.equal(tk[1], grouped[2][1]),
            "case k tiled_lws_sweeps(micro=2) vs packed_lws_sweeps(micro=2): bit-equal")
    kw = dict(segments=4, sweeps_per_exchange=3, micro=2, inner_passes=ip, inner_scheme=scheme)
    before = packed_mod.LAUNCHES
    gk = seg_mod.segmented_lws_sweeps(sr, si, *sched, **kw)
    launched = packed_mod.LAUNCHES - before
    gp = seg_mod.segmented_lws_sweeps(sr, si, *sched, backend="torch", **kw)
    held(f"segmented_lws_sweeps(segments=4, every 3 sweeps, micro=2) vs its plain version, "
         f"{base}", gk, gp, amp, launched, 4)

    for label, (fsize, fshift), micro, secs, sweeps in K5_GEOMETRIES:
        p = lws_torch.LWS(fsize, fshift, device=dev)
        xg = make_batch(2, int(secs * SAMPLE_RATE), SAMPLE_RATE, rng)
        r0, i0, a0 = random_phases(torch, rng, *p.stft_ri(xg))
        th = torch.as_tensor(lws_torch.get_thresholds(sweeps, 1, 0.1, 1), dtype=torch.float32,
                             device=dev)
        st = p._st_batch
        wt = packed_mod.packed_weights(st)
        T, F = r0.shape[-2:]
        plan = packed_mod.packed_plan(F, st.Q, st.L, micro, int(wt.dks.numel()), wt.period)
        before = packed_mod.LAUNCHES
        k = packed_mod.packed_lws_sweeps(r0, i0, st, th, micro, p.batch_inner_passes,
                                         p.inner_scheme)
        launched = packed_mod.LAUNCHES - before
        pl = packed_mod.packed_lws_sweeps(r0, i0, st, th, micro, p.batch_inner_passes,
                                          p.inner_scheme, backend="torch")
        held(f"K5 {label}: LWS({fsize}, {fshift}), Q={st.Q}, {tuple(r0.shape)}, {sweeps} "
             f"sweeps alpha=1 (plan {plan.threads} threads x {plan.bins} elements, ring / "
             f"table / centre / sums in shared memory {plan.ring:d}{plan.table:d}"
             f"{plan.centre:d}{plan.sums:d}, scratch {plan.scratch} pairs per CTA)",
             k, pl, a0, launched, 1)
    return worst


def k5_report(label, packed_mod, ptxas, st, F, micro, ms, steps):
    """Print a K5 run's microseconds per step (`steps` serial steps per CTA:
    ceil(T / micro) groups x (1 + passes) per live sweep), its launch plan
    and its kernel's registers and spills; return them for the kernels
    line."""
    wt = packed_mod.packed_weights(st)
    G = int(wt.dks.numel())
    plan = packed_mod.packed_plan(F, st.Q, st.L, micro, G, wt.period)
    args = (4, 5, plan.bins, int(plan.shared)) if plan.fixed else (0, 0, 0, 0)
    key = "lws_packed_kernelI" + "".join(
        f"L{'i' if i < 3 else 'b'}{v}E" for i, v in enumerate(args)) + "E"
    found = [v for k, v in ptxas.items() if key in k]
    regs = found[0] if found else {}
    us = 1e3 * ms / steps
    print(f"  K5 {label}: {ms:.2f} ms, {steps} steps per CTA -> {us:.3f} us per step; plan: "
          f"{plan.threads} threads x {plan.bins} elements (stride {plan.stride}, sharing a "
          f"bin {plan.shared}), {plan.slots} ring slots, ring / "
          f"table ({G} live taps x P = {wt.period}) / centre buffers / sums in shared memory "
          f"{plan.ring} / {plan.table} / {plan.centre} / {plan.sums}, {plan.bytes} B, scratch "
          f"{plan.scratch} pairs; kernel lws_packed_kernel<{', '.join(map(str, args))}>: "
          f"{regs.get('registers')} registers, spill stores {regs.get('spill_stores')} B, "
          f"loads {regs.get('spill_loads')} B", flush=True)
    return dict(us_per_step=us, steps_per_cta=steps, threads=plan.threads,
                elements_per_thread=plan.bins, stride=plan.stride, shared_bin=plan.shared,
                slots=plan.slots, ring=plan.ring,
                table=plan.table, centre=plan.centre, sums=plan.sums, live_taps=G,
                period=wt.period, smem_bytes=plan.bytes, scratch=plan.scratch,
                kernel=list(args), registers=regs.get("registers"),
                spill_stores=regs.get("spill_stores"), spill_loads=regs.get("spill_loads"))


def packed_timing(s, torch, lws_torch, sweeps_mod, packed_mod, ptxas):
    """K5 through its entry point (lws_torch.ops.packed_lws_sweeps) on the
    batch path's input, (32, 628, 257) x 100 sweeps at alpha=100 from zero
    phase, at micro 4 (micro 1 is K1, timed on the batch path): launches,
    time, bound, consistency, the plain group update's time. Then its time
    at micro 2 and 4 on the music path's batch-stage input (32, 316, 513):
    the online stage's output of bench.py's pipeline workload (magnitudes,
    consistency). Returns the kernels-line entry."""
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
    plan = k5_report("batch path input, micro 4", packed_mod, ptxas, st, int(F), micro, ms,
                     serial)

    # the music path's batch stage input: its no-future and online stages'
    # output (the K1 and K3 launches here are no part of a counted run)
    mproc = lws_torch.LWS(1024, 256, mode="music", device=dev)
    mx = make_batch(MUSIC_B, int(MUSIC_SECONDS * SAMPLE_RATE), SAMPLE_RATE,
                    np.random.default_rng(MUSIC_SEED))
    mr, mi = mproc.stft_ri(mx)
    mamp = torch.sqrt(mr * mr + mi * mi)
    stage_in = mproc.online_lws(mproc.nofuture_lws((mamp, torch.zeros_like(mamp))))
    mthr = torch.as_tensor(lws_torch.get_thresholds(mproc.batch_iterations, 100, 0.1, 1),
                           dtype=torch.float32, device=dev)
    mst, mip = mproc._st_batch, mproc.batch_inner_passes
    mT, mF = mamp.shape[-2:]
    mlive = sweeps_mod.sweep_schedule(*stage_in, mthr)[2]
    m_bound, m_by, m_flops, _, _ = sweep_bound(mst, mip, mlive, mT, mF, MUSIC_B)
    music = {}
    for m in (2, 4):
        mout = packed_mod.packed_lws_sweeps(*stage_in, mst, mthr, m, mip, mproc.inner_scheme)
        cm = mproc.get_consistency(mout)
        m_rel = float(((torch.sqrt(mout[0] ** 2 + mout[1] ** 2) - mamp).abs()
                       / mamp.clamp_min(1e-30)).max())
        s.check(m_rel <= TOL_MAGNITUDE and bool(torch.isfinite(cm).all()),
                f"K5 micro={m} on the music batch stage input {tuple(mamp.shape)}: "
                f"magnitudes {m_rel:.2e} (tol {TOL_MAGNITUDE:g}), consistency mean "
                f"{float(cm.mean()):.3f} dB")
        m_ms = cuda_ms(torch, lambda: packed_mod.packed_lws_sweeps(
            *stage_in, mst, mthr, m, mip, mproc.inner_scheme), 3)
        steps = int(mlive.sum(dim=1).max()) * (-(-mT // m)) * (1 + mip)
        print(f"K5 on the music batch stage input {tuple(mamp.shape)} x "
              f"{mproc.batch_iterations} sweeps, micro={m}: {m_ms:.2f} ms; bound "
              f"{m_bound:.4f} ms by {m_by} ({m_flops:.4g} flop); consistency "
              f"{float(cm.mean()):.3f} dB")
        music[f"micro{m}"] = dict(ms=m_ms, bound_ms=m_bound, bound_by=m_by,
                                  consistency_db=float(cm.mean()),
                                  plan=k5_report(f"music batch stage, micro {m}", packed_mod,
                                                 ptxas, mst, int(mF), m, m_ms, steps))
    return dict(name="lws_packed", route="cuda", source="lws_torch/csrc/lws_sweeps.cu",
                replaces="lws_tpu/ops/pallas_packed.py:683", launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                micro=micro, shape=[B, int(T), int(F)], sweeps=iters, serial_steps=serial,
                consistency_db=float(c.mean()), plan=plan,
                music_stage=dict(shape=[MUSIC_B, int(mT), int(mF)], **music))


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
    once, the weight table read once. For K4 over a stream (launches given):
    `frames` frames through the kernel (drains included; they update
    nothing), each launch reading the weight table and the state once and
    writing the state once, and a threshold per frame and round."""
    wt = online_mod.online_weights(proc._st_la, proc._st_nofuture, proc._st_af)
    counts = wt.counts
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
    weights = wt.table.numel()  # (re, im) of each live tap, P columns
    if launches is None:
        nbytes = 4.0 * (5 * B * T * F + weights + B * iters)
    else:
        state = 2 * B * (2 * (LA + proc._Qi) + LA + 1) * F  # read and written
        nbytes = 4.0 * (5 * B * frames * F + B * frames * iters
                        + launches * (weights + state))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes, sum(updates.values()))


def music_path(s, torch, lws_torch, sweeps_mod, online_mod, ptxas):
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
    k3_plan = online_report("music online stage", online_mod, ptxas, proc, int(F), False, ms,
                            updates)

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
    b_plan = k1_report("music batch stage", sweeps_mod, ptxas, st, int(F), b_ms,
                       int(live.sum(dim=1).max()) * int(T), ip)

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
        look_ahead=proc.look_ahead, row_updates=updates, plan=k3_plan)
    music_sweeps = dict(launches=launches["lws_sweeps"], batch_stage_ms=b_ms,
                        batch_stage_bound_ms=b_bound, batch_stage_plan=b_plan,
                        shape=[B, int(T), int(F)],
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


def stream_path(s, torch, lws_torch, online_mod, ptxas):
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
    k4_plan = online_report("streaming run", online_mod, ptxas, proc, int(com.shape[-1]), True,
                            ms, updates)
    return dict(name="lws_online_chunk", route="cuda", source="lws_torch/csrc/lws_online.cu",
                replaces="lws_tpu/ops/pallas_packed.py:1180", launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=[B, launches * STREAM_BLOCK, int(com.shape[-1])], live_frames=T_live,
                rounds=10, look_ahead=LA, row_updates=updates, stream_wall_ms=1e3 * wall,
                audio_s_per_s=B * secs / wall, consistency_db=float(c.mean()), latency=lat,
                plan=k4_plan)


def main_path(s, torch, lws_torch, sweeps_mod, ptxas):
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
    plan = k1_report("batch path", sweeps_mod, ptxas, st, int(F), ms,
                     int(live.sum(dim=1).max()) * int(T), ip)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=[B, int(T), int(F)], sweeps=iters,
                live_sweeps=int(live.sum()), serial_steps=serial, plan=plan)


def longform_path(s, torch, lws_torch, sweeps_mod, seg_mod, ptxas):
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
    plan = k1_report("longform path", sweeps_mod, ptxas, st, int(F), k1_ms,
                     int(live.sum(dim=1).max()) * Tseg, ip)
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
    a_plan = k1_report("case (a), F=2049, 4 segments (K2's wall, exchanges included)",
                       sweeps_mod, ptxas, st, int(F), a_ms,
                       int(a_live.sum(dim=1).max()) * -(-int(r0.shape[-2]) // 4), ip)

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
                plan=plan,
                case_a=dict(shape=[1, int(r0.shape[-2]), int(F)], segments=4, sweeps=12,
                            launches=a_launches, ms=a_ms, plain_ms=a_plain_ms,
                            bound_ms=a_bound, max_abs_err=d, plan=a_plan),
                seams_db=res["plan"][0], one_segment_db=res["one segment"][0],
                seams_ms=1e3 * res["plan"][1], one_segment_ms=1e3 * res["one segment"][1],
                floor_db=c_floor)


def timed_wall(s, fn, reps):
    """Median host-clock wall of fn() over reps runs, each ended by a
    synchronise; returns (median seconds, last output)."""
    walls, out = [], None
    for _ in range(reps):
        s.sync()
        t0 = time.perf_counter()
        out = fn()
        s.sync()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), out


def fast_mode(s, torch, lws_torch, sweeps_mod):
    """Phase 8: fast mode. LWS(512, 128, order="jacobi_mxu") on the batch
    path's input (bench.py's fastmode row), then order="jacobi" on the same
    input, and the pure tone at precision "high" against None. The Jacobi
    orders run no kernel (plain whole-grid sweeps, the banded matmuls in
    torch.matmul): the run counts no K1 launch. Returns the numbers."""
    dev = torch.device(DEVICE)
    B, secs, sr_hz, iters = MAIN_B, MAIN_SECONDS, SAMPLE_RATE, MAIN_SWEEPS
    x = make_batch(B, int(secs * sr_hz), sr_hz, np.random.default_rng(0))
    mxu = lws_torch.LWS(512, 128, order="jacobi_mxu", device=dev)
    jac = lws_torch.LWS(512, 128, order="jacobi", device=dev)
    prec0 = torch.get_float32_matmul_precision()

    # one run of the fast-mode path, through the user entry points, counted
    sweeps_mod.LAUNCHES = 0
    sr, si = mxu.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    c_in = mxu.get_consistency(pair)
    out = mxu.batch_lws(pair)
    c_m = mxu.get_consistency(out)
    y = mxu.istft(out)
    s.sync()
    launched = sweeps_mod.LAUNCHES
    print(f"fast mode: LWS(512, 128, order='jacobi_mxu') on {B} x {secs:g} s, spectrogram "
          f"{tuple(amp.shape)}, {iters} sweeps, precision None (full float32)")
    s.check(launched == 0, f"fast-mode run launched no sweep kernel (plain Jacobi sweeps, "
            f"banded matmuls in torch.matmul): {launched} K1 launches")
    mag_rel = float(((torch.sqrt(out[0] ** 2 + out[1] ** 2) - amp).abs()
                     / amp.clamp_min(1e-30)).max())
    finite = bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()
                  and torch.isfinite(y).all())
    s.check(finite and mag_rel <= TOL_MAGNITUDE and tuple(y.shape) == (B, x.shape[-1]),
            f"finite outputs, istft shape {tuple(y.shape)}, magnitudes preserved: max per-bin "
            f"relative error {mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    wall_m, _ = timed_wall(s, lambda: mxu.batch_lws(pair), 3)
    wall_j, out_j = timed_wall(s, lambda: jac.batch_lws(pair), 3)
    c_j = jac.get_consistency(out_j)
    dc = float((c_m - c_j).abs().max())
    print(f"  consistency: input {float(c_in.mean()):.3f} dB -> jacobi_mxu "
          f"{float(c_m.mean()):.4f} dB, jacobi {float(c_j.mean()):.4f} dB; batch_lws wall "
          f"(median of 3): jacobi_mxu {1e3 * wall_m:.2f} ms -> {B * secs / wall_m:.1f} "
          f"audio-s/s, jacobi {1e3 * wall_j:.2f} ms -> {B * secs / wall_j:.1f} audio-s/s")
    s.check(dc <= TOL_JACOBI_DB, f"jacobi_mxu vs jacobi consistency at precision None, "
            f"{iters} sweeps: max {dc:.4f} dB over {B} utterances (tol {TOL_JACOBI_DB})")
    # the banded products' work: 4 real (B T, F + 2L) @ (F + 2L, F) products
    # per row with a live tap, in each sweep some utterance passes
    st = mxu._st_batch
    thr = torch.as_tensor(lws_torch.get_thresholds(iters, 100, 0.1, 1), dtype=torch.float32,
                          device=dev)
    live = int(sweeps_mod.sweep_schedule(*pair, thr)[2].amax(dim=0).sum())
    rows = int(st.nz.any(axis=1).sum())
    T, F = amp.shape[-2:]
    mm_flops = 2.0 * live * rows * 4 * B * T * (F + 2 * st.L) * F
    print(f"  banded products: {live} live sweeps x {rows} rows x 4, {mm_flops:.4g} flop -> "
          f"{1e3 * mm_flops / PEAK_F32_FLOPS:.2f} ms at the float32 peak "
          f"({100 * mm_flops / PEAK_F32_FLOPS / wall_m:.1f}% of the jacobi_mxu wall)")

    # both orders from the same random phases, 5 sweeps at alpha=1
    r0, i0, _ = random_phases(torch, np.random.default_rng(12), sr, si)
    thr5 = torch.as_tensor(lws_torch.get_thresholds(5, 1, 0.1, 1), dtype=torch.float32,
                           device=dev)
    from lws_torch.core.batch import lws_sweeps
    a = lws_sweeps(r0, i0, mxu._st_batch, thr5, order="jacobi_mxu")
    b = lws_sweeps(r0, i0, jac._st_batch, thr5, order="jacobi")
    rel = float(torch.maximum((a[0] - b[0]).abs(), (a[1] - b[1]).abs()).max() / amp.max())
    s.check(rel <= TOL_JACOBI_AMP, f"jacobi_mxu vs jacobi after 5 sweeps from random phases, "
            f"{tuple(r0.shape)}: max|d|/max amp = {rel:.3e} (tol {TOL_JACOBI_AMP:g})")

    # the pure tone: TF32 ("high") against full float32 and the elementwise order
    n = int(PURE_SECONDS * sr_hz)
    tone = (0.5 * np.sin(2 * np.pi * PURE_HZ * np.arange(n) / sr_hz))[None].astype(np.float32)
    tr, ti = mxu.stft_ri(tone)
    tamp = torch.sqrt(tr * tr + ti * ti)
    tpair = (tamp, torch.zeros_like(tamp))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # precision="high" warns by design
        tf32 = lws_torch.LWS(512, 128, order="jacobi_mxu", precision="high", device=dev)
    mxu64, jac64 = (lws_torch.LWS(512, 128, order=o, dtype=torch.float64, device=dev)
                    for o in ("jacobi_mxu", "jacobi"))
    tone_db = {}
    for label, p in (("jacobi_mxu None", mxu), ("jacobi_mxu high (TF32)", tf32),
                     ("jacobi", jac), ("float64 jacobi_mxu", mxu64), ("float64 jacobi", jac64)):
        tp = tuple(t.to(p.rdtype) for t in tpair)
        wall, o = timed_wall(s, lambda: p.batch_lws(tp), 1)
        tone_db[label] = (float(p.get_consistency(o)[0]), 1e3 * wall)
    print("  pure tone (" + f"{PURE_SECONDS:g} s at {PURE_HZ:g} Hz, {tuple(tamp.shape)}, "
          f"{iters} sweeps): " + ", ".join(f"{k} {v[0]:.4f} dB ({v[1]:.1f} ms)"
                                           for k, v in tone_db.items()))
    d64 = abs(tone_db["float64 jacobi_mxu"][0] - tone_db["float64 jacobi"][0])
    s.check(d64 <= TOL_JACOBI_F64_DB, f"pure tone in float64: jacobi_mxu within "
            f"{TOL_JACOBI_F64_DB:g} dB of jacobi: {d64:.3e} dB")
    s.check(torch.get_float32_matmul_precision() == prec0,
            f"the caller's float32 matmul precision is restored: "
            f"{torch.get_float32_matmul_precision()!r} (was {prec0!r})")
    return dict(shape=[B, int(amp.shape[-2]), int(amp.shape[-1])], sweeps=iters,
                k1_launches=launched, jacobi_mxu_ms=1e3 * wall_m, jacobi_ms=1e3 * wall_j,
                jacobi_mxu_audio_s_per_s=B * secs / wall_m,
                jacobi_audio_s_per_s=B * secs / wall_j,
                jacobi_mxu_db=float(c_m.mean()), jacobi_db=float(c_j.mean()),
                banded_flops=mm_flops,
                random_phase_rel=rel, pure_tone={k: v[0] for k, v in tone_db.items()})


def vocoder_path(s, torch, lws_torch, sweeps_mod, ptxas):
    """Phase 9: the vocoder at full width (bench.py's vocoder row): mel
    (VOC_B, 223, 80) -> mel_vocoder_pipeline (mel_to_linear, run_lws: 100
    batch sweeps on K1 at Q = 8, F = 1025). Returns K1's numbers there."""
    from lws_torch.mel import linear_to_mel, mel_filterbank
    dev = torch.device(DEVICE)
    uniq = make_batch(VOC_UNIQUE, int(VOC_SECONDS * VOC_RATE), VOC_RATE,
                      np.random.default_rng(VOC_SEED))
    proc = lws_torch.LWS(VOC_FSIZE, VOC_FSHIFT, device=dev)
    sr, si = proc.stft_ri(uniq)
    fb = mel_filterbank(VOC_MELS, VOC_FSIZE, VOC_RATE)
    mel = linear_to_mel(torch.sqrt(sr * sr + si * si), fb)
    mel = mel.repeat(VOC_B // VOC_UNIQUE, 1, 1).contiguous()  # bench.py's jnp.tile
    B, T = mel.shape[:2]
    secs = B * VOC_SECONDS

    # one run of the vocoder path, through the user entry point, counted;
    # CUDA events around K1's wrapper where the processor calls it
    sweeps_mod.LAUNCHES = sweeps_mod.TABLE_LAUNCHES = 0
    with KernelTimer(torch, sys.modules["lws_torch.processor"], "tiled_lws_sweeps") as kt:
        s.sync()
        t0 = time.perf_counter()
        out = lws_torch.mel_vocoder_pipeline(mel, proc, fb=fb, return_spec=True)
        s.sync()
        wall = time.perf_counter() - t0
    launched, tables = sweeps_mod.LAUNCHES, sweeps_mod.TABLE_LAUNCHES
    ms = kt.ms()
    F = int(out[0].shape[-1])
    print(f"vocoder path: LWS({VOC_FSIZE}, {VOC_FSHIFT}) (Q = {proc._Qi}, F = {F}), mel "
          f"{tuple(mel.shape)} from {VOC_UNIQUE} unique {VOC_SECONDS:g} s mixtures at "
          f"{VOC_RATE} Hz tiled to {B} (no cut of B), mel_vocoder_pipeline: mel_to_linear + "
          f"{proc.batch_iterations} batch sweeps, batch_inner_passes={proc.batch_inner_passes}")
    s.check(launched == 1 and len(kt.events) == 1,
            f"lws_sweeps kernel launches in the vocoder run: {launched}")
    s.check(tables == 1, f"of them, table kernel launches (TABLE_LAUNCHES: weights from the "
            f"period-Q table): {tables}")
    lin = lws_torch.mel_to_linear(mel, fb).to(proc.rdtype)
    mag_rel = float(((torch.sqrt(out[0] ** 2 + out[1] ** 2) - lin).abs()
                     / lin.clamp_min(1e-30)).max())
    finite = bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all())
    s.check(finite and mag_rel <= TOL_MAGNITUDE,
            f"finite outputs, magnitudes = mel_to_linear's: max per-bin relative error "
            f"{mag_rel:.2e} (tol {TOL_MAGNITUDE:g})")
    # the mel is VOC_UNIQUE utterances tiled: every copy, in every CTA and
    # every wave of the launch, must equal its source bit for bit
    def tiles_equal(t):
        v = t.view(B // VOC_UNIQUE, VOC_UNIQUE, *t.shape[1:])
        return bool(torch.equal(v, v[:1].expand_as(v)))

    lin_same = tiles_equal(lin)
    out_same = [tiles_equal(o) for o in out]
    s.check(all(out_same), f"vocoder output: all {B // VOC_UNIQUE} copies of the "
            f"{VOC_UNIQUE} utterances equal their source bit for bit (real {out_same[0]}, "
            f"imaginary {out_same[1]}; mel_to_linear's copies {lin_same})")
    zero = torch.zeros_like(lin[:VOC_UNIQUE])
    c0 = float(proc.get_consistency((lin[:VOC_UNIQUE], zero)).mean())
    c16 = float(proc.get_consistency((out[0][:VOC_UNIQUE], out[1][:VOC_UNIQUE])).mean())
    print(f"  pipeline wall {1e3 * wall:.1f} ms -> {secs / wall:.1f} audio-s/s, K1 "
          f"{ms:.2f} ms of it; consistency of the first {VOC_UNIQUE}: "
          f"{c0:.4f} dB (zero phase) -> {c16:.4f} dB")
    s.check(c16 > c0 + 5, f"consistency rises: {c0:.4f} -> {c16:.4f} dB")

    # K1's bound and plan for the stage's input
    st, ip, scheme = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme
    thr = torch.as_tensor(lws_torch.get_thresholds(proc.batch_iterations, 100, 0.1, 1),
                          dtype=torch.float32, device=dev)
    live = sweeps_mod.sweep_schedule(lin, torch.zeros_like(lin), thr)[2]
    bound_ms, bound_by, flops, nbytes, serial = sweep_bound(st, ip, live, T, F, B)
    # blocks resident per SM: the CUDA runtime's occupancy query of the
    # kernel this launch picked, at its threads and dynamic shared memory
    per_sm = sweeps_mod.kernel_occupancy(F, st.Q, st.L, st.period, int(st.nz.sum()))
    waves = -(-B // (max(1, per_sm) * proc._n_sm))
    s.check(per_sm >= 1, f"K1 at Q = {st.Q}, F = {F}: {per_sm} blocks per SM by "
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    print(f"  K1 {ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} flop, "
          f"{nbytes:.4g} B; live sweeps per utterance {int(live.sum(dim=1).min())}-"
          f"{int(live.sum(dim=1).max())}); {B} CTAs on {proc._n_sm} SMs, {per_sm} resident "
          f"per SM (CUDA runtime's occupancy query) -> {waves} waves")
    plan = k1_report("vocoder path (Q = 8, F = 1025)", sweeps_mod, ptxas, st, F, ms,
                     int(live.sum(dim=1).max()) * int(T), ip, waves=waves,
                     blocks_per_sm=per_sm)

    # K1 against its plain version on VOC_CASE_B utterances from random phases
    r0, i0, camp = random_phases(torch, np.random.default_rng(13), lin[:VOC_CASE_B],
                                 torch.zeros_like(lin[:VOC_CASE_B]))
    dense = torch.as_tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:],
                            dtype=torch.float32, device=dev)
    kr, ki = sweeps_mod.tiled_lws_sweeps(r0, i0, st, dense, ip, scheme)
    case_ms = cuda_ms(torch, lambda: sweeps_mod.tiled_lws_sweeps(r0, i0, st, dense, ip,
                                                                 scheme), 3)
    s.sync()
    t0 = time.perf_counter()
    pr, pi = sweeps_mod.tiled_lws_sweeps(r0, i0, st, dense, ip, scheme, backend="torch")
    s.sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    d = float(torch.maximum((kr - pr).abs(), (ki - pi).abs()).max())
    rel = d / float(camp.max())
    s.check(np.isfinite(d) and rel <= TOL_CASE,
            f"vocoder case: K1 vs plain at Q = 8, F = 1025, {tuple(r0.shape)}, 3 live "
            f"sweeps from random phases: max|d|/max amp = {rel:.3e} (tol {TOL_CASE:g}); "
            f"kernel {case_ms:.2f} ms, plain {plain_ms:.1f} ms")
    return dict(launches=launched, table_launches=tables, ms=ms, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=[B, int(T), F], mel_shape=list(mel.shape), sweeps=proc.batch_iterations,
                serial_steps=serial, plan=plan, wall_ms=1e3 * wall, audio_s_per_s=secs / wall,
                consistency_db=c16, consistency_in_db=c0,
                case=dict(shape=list(r0.shape), sweeps=3, ms=case_ms, plain_ms=plain_ms,
                          max_abs_err=d))


class InjectedFault(RuntimeError):
    """Raised by the resumable phase's progress callback."""


def resumable_path(s, torch, lws_torch, sweeps_mod):
    """Phase 10: resumable_lws on the batch path's input, RESUME_EVERY sweeps
    a chunk on K1: an uninterrupted chunked run, a run faulted after chunk
    RESUME_FAULT_AFTER, its resume from the checkpoint, and the single call."""
    import shutil
    from lws_torch.checkpoint import load_checkpoint
    dev = torch.device(DEVICE)
    B, secs, sr_hz = MAIN_B, MAIN_SECONDS, SAMPLE_RATE
    x = make_batch(B, int(secs * sr_hz), sr_hz, np.random.default_rng(0))
    proc = lws_torch.LWS(512, 128, device=dev)
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    ck_dir = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    os.makedirs(ck_dir, exist_ok=True)
    path = os.path.join(ck_dir, "batch.npz")
    n_chunks = -(-proc.batch_iterations // RESUME_EVERY)
    kw = dict(checkpoint_path=path, checkpoint_every=RESUME_EVERY)
    try:
        sweeps_mod.LAUNCHES = 0
        s.sync()
        t0 = time.perf_counter()
        ref = lws_torch.resumable_lws(proc, pair, **kw)
        wall_ref = time.perf_counter() - t0
        launched = sweeps_mod.LAUNCHES
        print(f"resumable: resumable_lws(LWS(512, 128)) on {tuple(amp.shape)}, "
              f"{proc.batch_iterations} sweeps in chunks of {RESUME_EVERY}; fault after chunk "
              f"{RESUME_FAULT_AFTER}")
        s.check(launched == n_chunks, f"lws_sweeps kernel launches in the uninterrupted "
                f"chunked run: {launched} (one per chunk, {n_chunks})")

        def bomb(done, total):
            if done >= RESUME_FAULT_AFTER * RESUME_EVERY:
                raise InjectedFault(f"injected after {done} of {total} sweeps")

        faulted = False
        try:
            lws_torch.resumable_lws(proc, pair, progress=bomb, **kw)
        except InjectedFault:
            faulted = True
        state = load_checkpoint(path)
        at = None if state is None else state[2]
        s.check(faulted and at == RESUME_FAULT_AFTER * RESUME_EVERY,
                f"the injected fault stopped the run with a checkpoint at sweep {at}")
        sweeps_mod.LAUNCHES = 0
        s.sync()
        t0 = time.perf_counter()
        out = lws_torch.resumable_lws(proc, pair, **kw)
        wall_res = time.perf_counter() - t0
        resumed = sweeps_mod.LAUNCHES
        same = all(np.array_equal(a, b) for a, b in zip(out, ref))
        s.check(same and resumed == n_chunks - RESUME_FAULT_AFTER and not os.path.exists(path),
                f"the resumed run ({resumed} launches) equals the uninterrupted chunked run "
                f"bit for bit: {same}; checkpoint removed: {not os.path.exists(path)}")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    wall_one, one = timed_wall(s, lambda: proc.batch_lws(pair), 1)
    c_one = proc.get_consistency(one)
    c_res = proc.get_consistency(tuple(torch.as_tensor(a, device=dev) for a in out))
    # each chunk is a fresh stage call, which freezes its time halos (edge
    # frame replicas) from its own input: from the second chunk on they
    # carry recovered phases, where the single call keeps the zero-phase
    # input's (lws_tpu's resumable_lws does the same). The path's number is
    # the mean over the batch. The witness: the same chunks on K1 given the
    # input's halos and mean magnitude, against the single call
    st, ip, scheme, Q1 = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme, proc._Qi - 1
    zero = torch.zeros_like(amp)
    halo = (amp[:, :1].repeat(1, Q1, 1), zero[:, :1].repeat(1, Q1, 1),
            amp[:, -1:].repeat(1, Q1, 1), zero[:, -1:].repeat(1, Q1, 1))
    thr = torch.as_tensor(lws_torch.get_thresholds(proc.batch_iterations, 100, 0.1, 1),
                          dtype=torch.float32, device=dev)
    w = (amp, zero)
    for k in range(0, proc.batch_iterations, RESUME_EVERY):
        w = sweeps_mod.tiled_lws_sweeps(*w, st, thr[k:k + RESUME_EVERY], ip, scheme,
                                        halo=halo, mean_amp=amp.mean(dim=(-2, -1)))
    c_halo = proc.get_consistency(w)
    dc = abs(float(c_one.mean()) - float(c_res.mean()))
    print(f"  walls: chunked {1e3 * wall_ref:.1f} ms, resumed ({n_chunks - RESUME_FAULT_AFTER} "
          f"chunks) {1e3 * wall_res:.1f} ms, single batch_lws {1e3 * wall_one:.1f} ms; "
          f"consistency chunked {float(c_res.mean()):.4f} dB, single call "
          f"{float(c_one.mean()):.4f} dB; per utterance max |d| "
          f"{float((c_one - c_res).abs().max()):.4f} dB")
    print(f"  witness: the same {n_chunks} chunks on K1 with the input's time halos and mean "
          f"magnitude: mean {float(c_halo.mean()):.4f} dB "
          f"({abs(float(c_halo.mean()) - float(c_one.mean())):.4f} dB from the single call), "
          f"per utterance max |d| {float((c_one - c_halo).abs().max()):.4f} dB")
    s.check(dc <= TOL_RESUME_DB, f"resumed vs single-call batch_lws, mean consistency over "
            f"{B} utterances: {dc:.4f} dB apart (tol {TOL_RESUME_DB})")
    return dict(launches=launched, resumed_launches=resumed, chunks=n_chunks,
                chunked_ms=1e3 * wall_ref, resumed_ms=1e3 * wall_res,
                single_ms=1e3 * wall_one, consistency_db=float(c_res.mean()),
                single_db=float(c_one.mean()),
                utterance_max_db=float((c_one - c_res).abs().max()),
                input_halo_db=float(c_halo.mean()),
                input_halo_utterance_max_db=float((c_one - c_halo).abs().max()))


def gradient_path(s, torch, lws_torch, sweeps_mod):
    """Phase 11: autograd through the plain sweeps on the card. GRAD_B
    utterances with exact silence at both ends, GRAD_SWEEPS sweeps, a
    waveform L2 loss back to the magnitudes, for each order, backend="torch",
    in float32 and, as the witness, in float64 on the same input; then the
    same call under backend="auto", which must refuse.

    The witness holds float32 to float64 per utterance where the forward is
    well conditioned: the two precisions' recovered spectrograms agree to
    GRAD_FWD_COND x max amp. An utterance whose forward does not (a tap sum
    near zero that the frame-after-frame gs chain amplifies: lws_tpu's own
    jax.grad blows up on it too, port_tools/gs_grad_witness.py) is printed with
    both gradients' maxima and not held."""
    dev = torch.device(DEVICE)
    sr_hz = SAMPLE_RATE
    x = make_batch(GRAD_B, int(MAIN_SECONDS * sr_hz), sr_hz, np.random.default_rng(0))
    quiet = int(GRAD_SILENCE * sr_hz)
    x[:, :quiet] = 0
    x[:, -quiet:] = 0
    thr = lws_torch.get_thresholds(GRAD_SWEEPS, 1, 0.1, 1)
    res = {}
    print(f"gradients: LWS(512, 128, backend='torch') float32 (and float64, the witness) on "
          f"{GRAD_B} x {MAIN_SECONDS:g} s with {GRAD_SILENCE:g} s of silence at each end, "
          f"{GRAD_SWEEPS} sweeps at alpha=1, loss mean((istft - x)^2)")

    def run(order, dtype):
        proc = lws_torch.LWS(512, 128, order=order, backend="torch", dtype=dtype, device=dev)
        sr, si = proc.stft_ri(x.astype(np.float64) if dtype == torch.float64 else x)
        amp0 = torch.sqrt(sr * sr + si * si)
        amp = amp0.detach().requires_grad_()
        sweeps_mod.LAUNCHES = 0
        s.sync()
        t0 = time.perf_counter()
        out = proc.batch_lws((amp, torch.zeros_like(amp)), thresholds=thr)
        y = proc.istft(out)
        target = torch.as_tensor(x, device=dev, dtype=y.dtype)
        loss = ((y[:, :x.shape[-1]] - target) ** 2).mean()
        loss.backward()
        s.sync()
        return dict(wall=time.perf_counter() - t0, loss=float(loss.detach()), g=amp.grad,
                    amp=amp0, out=tuple(o.detach() for o in out),
                    zeros=int((amp0 == 0).sum()), launches=sweeps_mod.LAUNCHES)

    for order in ("jacobi", "jacobi_mxu", "gs"):
        r32, r64 = run(order, torch.float32), run(order, torch.float64)
        g, g64 = r32["g"], r64["g"]
        ok = bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        s.check(ok and r32["zeros"] > 0 and r32["launches"] == 0,
                f"gradient, order={order!r}: {r32['zeros']} exactly-zero bins, loss "
                f"{r32['loss']:.4e}, max|g| {float(g.abs().max()):.4e}, finite and nonzero; "
                f"forward + backward {1e3 * r32['wall']:.1f} ms (float64 "
                f"{1e3 * r64['wall']:.1f} ms); {r32['launches']} kernel launches")
        per = []
        for b in range(GRAD_B):
            scale = float(r64["amp"][b].max())
            fwd = max(float((r32["out"][k][b].double() - r64["out"][k][b]).abs().max())
                      for k in (0, 1)) / scale
            gm32, gm64 = float(g[b].abs().max()), float(g64[b].abs().max())
            rel = float((g[b].double() - g64[b]).abs().max()) / gm64
            per.append(dict(forward_rel=fwd, grad_max=gm32, grad_max_f64=gm64, grad_rel=rel,
                            held=fwd <= GRAD_FWD_COND))
        held = [b for b, p in enumerate(per) if p["held"]]
        worst = max((per[b]["grad_rel"] for b in held), default=float("inf"))
        print(f"  {order}: per utterance, float32 vs float64 forward max|d|/max amp, max|g| "
              f"float32 / float64, max|dg|/max|g64|: " + "; ".join(
                  f"{b}: {p['forward_rel']:.2e}, {p['grad_max']:.3e} / {p['grad_max_f64']:.3e}"
                  f", {p['grad_rel']:.2e}" + ("" if p["held"] else " (forward ill-conditioned,"
                                              " not held)") for b, p in enumerate(per)))
        s.check(held and worst <= TOL_GRAD_F64,
                f"gradient, order={order!r}, float32 vs the float64 witness on the "
                f"{len(held)} of {GRAD_B} utterances whose forward agrees to "
                f"{GRAD_FWD_COND:g} x max amp: max|dg|/max|g64| {worst:.2e} "
                f"(tol {TOL_GRAD_F64:g})")
        res[order] = dict(wall_ms=1e3 * r32["wall"], wall_f64_ms=1e3 * r64["wall"],
                          loss=r32["loss"], loss_f64=r64["loss"],
                          grad_max=float(g.abs().max()), zero_bins=r32["zeros"],
                          utterances=per)
    auto = lws_torch.LWS(512, 128, device=dev)
    sr, si = auto.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si).requires_grad_()
    msg = ""
    try:
        auto.batch_lws((amp, torch.zeros_like(amp)), thresholds=thr)
    except ValueError as e:
        msg = str(e)
    s.check("backend='torch'" in msg, f"backend='auto' (order 'gs', K1) on a tensor that "
            f"requires grad raises: {msg[:120]!r}")
    return res


# Phase 12, the sharded sweeps (lws_torch.parallel): the ranks are spawned
# from this script (torch.multiprocessing, spawn) and join through a file
# store under build/. Case (a) is one NCCL rank, mesh (1, 1); cases (b)-(e)
# are PAR_RANKS gloo ranks that share the one card (NCCL refuses two ranks
# on one GPU), so their times are no measure of scaling. Case (b) runs
# longform's geometry on the first PAR_LONG_SECONDS of the 630 s stream (its
# depth cut to keep the run inside its time), T trimmed to a multiple of
# the ranks, an exchange every PAR_EXCHANGE sweeps; its random-phase check
# runs PAR_CASE_SWEEPS sweeps at alpha=1. Case (d): jacobi_mxu over (1, 4) at
# F = 2049 on PAR_MXU_FRAMES frames, 2 sweeps, held to the unsharded order
# to TOL_MXU_SHARD x max amp (lws_tpu's dryrun phase 3). The batch-mean
# consistency of a sharded run from |X| stays within TOL_SHARD_DB of the
# unsharded one at mesh (1, 1) and within TOL_SHARD_MEAN_DB over 2 or 4
# time shards (lws_tpu's bound, tests/test_sharding.py:203-251). Case (f)
# runs lws_torch.entry.dryrun_multichip in both spawns at lws_tpu's sizes
# and tolerances (its own checks raise), case (g) the multi-card example's
# stages in both, and the example's command line runs once after them, its
# own PAR_RANKS ranks on this card. After (f) and (g), the kernels they
# reached run again beside their plain versions on the same magnitudes
# from seeded random phases (TOL_CASE x max amp; the online stage as phase
# 3 holds it; batch schedules of more than 3 sweeps their last 3).
PAR_RANKS, PAR_TIMEOUT_S, PAR_JOIN_S = 4, 300, 600
PAR_LONG_SECONDS, PAR_EXCHANGE, PAR_CASE_SWEEPS = 120.0, 3, 12
PAR_MXU_FRAMES = 128
PAR_REPORT_FRAMES, PAR_REPORT_SWEEPS = 2048, 20  # case (e), scaling_report's defaults
# case (g): the multi-card example's sizes (examples.multichip.run's
# defaults: utterances per 'data' rank, seconds, frames per 'time' rank) and
# its processor's batch sweeps
EX_UTTERANCES, EX_SECONDS, EX_FRAMES, EX_SWEEPS = 4, 3.0, 256, 50
TOL_SHARD_DB, TOL_SHARD_MEAN_DB, TOL_MXU_SHARD = 0.05, 0.25, 2e-4


class RankChecks(Smoke):
    """A rank's checks, kept for the parent to report."""

    def __init__(self, torch):
        super().__init__(torch)
        self.checks = []

    def check(self, ok, what):
        self.checks.append((bool(ok), what))


def _rel(torch, a, b, amp):
    """max |a - b| over both planes, and that over max amp."""
    d = float(torch.maximum((a[0] - b[0]).abs(), (a[1] - b[1]).abs()).max())
    return d, d / float(amp.max())


def _timed_run(s, torch, sweeps_mod, fn, warm=False):
    """fn() once, counted and timed: (output, K1 launches, K1 ms (CUDA
    events around its wrapper, summed), wall ms). With `warm`, an uncounted
    fn() first takes the process's first-launch costs off the timed run."""
    if warm:
        fn()
    sweeps_mod.LAUNCHES = 0
    with KernelTimer(torch, sweeps_mod, "tiled_lws_sweeps") as kt:
        s.sync()
        t0 = time.perf_counter()
        out = fn()
        s.sync()
        wall = time.perf_counter() - t0
    return out, sweeps_mod.LAUNCHES, kt.ms(), 1e3 * wall


def _shard_bound(torch, lws_torch, sweeps_mod, proc, pair, mesh):
    """(bound_ms, bound_by) of this rank's share of MAIN_SWEEPS batch sweeps
    of the global `pair` time-sharded over `mesh`: the live sweeps of its
    shard against the whole time axis's mean (sweep_bound). Collective: an
    all-reduce over 'time'."""
    from lws_torch.parallel import sharding
    local = sharding.shard_pair(pair, mesh, time_sharded=True)
    thr = torch.as_tensor(lws_torch.get_thresholds(MAIN_SWEEPS, 100, 0.1, 1),
                          dtype=torch.float32, device=local[0].device)
    live = sweeps_mod.sweep_schedule(*local, thr, sharding._global_mean(*local, mesh))[2]
    B, T, F = local[0].shape
    return sweep_bound(proc._st_batch, proc.batch_inner_passes, live, T, F, B)[:2]


def _shard_case_a(s, torch, lws_torch, par, sweeps_mod):
    """(a) one NCCL rank, mesh (1, 1): batch_lws(mesh=) on the batch path's
    input against batch_lws() without a mesh. One time shard has nothing to
    exchange: the sweeps are one K1 launch, bit-equal to the unsharded."""
    dev = torch.device(DEVICE)
    x = make_batch(MAIN_B, int(MAIN_SECONDS * SAMPLE_RATE), SAMPLE_RATE,
                   np.random.default_rng(0))
    proc = lws_torch.LWS(512, 128, device=dev)
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    mesh = par.make_mesh(1, 1, device=dev)
    shared = par.multihost.ranks_per_card(dev)  # an all-gather on the NCCL group
    out, launches, k1_ms, wall = _timed_run(
        s, torch, sweeps_mod, lambda: proc.batch_lws(pair, MAIN_SWEEPS, mesh=mesh), warm=True)
    s.check(launches == 1, f"(a) K1 launches in batch_lws(mesh=(1, 1)): {launches} (one "
            f"time shard, nothing to exchange: 1 for the {MAIN_SWEEPS} sweeps)")
    bound_ms, bound_by = _shard_bound(torch, lws_torch, sweeps_mod, proc, pair, mesh)
    mag = float(((torch.sqrt(out[0] ** 2 + out[1] ** 2) - amp).abs()
                 / amp.clamp_min(1e-30)).max())
    c_sh = float(proc.get_consistency(out).mean())
    c_un = float(proc.get_consistency(proc.batch_lws(pair, MAIN_SWEEPS)).mean())
    s.check(mag <= TOL_MAGNITUDE and abs(c_sh - c_un) <= TOL_SHARD_DB,
            f"(a) from |X|: magnitudes {mag:.2e} (tol {TOL_MAGNITUDE:g}); consistency "
            f"{c_sh:.4f} dB vs unsharded {c_un:.4f} dB: {abs(c_sh - c_un):.4f} dB "
            f"(tol {TOL_SHARD_DB})")
    r0, i0, ramp = random_phases(torch, np.random.default_rng(21), sr, si)
    sh = proc.batch_lws((r0, i0), MAIN_SWEEPS, mesh=mesh)
    d, rel = _rel(torch, sh, proc.batch_lws((r0, i0), MAIN_SWEEPS), ramp)
    s.check(d == 0, f"(a) from random phases: max|d| {d:.3e} against batch_lws() (bit-equal "
            f"expected: the same launch on the same input)")
    return dict(backend="nccl", mesh=[1, 1], ranks_per_card=shared, launches=launches,
                k1_ms=k1_ms, wall_ms=wall, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=d, rel_err=rel, consistency_db=c_sh, unsharded_db=c_un)


def _shard_case_b(s, torch, lws_torch, par, sweeps_mod, rank, x_long):
    """(b) mesh (1, PAR_RANKS), kernel="tiled", longform's geometry on the
    prefix: from |X| against the unsharded batch_lws; from random phases
    against segmented_lws_sweeps given the same mean."""
    from lws_torch.parallel import sharding
    from lws_torch.ops import segmented as seg_mod
    import torch.distributed as dist
    dev = torch.device(DEVICE)
    proc = lws_torch.LWS(LONG_FSIZE, LONG_FSHIFT, device=dev)
    sr, si = proc.stft_ri(x_long)
    T = sr.shape[-2] // PAR_RANKS * PAR_RANKS
    sr, si = sr[:, :T].contiguous(), si[:, :T].contiguous()
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    mesh = par.make_mesh(1, PAR_RANKS, device=dev)
    dist.barrier()
    out, launches, k1_ms, wall = _timed_run(
        s, torch, sweeps_mod, lambda: proc.batch_lws(pair, MAIN_SWEEPS, mesh=mesh, kernel="tiled",
                                                     sweeps_per_exchange=PAR_EXCHANGE))
    blocks = -(-MAIN_SWEEPS // PAR_EXCHANGE)
    s.check(launches == blocks, f"(b) K1 launches on this rank: {launches} (one per "
            f"{PAR_EXCHANGE}-sweep block: {blocks})")
    bound_ms, bound_by = _shard_bound(torch, lws_torch, sweeps_mod, proc, pair, mesh)
    st, ip, scheme = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme
    thr = torch.as_tensor(lws_torch.get_thresholds(PAR_CASE_SWEEPS, 1, 0.1, 1),
                          dtype=torch.float32, device=dev)
    r0, i0, ramp = random_phases(torch, np.random.default_rng(22), sr, si)
    local = sharding.shard_pair((r0, i0), mesh, time_sharded=True)
    mean = sharding._global_mean(*local, mesh)
    sh = sharding.gather_pair(sharding.sharded_lws_sweeps(
        *local, st, thr, mesh, inner_passes=ip, inner_scheme=scheme, kernel="tiled",
        sweeps_per_exchange=PAR_EXCHANGE), mesh)
    res = dict(backend="gloo", mesh=[1, PAR_RANKS], shape=[1, int(T), int(sr.shape[-1])],
               launches=launches, k1_ms=k1_ms, wall_ms=wall, bound_ms=bound_ms,
               bound_by=bound_by)
    if rank == 0:
        mag = float(((torch.sqrt(out[0] ** 2 + out[1] ** 2) - amp).abs()
                     / amp.clamp_min(1e-30)).max())
        s.check(mag <= TOL_MAGNITUDE, f"(b) magnitudes preserved: {mag:.2e} "
                f"(tol {TOL_MAGNITUDE:g})")
        seg = seg_mod.segmented_lws_sweeps(r0, i0, st, thr, segments=PAR_RANKS,
                                           sweeps_per_exchange=PAR_EXCHANGE, inner_passes=ip,
                                           inner_scheme=scheme, mean_amp=mean)
        d, rel = _rel(torch, sh, seg, ramp)
        s.check(d == 0,
                f"(b) from random phases, {PAR_CASE_SWEEPS} sweeps at alpha=1: gathered vs "
                f"segmented_lws_sweeps(segments={PAR_RANKS}, sweeps_per_exchange="
                f"{PAR_EXCHANGE}) on K1 given the same mean: max|d| {d:.3e}, /max amp "
                f"{rel:.3e} (bit-equal expected: the same blocks, halos and frozen ends)")
        t0 = time.perf_counter()
        whole = proc.batch_lws(pair, MAIN_SWEEPS)
        s.sync()
        un_ms = 1e3 * (time.perf_counter() - t0)
        c_sh = float(proc.get_consistency(out)[0])
        c_un = float(proc.get_consistency(whole)[0])
        S_un = proc._auto_segments(1, T)
        s.check(abs(c_sh - c_un) <= TOL_SHARD_MEAN_DB,
                f"(b) from |X|: sharded {c_sh:.4f} dB vs unsharded (S = {S_un}, exchange every "
                f"{proc._SWEEPS_PER_EXCHANGE}) {c_un:.4f} dB: delta {c_sh - c_un:+.4f} dB "
                f"(tol {TOL_SHARD_MEAN_DB})")
        res.update(max_abs_err=d, rel_err=rel, consistency_db=c_sh, unsharded_db=c_un,
                   unsharded_segments=S_un, unsharded_ms=un_ms)
    dist.barrier()
    return res


def _shard_case_c(s, torch, lws_torch, par, sweeps_mod, rank):
    """(c) the batch path's input over meshes (4, 1) (from random phases,
    per utterance against batch_lws(): one time shard, so one K1 launch a
    rank) and (2, 2) (from |X|, batch-mean consistency against
    batch_lws())."""
    import torch.distributed as dist
    dev = torch.device(DEVICE)
    x = make_batch(MAIN_B, int(MAIN_SECONDS * SAMPLE_RATE), SAMPLE_RATE,
                   np.random.default_rng(0))
    proc = lws_torch.LWS(512, 128, device=dev)
    sr, si = proc.stft_ri(x)
    r0, i0, amp = random_phases(torch, np.random.default_rng(23), sr, si)
    pair = (amp, torch.zeros_like(amp))
    res = {}
    for shape, start in (((PAR_RANKS, 1), (r0, i0)), ((2, 2), pair)):
        mesh = par.make_mesh(*shape, device=dev)
        dist.barrier()
        out, launches, k1_ms, wall = _timed_run(
            s, torch, sweeps_mod, lambda: proc.batch_lws(start, MAIN_SWEEPS, mesh=mesh),
            warm=True)
        key = f"{shape[0]}x{shape[1]}"
        want = MAIN_SWEEPS if shape[1] > 1 else 1
        s.check(launches == want, f"(c) mesh {shape}: K1 launches on this rank {launches} "
                f"({'one per sweep' if shape[1] > 1 else 'one time shard: one launch'}: {want})")
        bound_ms, bound_by = _shard_bound(torch, lws_torch, sweeps_mod, proc, start, mesh)
        res[key] = dict(backend="gloo", mesh=list(shape), launches=launches, k1_ms=k1_ms,
                        wall_ms=wall, bound_ms=bound_ms, bound_by=bound_by)
        if rank == 0:
            whole = proc.batch_lws(start, MAIN_SWEEPS)
            if start is pair:
                c_sh = proc.get_consistency(out)
                c_un = proc.get_consistency(whole)
                dm = float(c_sh.mean() - c_un.mean())
                s.check(abs(dm) <= TOL_SHARD_MEAN_DB,
                        f"(c) mesh {shape} from |X|: batch-mean consistency "
                        f"{float(c_sh.mean()):.4f} dB vs unsharded {float(c_un.mean()):.4f} dB: "
                        f"delta {dm:+.4f} dB (tol "
                        f"{TOL_SHARD_MEAN_DB}); per utterance within "
                        f"{float((c_sh - c_un).abs().max()):.4f} dB")
                res[key].update(consistency_db=float(c_sh.mean()), unsharded_db=float(c_un.mean()))
            else:
                d, rel = max(_rel(torch, (out[0][b], out[1][b]), (whole[0][b], whole[1][b]),
                                  amp[b]) for b in range(MAIN_B))
                s.check(np.isfinite(rel) and rel <= TOL_CASE,
                        f"(c) mesh {shape} from random phases: per utterance max|d| {d:.3e}, "
                        f"/max amp {rel:.3e} against batch_lws() (tol {TOL_CASE:g}; "
                        f"{'bit-equal' if d == 0 else 'not bit-equal: the per-item mean is a '}"
                        f"{'' if d == 0 else 'reduction over 8 items here, over 32 there'})")
                res[key].update(max_abs_err=d, rel_err=rel)
        dist.barrier()
    return res


def _shard_case_d(s, torch, lws_torch, par, rank, x_long):
    """(d) order="jacobi_mxu" over (1, PAR_RANKS) at F = 2049."""
    dev = torch.device(DEVICE)
    proc = lws_torch.LWS(LONG_FSIZE, LONG_FSHIFT, order="jacobi_mxu", device=dev)
    sr, si = proc.stft_ri(x_long[:, :(PAR_MXU_FRAMES + 3) * LONG_FSHIFT])
    r0, i0, amp = random_phases(torch, np.random.default_rng(24), sr[:, :PAR_MXU_FRAMES],
                                si[:, :PAR_MXU_FRAMES])
    thr = lws_torch.get_thresholds(2, 1, 0.1, 1)
    out = proc.batch_lws((r0, i0), thresholds=thr, mesh=par.make_mesh(1, PAR_RANKS, device=dev))
    if rank == 0:
        rel = _rel(torch, out, proc.batch_lws((r0, i0), thresholds=thr), amp)[1]
        s.check(np.isfinite(rel) and rel <= TOL_MXU_SHARD,
                f"(d) jacobi_mxu over (1, {PAR_RANKS}), {tuple(r0.shape)}, 2 sweeps: "
                f"max|d|/max amp {rel:.3e} against the unsharded order (tol {TOL_MXU_SHARD:g})")
        return dict(shape=list(r0.shape), rel_err=rel)
    return {}


def _shard_case_e(s, torch, lws_torch, par):
    """(e) scaling_report over the ranks that share the card."""
    rep = par.scaling_report(lws_torch.LWS(512, 128, device=torch.device(DEVICE)),
                             T_frames=PAR_REPORT_FRAMES, iters=PAR_REPORT_SWEEPS,
                             time_shards=PAR_RANKS, kernel="tiled")
    want = {"T", "F", "iters", "shards", "kernel", "platform", "wall_1dev_s", "wall_Ndev_s",
            "speedup", "efficiency", "estimate_only"}
    s.check(set(rep) == want and rep["estimate_only"] is True and rep["shards"] == PAR_RANKS,
            f"(e) scaling_report(time_shards={PAR_RANKS}, kernel='tiled'): {rep}")
    return rep


def _pair_vs_plain(s, torch, what, kern, plain, amp, proc=None):
    """max|d| of a kernel route's pair against its plain version's, held to
    TOL_CASE x max amp; for an online stage (`proc` given) over its first
    ONLINE_EARLY_FRAMES frames, and per item by consistency to
    TOL_ONLINE_DB, as phase 3's online cases hold K3."""
    cut = (lambda x: x[..., :ONLINE_EARLY_FRAMES, :]) if proc is not None else (lambda x: x)
    d = float(torch.maximum((cut(kern[0]) - cut(plain[0])).abs(),
                            (cut(kern[1]) - cut(plain[1])).abs()).max())
    rel = d / float(amp.max())
    dc = 0.0 if proc is None else float(
        (proc.get_consistency(kern) - proc.get_consistency(plain)).abs().max())
    s.check(np.isfinite(d) and rel <= TOL_CASE and dc <= TOL_ONLINE_DB,
            f"{what} {tuple(kern[0].shape)} from random phases, kernel vs plain: "
            + (f"first {ONLINE_EARLY_FRAMES} frames " if proc is not None else "")
            + f"max|d|/max amp {rel:.3e} (tol {TOL_CASE:g})"
            + ("" if proc is None else f", per-item consistency max {dc:.4f} dB "
               f"(tol {TOL_ONLINE_DB})"))
    return d


def _twin(lws_torch, dev, *args, **kw):
    """A processor on the kernels and its backend="torch" twin."""
    return (lws_torch.LWS(*args, device=dev, **kw),
            lws_torch.LWS(*args, device=dev, backend="torch", **kw))


def _stages_vs_plain(s, torch, what, procs, amp, seed, stages):
    """This rank's stages of `procs` (kernel, plain) on `amp` with seeded
    random phases: "nofuture" (K1, v = -1) and "batch" (K1) to TOL_CASE x
    max amp, "online" (K3) as _pair_vs_plain holds it. `stages` maps each
    stage to its thresholds (None: the processor's schedule). Returns
    {stage: max|d|}."""
    start = random_phases(torch, np.random.default_rng(seed), amp, torch.zeros_like(amp))[:2]
    out = {}
    for stage, thr in stages.items():
        k, p = (getattr(proc, f"{stage}_lws")(start, thresholds=thr) for proc in procs)
        out[stage] = _pair_vs_plain(s, torch, f"{what} {stage}", k, p, amp,
                                    procs[1] if stage == "online" else None)
    return out


def _sharded_vs_plain(s, torch, what, procs, amp, seed, thr, mesh, rank, **kw):
    """batch_lws(mesh=, kernel="tiled") of `procs` (K1 on each shard, its
    halos exchanged; the plain frame loop on each shard) on the global `amp`
    with seeded random phases, the same on every rank. Collective over the
    mesh; a rank outside it returns None, and rank 0 compares and returns
    max|d|."""
    if mesh.coord is None:
        return None
    start = random_phases(torch, np.random.default_rng(seed), amp, torch.zeros_like(amp))[:2]
    k, p = (proc.batch_lws(start, thresholds=thr, mesh=mesh, kernel="tiled", **kw)
            for proc in procs)
    if rank != 0:
        return None
    return _pair_vs_plain(s, torch, f"{what} sharded over {tuple(mesh.shape.values())}", k, p,
                          amp)


def _dryrun_vs_plain(s, torch, lws_torch, par, rank, world):
    """(f)'s kernels against their plain versions at the dry run's shapes,
    on its magnitudes (entry.dryrun_inputs) with seeded random phases (from
    zero phase two correct tap orders part by up to 1.3 x max amp: TOL_CASE's
    note): phase 1's no-future sweep (K1, v = -1) and online stage (K3) on
    rank 0's 'data' block, and its tiled time-sharded sweeps (blocks of 2)
    over the dry run's mesh; phase 2's sharded and unsharded sweeps at
    F = 2049; phase 4's unsharded sweeps and its sharded ones over
    (1, time), the schedule's last 3 sweeps. Phase 1's 3 sharded sweeps at
    alpha = 100 are all dead on |N(0, 1)| (lws_tpu's thresholds), so its
    comparison holds the frozen copy only. Collective; rank 0 compares.
    Returns {stage: max|d|} on rank 0."""
    from lws_torch.entry import DRYRUN_SIZES, dryrun_inputs
    dev = torch.device(DEVICE)
    data, time_ = par.multihost.mesh_shape(world)
    mesh, mesh_t = par.make_mesh(data, time_, device=dev), par.make_mesh(1, time_, device=dev)
    A = {k: torch.as_tensor(v, device=dev) for k, v in dryrun_inputs(world, dev).items()}
    thr = lws_torch.get_thresholds
    p1 = _twin(lws_torch, dev, 32, 8, L=2)
    p2 = _twin(lws_torch, dev, 4096, 1024)
    p4 = _twin(lws_torch, dev, 512, 128)
    last3 = thr(DRYRUN_SIZES["p4_sweeps"], 100, 0.1, 1)[-3:]
    res = {}
    if rank == 0:
        res.update({f"phase1_{k}": v for k, v in _stages_vs_plain(
            s, torch, "(f) phase 1", p1, A["phase1"][:DRYRUN_SIZES["p1_batch"]], 31,
            dict(nofuture=thr(1, 1, 0.1, 1), online=thr(2, 1, 0.1, 1))).items()})
        res["phase2_batch"] = _stages_vs_plain(s, torch, "(f) phase 2", p2,
                                               A["phase2"], 32,
                                               dict(batch=thr(2, 1, 0.1, 1)))["batch"]
        res["phase4_batch"] = _stages_vs_plain(s, torch, "(f) phase 4 (last 3 sweeps)",
                                               p4, A["phase4"], 33, dict(batch=last3))["batch"]
    res["phase1_sharded"] = _sharded_vs_plain(s, torch, "(f) phase 1", p1, A["phase1"], 34,
                                              thr(3, 100, 0.1, 1), mesh, rank,
                                              sweeps_per_exchange=2)
    res["phase2_sharded"] = _sharded_vs_plain(s, torch, "(f) phase 2", p2, A["phase2"], 35,
                                              thr(2, 1, 0.1, 1), mesh, rank)
    res["phase4_sharded"] = _sharded_vs_plain(s, torch, "(f) phase 4 (last 3 sweeps)", p4,
                                              A["phase4"], 36, last3, mesh_t, rank)
    s.sync()
    return res if rank == 0 else {}


def _shard_case_f(s, torch, lws_torch, par, sweeps_mod, online_mod, processor_mod, world):
    """(f) lws_torch.entry.dryrun_multichip(world) in this rank's group at
    lws_tpu's sizes: its four phases and their checks (a failed check raises
    in every rank, which fails the run). The counts are set to 0 just
    before and read just after; each phase's K1 launches on this rank are
    held to what the phase runs: phase 1 the no-future sweep and the tiled
    route's blocks of 2 of its 3 sweeps, phase 2 one block per sweep, phase
    3 none (the Jacobi orders have no kernel), phase 4 one block per sweep
    on the ranks of its (1, time) mesh, and on rank 0 the unsharded call of
    phases 2 and 4 (the references run there only); a mesh with one time
    shard runs each sharded call as one launch. Phase 1's online stage is
    one K3 launch. K1's time is CUDA
    events around both names the dry run reaches it by (the sharded blocks
    through the wrapper's module, the unsharded calls through the
    processor's). Then, uncounted, _dryrun_vs_plain holds the kernels the
    dry run reached against their plain versions at its shapes."""
    import torch.distributed as dist
    from lws_torch.entry import DRYRUN_SIZES, dryrun_multichip
    dist.barrier()
    sweeps_mod.LAUNCHES = 0
    online_mod.LAUNCHES = 0
    with KernelTimer(torch, sweeps_mod, "tiled_lws_sweeps") as kt, \
            KernelTimer(torch, processor_mod, "tiled_lws_sweeps") as kp:
        t0 = time.perf_counter()
        rec = dryrun_multichip(world)
        s.sync()
        wall = time.perf_counter() - t0
    k1, k3 = sweeps_mod.LAUNCHES, online_mod.LAUNCHES
    def sharded(blocks):  # one time shard: the sharded call is one launch
        return 1 if rec["mesh"][1] == 1 else blocks

    ref = int(rec["rank"] == 0)  # rank 0's unsharded reference call
    want = dict(phase1=1 + sharded(-(-3 // 2)), phase2=ref + sharded(2), phase3=0,
                phase4=ref + (sharded(DRYRUN_SIZES["p4_sweeps"]) if rec["phase4"]["in_mesh"]
                              else 0))
    got = {p: rec[p]["k1_launches"] for p in want}
    s.check(got == want and k1 == sum(want.values()),
            f"(f) dryrun_multichip({world}), mesh {tuple(rec['mesh'])}: K1 launches by phase "
            f"{got} (want {want}), {k1} in all")
    s.check(rec["phase1"]["k3_launches"] == 1 and k3 == 1,
            f"(f) dryrun_multichip({world}): K3 launches in phase 1 "
            f"{rec['phase1']['k3_launches']}, {k3} in all (want 1: the online stage)")
    phases = {p: {k: v for k, v in rec[p].items() if not isinstance(v, np.ndarray)}
              for p in ("phase1", "phase2", "phase3", "phase4")}
    vs = _dryrun_vs_plain(s, torch, lws_torch, par, rec["rank"], world)
    return dict(backend=rec["backend"], mesh=rec["mesh"], wall_ms=1e3 * wall,
                launches=k1, k3_launches=k3, k1_ms=kt.ms() + kp.ms(), phases=phases,
                vs_plain_max_abs_err=vs)


def _shard_case_g(s, torch, lws_torch, par, sweeps_mod, online_mod, world):
    """(g) the multi-card example's two stages (lws_torch.examples.multichip.run)
    in this rank's group at its own sizes, counted from 0: per rank the
    run_lws stage is the no-future and batch sweeps (one K1 launch each)
    and the online stage (one K3 launch), and the time-sharded batch_lws
    one K1 launch per sweep (50), or one call over a mesh with one time
    shard. Magnitudes kept, run_lws above |X|'s consistency per utterance.
    Then, uncounted, the kernels it reached against their plain versions on
    its magnitudes with seeded random phases: run_lws's three stages on rank
    0's utterances (the batch stage its schedule's last 3 sweeps), and the
    time-sharded stage's last 3 sweeps over the same mesh."""
    import torch.distributed as dist
    from lws_torch.examples import multichip
    dev = torch.device(DEVICE)
    mesh = par.make_mesh(*par.multihost.mesh_shape(world), device=dev)
    data, time_ = mesh.shape["data"], mesh.shape["time"]
    dist.barrier()
    sweeps_mod.LAUNCHES = 0
    online_mod.LAUNCHES = 0
    with KernelTimer(torch, sweeps_mod, "tiled_lws_sweeps") as kt:
        t0 = time.perf_counter()
        rec = multichip.run(mesh, EX_UTTERANCES, EX_SECONDS, EX_FRAMES)
        s.sync()
        wall = time.perf_counter() - t0
    k1, k3 = sweeps_mod.LAUNCHES, online_mod.LAUNCHES
    want = 2 + (1 if time_ == 1 else EX_SWEEPS)
    s.check(k1 == want and k3 == 1, f"(g) the example's stages over {tuple(rec['mesh'])}: K1 "
            f"launches {k1} (want {want}: no-future, batch, and the sharded stage), K3 {k3} "
            f"(want 1)")
    ok = rec["magnitude_err"] <= TOL_MAGNITUDE and all(
        c > c0 for c, c0 in zip(rec["consistency"], rec["consistency_in"]))
    s.check(ok and np.isfinite(rec["long_consistency"]),
            f"(g) the example's stages: magnitudes {rec['magnitude_err']:.2e} (tol "
            f"{TOL_MAGNITUDE:g}), run_lws {np.mean(rec['consistency']):.4f} dB over "
            f"{rec['utterances']} utterances against |X| {np.mean(rec['consistency_in']):.4f}, "
            f"time-sharded {rec['long_consistency']:.4f} dB")
    # the example's inputs, drawn as multichip.run draws them
    procs = _twin(lws_torch, dev, 512, 128, mode="music", batch_iterations=EX_SWEEPS)
    rng = np.random.default_rng(0)
    sr, si = procs[0].stft_ri(multichip.tones(EX_UTTERANCES * data, EX_SECONDS, rng))
    long_amp = torch.as_tensor(np.abs(rng.standard_normal((data, EX_FRAMES * time_, 257))),
                               dtype=torch.float32, device=dev)
    k = procs[0]
    last3 = lws_torch.get_thresholds(EX_SWEEPS, k.batch_alpha, k.batch_beta, k.batch_gamma)[-3:]
    vs = {}
    if dist.get_rank() == 0:
        amp = torch.sqrt(sr * sr + si * si)[:EX_UTTERANCES]
        vs.update(_stages_vs_plain(s, torch, "(g) run_lws", procs, amp, 41,
                                   dict(nofuture=None, online=None, batch=last3)))
    vs["sharded"] = _sharded_vs_plain(s, torch, "(g) the time-sharded stage (last 3 sweeps)",
                                      procs, long_amp, 42, last3, mesh, dist.get_rank())
    s.sync()
    return dict(rec, launches=k1, k3_launches=k3, sharded_k1_ms=kt.ms(), wall_ms=1e3 * wall,
                vs_plain_max_abs_err=vs if dist.get_rank() == 0 else {})


def _parallel_rank(rank, world, backend, root, x_long):
    """Phase 12's rank `rank` of `world`: joins the group through a file
    store under `root`, runs its cases and writes its record to
    root/rank<rank>.json. An exception propagates: the parent's join
    re-raises it."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import lws_torch
    from lws_torch import parallel as par
    from lws_torch import processor as processor_mod
    from lws_torch.ops import lws_sweeps as sweeps_mod
    from lws_torch.ops import online as online_mod
    # the ranks share the host's cores: torch's default threads each would
    # oversubscribe them many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    par.init_distributed(coordinator_address=f"file://{root}/store", num_processes=world,
                         process_id=rank, backend=backend, timeout=PAR_TIMEOUT_S)
    s = RankChecks(torch)
    rec = dict(rank=rank, backend=dist.get_backend(), card=torch.cuda.get_device_name())
    if world == 1:
        rec["a"] = _shard_case_a(s, torch, lws_torch, par, sweeps_mod)
    else:
        rec["ranks_per_card"] = par.multihost.ranks_per_card(torch.device(DEVICE))
        rec["b"] = _shard_case_b(s, torch, lws_torch, par, sweeps_mod, rank, x_long)
        rec["c"] = _shard_case_c(s, torch, lws_torch, par, sweeps_mod, rank)
        rec["d"] = _shard_case_d(s, torch, lws_torch, par, rank, x_long)
        rec["e"] = _shard_case_e(s, torch, lws_torch, par)
    rec["f"] = _shard_case_f(s, torch, lws_torch, par, sweeps_mod, online_mod, processor_mod,
                             world)
    rec["g"] = _shard_case_g(s, torch, lws_torch, par, sweeps_mod, online_mod, world)
    rec["checks"] = s.checks
    dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _spawn_ranks(s, torch, world, backend, x_long):
    """Run `world` ranks of _parallel_rank; returns their records by rank
    ([] when a rank failed: recorded as a failed check)."""
    import shutil
    root = os.path.join(ROOT, "build", f"parallel_smoke_{backend}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        _parallel_rank, args=(world, backend, root, x_long), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + PAR_JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish within {PAR_JOIN_S} s")
    except Exception as e:  # a rank's exception or the time limit: the phase fails
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        s.check(False, f"phase 12, {world} {backend} rank(s): {type(e).__name__}: {e}")
        return []
    print(f"  {world} {backend} rank(s) spawned, joined and finished in "
          f"{time.perf_counter() - t0:.1f} s")
    recs = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            recs.append(json.load(f))
        for ok, what in recs[-1]["checks"]:
            s.check(ok, f"rank {r}: {what}")
    return recs


def parallel_phase(s, torch):
    """Phase 12: the sharded sweeps on the card, cases (a)-(g) and the
    multi-card example's command line. Returns K1's `sharded` entry for the
    kernels line."""
    n = int(LONG_SECONDS * LONG_RATE)
    x_long = make_batch(1, n, LONG_RATE, np.random.default_rng(LONG_SEED))[
        :, :int(PAR_LONG_SECONDS * LONG_RATE)].copy()
    print(f"sharded sweeps (lws_torch.parallel): (a) 1 NCCL rank, mesh (1, 1), "
          f"LWS(512, 128) on {MAIN_B} x {MAIN_SECONDS:g} s; (b)-(e) {PAR_RANKS} gloo ranks that "
          f"share this one card (halos staged through host memory), so no figure here is a "
          f"scaling figure")
    out, dry = {}, {}
    recs = _spawn_ranks(s, torch, 1, "nccl", None)
    if recs:
        dry["nccl_1"] = _dryrun_entry(recs)
        a = recs[0]["a"]
        print(f"  (a) backend {recs[0]['backend']}, mesh (1, 1), ranks per card "
              f"{a['ranks_per_card']}: wall {a['wall_ms']:.2f} ms, K1 {a['launches']} "
              f"launches, {a['k1_ms']:.2f} ms (bound {a['bound_ms']:.4f} ms by "
              f"{a['bound_by']}); consistency {a['consistency_db']:.4f} dB "
              f"(unsharded {a['unsharded_db']:.4f}); from random phases max|d| "
              f"{a['max_abs_err']:.3e}")
        out["a"] = dict(a, launches_per_rank=[a["launches"]], k1_ms_per_rank=[a["k1_ms"]],
                        wall_ms_per_rank=[a["wall_ms"]], bound_ms_per_rank=[a["bound_ms"]])
    recs = _spawn_ranks(s, torch, PAR_RANKS, "gloo", x_long)
    if recs:
        dry[f"gloo_{PAR_RANKS}"] = _dryrun_entry(recs)
        shared = recs[0]["ranks_per_card"]
        b = recs[0]["b"]
        out["b"] = dict(b, ranks_per_card=shared,
                        launches_per_rank=[r["b"]["launches"] for r in recs],
                        k1_ms_per_rank=[r["b"]["k1_ms"] for r in recs],
                        wall_ms_per_rank=[r["b"]["wall_ms"] for r in recs],
                        bound_ms_per_rank=[r["b"]["bound_ms"] for r in recs])
        print(f"  (b) backend {recs[0]['backend']}, mesh (1, {PAR_RANKS}), {shared} ranks on "
              f"one card, LWS({LONG_FSIZE}, {LONG_FSHIFT}) on the first {PAR_LONG_SECONDS:g} s "
              f"of the {LONG_SECONDS:g} s stream {tuple(b['shape'])} (depth cut from "
              f"{LONG_SECONDS:g} s), {MAIN_SWEEPS} sweeps, exchange every {PAR_EXCHANGE}: "
              f"per rank wall {[round(v, 2) for v in out['b']['wall_ms_per_rank']]} ms, K1 "
              f"launches {out['b']['launches_per_rank']}, K1 "
              f"{[round(v, 2) for v in out['b']['k1_ms_per_rank']]} ms, bound "
              f"{[round(v, 4) for v in out['b']['bound_ms_per_rank']]} ms by {b['bound_by']} "
              f"(ranks sharing one card: no scaling figure); unsharded batch_lws "
              f"{b['unsharded_ms']:.2f} ms")
        for key in recs[0]["c"]:
            c = recs[0]["c"][key]
            out[f"c_{key}"] = dict(c, ranks_per_card=shared,
                                   launches_per_rank=[r["c"][key]["launches"] for r in recs],
                                   k1_ms_per_rank=[r["c"][key]["k1_ms"] for r in recs],
                                   wall_ms_per_rank=[r["c"][key]["wall_ms"] for r in recs],
                                   bound_ms_per_rank=[r["c"][key]["bound_ms"] for r in recs])
            print(f"  (c) backend gloo, mesh {tuple(c['mesh'])}: per rank wall "
                  f"{[round(v, 2) for v in out[f'c_{key}']['wall_ms_per_rank']]} ms, K1 "
                  f"launches {out[f'c_{key}']['launches_per_rank']}, K1 "
                  f"{[round(v, 2) for v in out[f'c_{key}']['k1_ms_per_rank']]} ms, bound "
                  f"{[round(v, 4) for v in out[f'c_{key}']['bound_ms_per_rank']]} ms")
        out["d"] = recs[0]["d"]
        out["e"] = recs[0]["e"]
    if dry:
        out["dryrun"] = dry
    out["example_cli"] = _example_cli(s)
    return out


def _dryrun_entry(recs):
    """Case (f)'s records of every rank: each phase's numbers (rank 0's),
    and per rank the K1 launches by phase, K1's time, the wall and the K3
    launches."""
    f0 = recs[0]["f"]
    res = dict(backend=f0["backend"], mesh=f0["mesh"], phases=f0["phases"],
               launches_per_rank=[r["f"]["launches"] for r in recs],
               phase_launches_per_rank=[{p: v["k1_launches"] for p, v in r["f"]["phases"].items()}
                                        for r in recs],
               k1_ms_per_rank=[r["f"]["k1_ms"] for r in recs],
               wall_ms_per_rank=[r["f"]["wall_ms"] for r in recs],
               k3_launches_per_rank=[r["f"]["k3_launches"] for r in recs],
               vs_plain_max_abs_err=f0["vs_plain_max_abs_err"],
               example=dict(recs[0]["g"], launches_per_rank=[r["g"]["launches"] for r in recs],
                            k3_launches_per_rank=[r["g"]["k3_launches"] for r in recs],
                            wall_ms_per_rank=[r["g"]["wall_ms"] for r in recs]))
    ph = f0["phases"]
    print(f"  (f) dryrun_multichip({len(recs)}), backend {res['backend']}, mesh "
          f"{tuple(res['mesh'])}: phase 1 xla {ph['phase1']['consistency_xla']:.4f} / tiled "
          f"{ph['phase1']['consistency_tiled']:.4f} dB; phase 2 unsharded "
          f"{ph['phase2']['consistency_unsharded']:.4f} / sharded "
          f"{ph['phase2']['consistency_sharded']:.4f} dB; phase 3 max|d| "
          f"{ph['phase3']['max_abs_err']:.3e}; phase 4 unsharded "
          f"{ph['phase4']['consistency_unsharded']:.4f} / sharded "
          f"{ph['phase4']['consistency_sharded']:.4f} dB; per rank K1 launches "
          f"{res['launches_per_rank']}, K1 {[round(v, 2) for v in res['k1_ms_per_rank']]} ms, "
          f"wall {[round(v, 2) for v in res['wall_ms_per_rank']]} ms, K3 launches "
          f"{res['k3_launches_per_rank']}")
    print(f"  (f) kernels vs plain at the dry run's shapes, max|d|: "
          f"{ {k: float(f'{v:.3e}') for k, v in res['vs_plain_max_abs_err'].items()} }")
    g = res["example"]
    print(f"  (g) the example's kernels vs plain, max|d|: "
          f"{ {k: float(f'{v:.3e}') for k, v in g['vs_plain_max_abs_err'].items()} }")
    print(f"  (g) the example's stages, mesh {tuple(g['mesh'])}: run_lws "
          f"{np.mean(g['consistency']):.4f} dB over {g['utterances']} utterances (|X| "
          f"{np.mean(g['consistency_in']):.4f}), time-sharded {tuple(g['long_shape'])} "
          f"{g['long_consistency']:.4f} dB; per rank K1 launches {g['launches_per_rank']}, "
          f"K3 {g['k3_launches_per_rank']}, wall {[round(v, 2) for v in g['wall_ms_per_rank']]} "
          f"ms, rank 0's sharded K1 {g['sharded_k1_ms']:.2f} ms")
    return res


def _example_cli(s):
    """The multi-card example's command line once: PAR_RANKS ranks that it
    spawns on this card (gloo), rc 0, both result lines, and the
    data-parallel consistency above |X|'s. Its process group is killed
    whole if it outlives PAR_JOIN_S."""
    cmd = [sys.executable, "-m", "lws_torch.examples.multichip", "--ranks", str(PAR_RANKS),
           "--device", "cuda"]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        text, err = p.communicate(timeout=PAR_JOIN_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        text, err = p.communicate()
    wall = time.perf_counter() - t0
    for line in text.strip().splitlines():
        print(f"    {line}")
    dp = re.search(r"^data-parallel run_lws: (\d+) utterances, consistency (\S+) dB "
                   r"\(\|X\| (\S+) dB", text, re.MULTILINE)
    ts = re.search(r"^time-sharded batch_lws: T=(\d+) .*consistency (\S+) dB$", text,
                   re.MULTILINE)
    ok = p.returncode == 0 and dp is not None and ts is not None
    s.check(ok and float(dp[2]) > float(dp[3]) and np.isfinite(float(ts[2])),
            f"example CLI `{' '.join(cmd[1:])}`: rc {p.returncode} in {wall:.1f} s, both "
            f"result lines {'found' if dp and ts else 'MISSING'}" + (
                "" if p.returncode == 0 else f"; stderr tail: {err.strip()[-600:]}"))
    return dict(rc=p.returncode, wall_s=wall,
                consistency_db=float(dp[2]) if dp else None,
                abs_x_db=float(dp[3]) if dp else None,
                long_frames=int(ts[1]) if ts else None,
                long_consistency_db=float(ts[2]) if ts else None)


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
    ptxas = build_phase(s, sweeps_mod, online_mod)
    worst = kernel_cases(s, torch, lws_torch, sweeps_mod)
    free_function_case(s, torch, lws_torch, sweeps_mod)
    worst_online = online_cases(s, torch, lws_torch, online_mod)
    worst_chunk = chunk_cases(s, torch, lws_torch, online_mod)
    worst_new = new_online_cases(s, torch, lws_torch, online_mod)
    worst_packed = packed_cases(s, torch, lws_torch, sweeps_mod, packed_mod, seg_mod)
    batch_sweeps = main_path(s, torch, lws_torch, sweeps_mod, ptxas)
    packed_entry = packed_timing(s, torch, lws_torch, sweeps_mod, packed_mod, ptxas)
    online_entry, music_sweeps = music_path(s, torch, lws_torch, sweeps_mod, online_mod,
                                            ptxas)
    chunk_entry = stream_path(s, torch, lws_torch, online_mod, ptxas)
    longform = longform_path(s, torch, lws_torch, sweeps_mod, seg_mod, ptxas)
    fast = fast_mode(s, torch, lws_torch, sweeps_mod)
    vocoder = vocoder_path(s, torch, lws_torch, sweeps_mod, ptxas)
    resumable = resumable_path(s, torch, lws_torch, sweeps_mod)
    gradient = gradient_path(s, torch, lws_torch, sweeps_mod)
    torch.cuda.empty_cache()  # the ranks of phase 12 share this card
    sharded = parallel_phase(s, torch)
    # K1: the longform path's run at the top; the batch path's run, the
    # music path's batch stage, the vocoder and resumable runs nested, each
    # from its own run; beside them the plain paths that launch no kernel
    # (fast mode's Jacobi orders, the gradients); the sharded runs of phase
    # 12, each rank's from its own run
    entry = dict(name="lws_sweeps", route="cuda", source="lws_torch/csrc/lws_sweeps.cu",
                 replaces="lws_tpu/ops/pallas_packed.py:1411", library_ms=None,
                 **longform, batch=batch_sweeps, music=music_sweeps, vocoder=vocoder,
                 resumable=resumable, fast_mode=fast, gradient=gradient, sharded=sharded)
    # phase 12 (f) and (g): the kernels the dry run and the example reached,
    # against their plain versions (rank 0 of each spawn)
    vs = [(k, v) for d in sharded.get("dryrun", {}).values()
          for k, v in (*d["vs_plain_max_abs_err"].items(),
                       *d["example"]["vs_plain_max_abs_err"].items())]
    entry["max_abs_err"] = max([worst] + [v for k, v in vs if "online" not in k])
    online_entry["max_abs_err"] = max([worst_online, worst_new[False]]
                                      + [v for k, v in vs if "online" in k])
    # K3 in phase 12 (f): the dry run's phase-1 online stage, per rank
    online_entry["dryrun_phase1_launches"] = {
        k: v["k3_launches_per_rank"] for k, v in sharded.get("dryrun", {}).items()}
    online_entry["example_launches"] = {
        k: v["example"]["k3_launches_per_rank"] for k, v in sharded.get("dryrun", {}).items()}
    chunk_entry["max_abs_err"] = max(worst_chunk, worst_new[True])
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
