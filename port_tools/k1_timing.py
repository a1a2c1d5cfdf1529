#!/usr/bin/env python3
"""Time the sweep kernel K1 on the card at the shapes of its three paths,
against a previous version of its source built beside it.

    git show REV:lws_torch/csrc/lws_sweeps.cu > build/k1_old/lws_sweeps.cu
    git show REV:lws_torch/csrc/lws_common.cuh > build/k1_old/lws_common.cuh
    python3 port_tools/k1_timing.py [--old-csrc build/k1_old ...] [--reps 2]

Paths (chip_smoke.py's inputs): the batch path, LWS(512, 128) on
(32, 628, 257) x 100 sweeps at alpha=100 from zero phase; the music path's
batch stage shape, LWS(1024, 256) on (32, 316, 513), the same schedule;
one longform block, LWS(4096, 1024) on the 630 s stream's S = 8 segments
(8, 3692, 2049) x the schedule's first 3 sweeps (the longform call runs 34
such launches); the vocoder's sweeps, LWS(2048, 256) (Q = 8, the table
kernel) on 128 x 2.5 s at 22.05 kHz (128, 223, 1025), 100 sweeps. Each
runs through the wrapper (CUDA events around it), the current build and
each other one (named by its directory) in turns (other, current, current,
other, ...), with the outputs compared bit for bit. An other source whose
lws_sweeps_launch takes the weight planes alone (before the period-Q
table's arguments) runs through `legacy_k1`. Prints ms, microseconds per
frame and per barrier step, the launch plan and the card's name and power
limit. `--paths` picks paths by their first word. Needs one CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def bind_legacy(lib):
    """The argument types of an earlier lws_sweeps.cu's K1 entry point,
    which takes the weight planes alone (7 pointers, 10 ints, the stream)."""
    lib.lws_sweeps_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    lib.lws_sweeps_launch.restype = ctypes.c_int
    lib.lws_sweeps_error_string.argtypes = [ctypes.c_int]
    lib.lws_sweeps_error_string.restype = ctypes.c_char_p
    return lib


def legacy_k1(lib, sr, si, st, thresholds, inner_passes, inner_scheme, halo=None,
              mean_amp=None):
    """K1 of an earlier source (weight planes alone) through the current
    padded state and schedule (ops.lws_sweeps.launch_padded), on the
    library `lib` (bind_legacy)."""
    from lws_torch.ops import _build
    from lws_torch.ops import lws_sweeps as sweeps_mod
    load = _build.load
    _build.load = {"lws_sweeps": lib}.__getitem__
    try:
        out, _ = sweeps_mod.launch_padded(
            "lws_sweeps_launch", sr, si, st, thresholds, halo, mean_amp, (st.Wr, st.Wi),
            sweeps_mod._schedule_args(st, inner_passes, inner_scheme))
    finally:
        _build.load = load
    return out


def build_old(csrc: str):
    """nvcc of csrc/lws_sweeps.cu with the port's flags into csrc; (library,
    whether its K1 takes the weight table)."""
    from lws_torch.ops import _build
    out = os.path.join(csrc, "lws_sweeps_other.so")
    src = os.path.join(csrc, "lws_sweeps.cu")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {csrc}:\n{proc.stderr}")
    with open(src) as f:
        table = re.search(r"int lws_sweeps_launch\([^)]*const void\* table", f.read()) is not None
    lib = ctypes.CDLL(out)
    return (lib if table else bind_legacy(lib)), table


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", action="append", default=[],
                    help="directory with another lws_sweeps.cu and its headers (repeatable)")
    ap.add_argument("--reps", type=int, default=2, help="timed calls of each version")
    ap.add_argument("--paths", nargs="+", default=["batch", "music", "longform", "vocoder"],
                    help="the paths to time, by their first word")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_timing: needs a CUDA card", file=sys.stderr)
        return 2
    import lws_torch
    from chip_smoke import card_lines, make_batch
    from lws_torch.ops import _build
    from lws_torch.ops import lws_sweeps as sweeps_mod

    card_lines(torch)
    dev = torch.device("cuda")
    libs = {"current": (_build.load("lws_sweeps"), True)}
    for d in args.old_csrc:
        libs[os.path.basename(os.path.normpath(d))] = build_old(d)
    others = [n for n in libs if n != "current"]
    thr100 = lws_torch.get_thresholds(100, 100, 0.1, 1)
    paths = (("batch", 512, 128, 32, 5.0, 16000, None, thr100),
             ("music batch stage", 1024, 256, 32, 5.0, 16000, None, thr100),
             ("longform block", 4096, 1024, 8, 3692 * 1024 / 48000, 48000, 3692, thr100[:3]),
             ("vocoder sweeps", 2048, 256, 128, 2.5, 22050, None, thr100))
    load = _build.load
    for label, fsize, fshift, B, secs, rate, frames, thr in paths:
        if label.split()[0] not in args.paths:
            continue
        proc = lws_torch.LWS(fsize, fshift, device=dev)
        x = make_batch(B, int(secs * rate), rate, np.random.default_rng(0))
        sr, si = proc.stft_ri(x)
        if frames:
            sr, si = sr[:, :frames].contiguous(), si[:, :frames].contiguous()
        amp = torch.sqrt(sr * sr + si * si)
        pair = (amp, torch.zeros_like(amp))
        st, ip = proc._st_batch, proc.batch_inner_passes
        thr_t = torch.as_tensor(thr, dtype=torch.float32, device=dev)
        live = sweeps_mod.sweep_schedule(*pair, thr_t)[2]
        T, F = amp.shape[-2:]
        n_frames = int(live.sum(dim=1).max()) * int(T)
        plan = sweeps_mod.stencil_plan(F, st)
        print(f"{label}: {tuple(amp.shape)} x {len(thr)} sweeps, {n_frames} frames per CTA; "
              f"plan {plan.threads} threads x {plan.bins} bins, ring {plan.ring}, "
              f"{plan.staged}/{plan.taps} taps staged, table {plan.table}, {plan.bytes} B",
              flush=True)
        order = [n for _ in range(args.reps) for n in (*others, "current")]
        order = order[:len(order) // 2] + order[len(order) // 2:][::-1]
        times = {n: [] for n in libs}
        outs = {}
        for name in ["current", *libs] + order:  # one warm-up call each
            lib, table = libs[name]
            _build.load = {"lws_sweeps": lib}.__getitem__
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if table:
                out = sweeps_mod._launch(*pair, st, thr_t, ip, proc.inner_scheme, None, None)
            else:
                out = legacy_k1(lib, *pair, st, thr_t, ip, proc.inner_scheme)
            b.record()
            b.synchronize()
            outs[name] = out
            times[name].append(a.elapsed_time(b))
        _build.load = load
        for name in libs:
            ms = float(np.median(times[name][-args.reps:]))
            print(f"  {name}: {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in times[name][-args.reps:])}) "
                  f"-> {1e3 * ms / n_frames:.3f} us per frame, "
                  f"{1e3 * ms / (n_frames * (1 + ip)):.3f} us per step", flush=True)
        for name in others:
            same = all(torch.equal(outs["current"][k], outs[name][k]) for k in (0, 1))
            print(f"  current vs {name} output: {'bit-equal' if same else 'DIFFER'}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
