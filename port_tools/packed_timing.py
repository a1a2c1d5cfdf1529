#!/usr/bin/env python3
"""Time the grouped sweep kernel K5 on the card against another version of
its source built beside it, and hold the two to the same bits.

    mkdir -p build/k5_old
    git show REV:lws_torch/csrc/lws_sweeps.cu > build/k5_old/lws_sweeps.cu
    git show REV:lws_torch/csrc/lws_common.cuh > build/k5_old/lws_common.cuh
    python3 port_tools/packed_timing.py --old-csrc build/k5_old [--reps 2] [--micro 4 2]

An other build is launched as its source expects: through the current wrapper
(ops.packed.launch_grouped) where it exports lws_packed_plan (the weight
table design), else with per-bin weight planes (legacy_grouped: the K5 of
revision b1968d1 and before). Shapes, each at micro 4 (--micro: others) from zero phase, 100
sweeps at alpha=100, LWS's batch stencil and its 3 jacobi passes: the
batch path's input, LWS(512, 128) on (32, 628, 257) (chip_smoke.py's K5
timing), and the music path's batch stage shape, LWS(1024, 256) on (32,
316, 513). The current build and each other one run in turns (other,
current, current, other, ...), CUDA events around each call, and their
outputs are compared bit for bit. Prints ms, microseconds per barrier step
(ceil(T / micro) groups x (1 + passes) steps per live sweep), the launch
plan and the card's name and power limit. Needs one CUDA card and nvcc.

bind_legacy_packed / legacy_grouped launch a library built from such a
previous source (here and in port_tools/cuda_on_cpu.py).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def bind_legacy_packed(lib):
    """The argument types of a previous lws_sweeps.cu's entry points (K5
    with per-bin weight planes: 7 pointers, 9 ints, the stream)."""
    lib.lws_sweeps_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    lib.lws_sweeps_launch.restype = ctypes.c_int
    lib.lws_packed_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    lib.lws_packed_launch.restype = ctypes.c_int
    lib.lws_sweeps_error_string.argtypes = [ctypes.c_int]
    lib.lws_sweeps_error_string.restype = ctypes.c_char_p
    return lib


def legacy_grouped(lib, sr, si, st, thresholds, micro, inner_passes, halo=None,
                   mean_amp=None):
    """K5 of a previous source (per-bin weight planes) through the current
    padded state and schedule (ops.lws_sweeps.launch_padded), on the
    library `lib` (bind_legacy_packed)."""
    from lws_torch.ops import _build
    from lws_torch.ops import lws_sweeps as sweeps_mod
    load = _build.load
    _build.load = {"lws_sweeps": lib}.__getitem__
    try:
        passes = max(1, int(inner_passes)) if st.has_centre else 1
        out, _ = sweeps_mod.launch_padded(
            "lws_packed_launch", sr, si, st, thresholds, halo, mean_amp, (st.Wr, st.Wi),
            (int(micro), passes, int(st.has_centre)))
    finally:
        _build.load = load
    return out


def build_other(csrc: str):
    """nvcc of csrc/lws_sweeps.cu with the port's flags into csrc; (library,
    whether it takes the weight table)."""
    from lws_torch.ops import _build
    out = os.path.join(csrc, "lws_sweeps_other.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(csrc, "lws_sweeps.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {csrc}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    table = hasattr(lib, "lws_packed_plan")
    return (lib if table else bind_legacy_packed(lib)), table


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", action="append", default=[],
                    help="directory with another lws_sweeps.cu and its headers (repeatable)")
    ap.add_argument("--reps", type=int, default=2, help="timed calls of each version")
    ap.add_argument("--micro", type=int, nargs="+", default=[4], help="frames a group")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("packed_timing: needs a CUDA card", file=sys.stderr)
        return 2
    import lws_torch
    from chip_smoke import card_lines, make_batch
    from lws_torch.ops import _build
    from lws_torch.ops import lws_sweeps as sweeps_mod
    from lws_torch.ops import packed as packed_mod

    card_lines(torch)
    dev = torch.device("cuda")
    libs = {"current": (_build.load("lws_sweeps"), True)}
    for d in args.old_csrc:
        libs[os.path.basename(os.path.normpath(d))] = build_other(d)
    others = [n for n in libs if n != "current"]
    thr = torch.as_tensor(lws_torch.get_thresholds(100, 100, 0.1, 1), dtype=torch.float32,
                          device=dev)
    load = _build.load
    for (label, fsize, fshift), micro in ((shape, m) for shape in (
            ("batch path input", 512, 128), ("music batch stage shape", 1024, 256))
            for m in args.micro):
        proc = lws_torch.LWS(fsize, fshift, device=dev)
        x = make_batch(32, 80000, 16000, np.random.default_rng(0))
        sr, si = proc.stft_ri(x)
        amp = torch.sqrt(sr * sr + si * si)
        pair = (amp, torch.zeros_like(amp))
        st, ip = proc._st_batch, proc.batch_inner_passes
        live = sweeps_mod.sweep_schedule(*pair, thr)[2]
        T, F = amp.shape[-2:]
        steps = int(live.sum(dim=1).max()) * (-(-int(T) // micro)) * (1 + ip)
        wt = packed_mod.packed_weights(st)
        plan = packed_mod.packed_plan(F, st.Q, st.L, micro, int(wt.dks.numel()), wt.period)
        print(f"{label}: {tuple(amp.shape)} x {len(thr)} sweeps, micro {micro}, {steps} "
              f"steps per CTA; plan {plan.threads} threads x {plan.bins} elements, "
              f"{plan.slots} ring slots, ring / table / centre / sums in shared memory "
              f"{plan.ring} / {plan.table} / {plan.centre} / {plan.sums}, fixed {plan.fixed}, "
              f"{plan.bytes} B, scratch {plan.scratch}", flush=True)
        order = [n for _ in range(args.reps) for n in (*others, "current")]
        order = order[:len(order) // 2] + order[len(order) // 2:][::-1]
        times = {n: [] for n in libs}
        outs = {}
        for name in ["current", *libs] + order:  # one warm-up call each
            lib, table = libs[name]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if table:
                _build.load = {"lws_sweeps": lib}.__getitem__
                a.record()
                out = packed_mod.launch_grouped(*pair, st, thr, micro, ip)
                b.record()
                _build.load = load
            else:
                a.record()
                out = legacy_grouped(lib, *pair, st, thr, micro, ip)
                b.record()
            b.synchronize()
            outs[name] = out
            times[name].append(a.elapsed_time(b))
        for name in libs:
            ms = float(np.median(times[name][-args.reps:]))
            runs = ", ".join(f"{t:.2f}" for t in times[name][-args.reps:])
            print(f"  {name}: {ms:.2f} ms (runs {runs}) -> {1e3 * ms / steps:.3f} us per step",
                  flush=True)
        for name in others:
            same = all(torch.equal(outs["current"][k], outs[name][k]) for k in (0, 1))
            print(f"  current vs {name} output: {'bit-equal' if same else 'DIFFER'}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
