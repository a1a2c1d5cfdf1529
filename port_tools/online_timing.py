#!/usr/bin/env python3
"""Time the online kernels K3 and K4 on the card against a previous version
of their source built beside them.

    mkdir -p build/online_old
    git show REV:lws_torch/csrc/lws_online.cu > build/online_old/lws_online.cu
    git show REV:lws_torch/csrc/lws_common.cuh > build/online_old/lws_common.cuh
    python3 port_tools/online_timing.py --old-csrc build/online_old [--reps 2]

An other build is launched as its source expects: through the current
wrappers where it exports lws_online_plan (the weight-table kernels),
else with per-bin weight planes and tap lists (legacy_*: 4c91317 and
before). Shapes (chip_smoke.py's inputs): K3 on the music
path's online stage, LWS(1024, 256, mode="music") on (32, 316, 513), 10
rounds at alpha=1, from the no-future stage's output; K4 on the streaming
run, LWS(512, 128, look_ahead=3, online_iterations=10), 8 streams x 5 s at
16 kHz as 10 chunks of 64 frames (the last ones drain) with the running
mean. The current build and each other one run in turns (other, current,
current, other, ...), CUDA events around each K3 call and around each
10-launch K4 run, and their outputs (K4: every chunk's rows and the final
state) are compared bit for bit. Prints ms, microseconds per row update
and the card's name and power limit. Needs one CUDA card and nvcc.

legacy_weight_sets / legacy_online / legacy_chunk launch a library built
from such a previous source (here and in port_tools/cuda_on_cpu.py).
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


def bind_legacy(lib):
    """The argument types of the previous lws_online.cu's entry points."""
    lib.lws_online_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.lws_online_launch.restype = ctypes.c_int
    lib.lws_online_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    lib.lws_online_chunk_launch.restype = ctypes.c_int
    return lib


def legacy_weight_sets(st_la, st_ai, st_af):
    """(wr, wi, taps, counts) as the previous kernels took them: the sets
    [st_ai, st_af, *st_la] stacked (S, 2Q-1, 2L+1, F), each set's live tap
    indices dr*(2L+1)+dk (off-centre, then centre; (S, R*K), zero padded) and
    their counts (S, 2), on the stencils' device."""
    import torch
    sets = [st_ai, st_af, *st_la]
    Q, L = st_af.Q, st_af.L
    R, K, c = 2 * Q - 1, 2 * L + 1, Q - 1
    taps = np.zeros((len(sets), R * K), dtype=np.int32)
    counts = np.zeros((len(sets), 2), dtype=np.int32)
    for s, st in enumerate(sets):
        off = [dr * K + dk for dr in range(R) for dk in range(K) if dr != c and st.nz[dr, dk]]
        cen = [c * K + dk for dk in range(K) if st.nz[c, dk]]
        taps[s, :len(off) + len(cen)] = off + cen
        counts[s] = len(off), len(cen)
    dev = st_af.Wr.device
    return (torch.stack([st.Wr for st in sets]).contiguous(),
            torch.stack([st.Wi for st in sets]).contiguous(),
            torch.as_tensor(taps, device=dev), torch.as_tensor(counts, device=dev))


def _stream(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream if t.is_cuda else None


def legacy_online(lib, weights, sr, si, thresholds, LA, inner_passes, inner_scheme):
    """K3 of a previous build on (B, T, F) planes, as its wrapper launched it."""
    import torch

    from lws_torch.ops import online as online_mod
    wr, wi, taps, counts = weights
    B, T, F = sr.shape
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, :] * amp.mean(dim=(-2, -1))[:, None]).contiguous()
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    passes, color_k, rounds = online_mod._scheme(inner_passes, inner_scheme)
    Q, L = (wr.shape[1] + 1) // 2, (wr.shape[2] - 1) // 2
    err = lib.lws_online_launch(
        *[t.data_ptr() for t in (sr, si, amp, out_r, out_i, wr, wi, taps, counts, thr)],
        B, T, F, Q, L, LA, int(thresholds.shape[0]), passes, color_k, rounds, _stream(sr))
    if err:
        raise RuntimeError(f"previous lws_online_launch failed ({err})")
    return out_r, out_i


def legacy_chunk(lib, weights, sr, si, state, means, thresholds, n_live, inner_passes,
                 inner_scheme):
    """K4 of a previous build over one chunk, as its wrapper launched it;
    returns (rows_r, rows_i, new state)."""
    import torch

    from lws_torch.ops import online as online_mod
    wr, wi, taps, counts = weights
    B, N, F = sr.shape
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, None, :] * means[:, :, None]).contiguous()
    ins = [state.ring_r, state.ring_i, state.amp]
    outs = [torch.empty_like(t) for t in ins]
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    passes, color_k, rounds = online_mod._scheme(inner_passes, inner_scheme)
    Q, L = (wr.shape[1] + 1) // 2, (wr.shape[2] - 1) // 2
    LA = state.amp.shape[1] - 1
    ptrs = [t.data_ptr() for t in (sr, si, amp, thr, *ins, *outs, out_r, out_i, wr, wi,
                                   taps, counts)]
    err = lib.lws_online_chunk_launch(*ptrs, B, N, F, Q, L, LA, int(thresholds.shape[0]),
                                      passes, color_k, rounds, int(state.seen), int(n_live),
                                      _stream(sr))
    if err:
        raise RuntimeError(f"previous lws_online_chunk_launch failed ({err})")
    return out_r, out_i, online_mod.ChunkState(*outs, int(state.seen) + N)


def build_other(csrc: str):
    """nvcc of csrc/lws_online.cu with the port's flags into csrc; its
    ptxas report goes to csrc/lws_online_other.log."""
    from lws_torch.ops import _build
    out = os.path.join(csrc, "lws_online_other.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(csrc, "lws_online.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {csrc}:\n{proc.stderr}")
    with open(os.path.join(csrc, "lws_online_other.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(out)
    return lib if hasattr(lib, "lws_online_plan") else bind_legacy(lib)


def with_library(lib, fn):
    """fn() with the wrappers loading `lib` for csrc/lws_online.cu."""
    from lws_torch.ops import _build
    load = _build.load
    _build.load = {"lws_online": lib}.__getitem__
    try:
        return fn()
    finally:
        _build.load = load


def in_turns(names, reps):
    """other, current, current, other, ... over `reps` calls each."""
    others = [n for n in names if n != "current"]
    order = [n for _ in range(reps) for n in (*others, "current")]
    return order[:len(order) // 2] + order[len(order) // 2:][::-1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", action="append", default=[],
                    help="directory with another lws_online.cu and its headers (repeatable)")
    ap.add_argument("--reps", type=int, default=2, help="timed calls of each version")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("online_timing: needs a CUDA card", file=sys.stderr)
        return 2
    import lws_torch
    from chip_smoke import card_lines, make_batch
    from lws_torch.ops import online as online_mod
    from lws_torch.stft import frame_signal

    card_lines(torch)
    dev = torch.device("cuda")
    libs = {os.path.basename(os.path.normpath(d)): build_other(d) for d in args.old_csrc}
    names = ["current", *libs]
    order = in_turns(names, args.reps)
    ok = True

    # K3: the music path's online stage
    proc = lws_torch.LWS(1024, 256, mode="music", device=dev)
    x = make_batch(32, 80000, 16000, np.random.default_rng(1))
    sr, si = proc.stft_ri(x)
    amp = torch.sqrt(sr * sr + si * si)
    sr, si = (t.contiguous() for t in proc.nofuture_lws((amp, torch.zeros_like(amp))))
    thr = torch.as_tensor(lws_torch.get_thresholds(10, 1, 0.1, 1), dtype=torch.float32,
                          device=dev)
    sets = (proc._st_la, proc._st_nofuture, proc._st_af)
    legacy = legacy_weight_sets(*sets)
    LA = proc.look_ahead
    T, F = sr.shape[-2:]
    updates = T * (1 + 10) + 10 * sum(T - d for d in range(1, LA + 1))

    def k3(name):
        def new():
            return online_mod._launch(sr, si, *sets, thr, proc.inner_passes, proc.inner_scheme)
        if name == "current":
            return new()
        if hasattr(libs[name], "lws_online_plan"):
            return with_library(libs[name], new)
        return legacy_online(libs[name], legacy, sr, si, thr, LA, proc.inner_passes,
                             proc.inner_scheme)

    plan = online_mod.online_plan(F, proc._Qi, proc.L, LA,
                                  taps=online_mod.online_weights(*sets).dks.numel(),
                                  period=online_mod.online_weights(*sets).period)
    print(f"K3 music online stage {tuple(sr.shape)}, 10 rounds, LA={LA}, {updates} row "
          f"updates per CTA; plan {plan}", flush=True)
    ok &= timed(torch, names, order, k3, updates)

    # K4: the streaming run's 10 chunks
    sproc = lws_torch.LWS(512, 128, look_ahead=3, online_iterations=10, device=dev)
    B, block, n_frames = 8, 64, 640
    xs = make_batch(B, 80000, 16000, np.random.default_rng(5))
    live = -(-xs.shape[-1] // sproc.fshift)
    need = (n_frames - 1) * sproc.fshift + sproc.fsize
    xpad = torch.as_tensor(np.pad(xs, ((0, 0), (0, need - xs.shape[-1]))), device=dev)
    frames = frame_signal(xpad, sproc.fsize, sproc.fshift, n_frames) * torch.as_tensor(
        sproc.awin, dtype=torch.float32, device=dev)
    spec = torch.fft.rfft(frames, n=sproc.fftsize, dim=-1)
    fr, fi = spec.real.contiguous(), spec.imag.contiguous()
    fm = torch.sqrt(fr * fr + fi * fi).mean(dim=-1)
    means = torch.cumsum(fm, dim=1) / torch.arange(1, n_frames + 1, dtype=torch.float32,
                                                   device=dev)
    sthr = torch.as_tensor(lws_torch.get_thresholds(10, 1, 0.1, 1), dtype=torch.float32,
                           device=dev)
    ssets = (sproc._st_la, sproc._st_nofuture, sproc._st_af)
    slegacy = legacy_weight_sets(*ssets)
    s_updates = live * 11 + 10 * sum(live - d for d in range(1, 4))
    pieces = [(a, a + block, int(np.clip(live - a, 0, block))) for a in range(0, n_frames, block)]

    def k4(name):
        if name != "current" and hasattr(libs[name], "lws_online_plan"):
            return with_library(libs[name], lambda: k4("current"))
        state = online_mod.online_chunk_init(sproc._st_la, sproc._st_af, fr[:, 0], fi[:, 0])
        rows = []
        for a, b, n_live in pieces:
            args = (fr[:, a:b].contiguous(), fi[:, a:b].contiguous())
            if name == "current":
                r, i, state = online_mod._launch_chunk(
                    *args, state, means[:, a:b].contiguous(), *ssets, sthr, n_live,
                    sproc.inner_passes, sproc.inner_scheme)
            else:
                r, i, state = legacy_chunk(libs[name], slegacy, *args, state,
                                           means[:, a:b].contiguous(), sthr, n_live,
                                           sproc.inner_passes, sproc.inner_scheme)
            rows += [r, i]
        return rows + [state.ring_r, state.ring_i, state.amp]

    print(f"K4 streaming run ({B}, {n_frames}, {fr.shape[-1]}) in {len(pieces)} chunks of "
          f"{block}, {live} live frames, 10 rounds, LA=3, {s_updates} row updates per CTA",
          flush=True)
    ok &= timed(torch, names, order, k4, s_updates)
    return 0 if ok else 1


def timed(torch, names, order, fn, updates):
    """Run fn(name) (a list of output tensors) once each (warm-up), then in
    `order`, CUDA events around each call; print medians and compare every
    output with the current build's bit for bit. Returns whether all are
    equal."""
    times = {n: [] for n in names}
    outs = {}
    for name in names + order:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(name)
        b.record()
        b.synchronize()
        outs[name] = out
        times[name].append(a.elapsed_time(b))
    reps = len(order) // len(names)
    for name in names:
        ms = float(np.median(times[name][-reps:]))
        print(f"  {name}: {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in times[name][-reps:])})"
              f" -> {1e3 * ms / updates:.3f} us per row update", flush=True)
    ok = True
    for name in names[1:]:
        same = all(torch.equal(x, y) for x, y in zip(outs["current"], outs[name]))
        print(f"  current vs {name} output: {'bit-equal' if same else 'DIFFER'}", flush=True)
        ok &= same
    return ok


if __name__ == "__main__":
    sys.exit(main())
