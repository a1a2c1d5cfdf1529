#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, to rehearse them before a card run.

    python port_tools/cuda_on_cpu.py [--build-dir DIR] [--old-k1 REV]

Each lws_torch/csrc/*.cu is compiled by g++ (C++20) against a small shim of
the CUDA runtime: a block runs as one std::thread per CUDA thread,
__syncthreads() is a std::barrier, shared memory is a per-block buffer
filled with NaNs (so a read before a write shows), __ldg is a plain load,
rsqrtf is 1/sqrt and <<<...>>> launches run the blocks one after another.
The kernel's own wrappers (lws_torch.ops.lws_sweeps / lws_torch.ops.online)
then launch it on CPU tensors, and the results are held against the plain
versions in float32 at small shapes; the online kernels are also built in
double and held to the plain versions in float64, and the chunked one (K4),
chunked at (7, 1, rest) plus a drain chunk, to the whole-stage one (K3) bit
for bit. The grouped sweep kernel (K5) is held to its plain group update at
micro 2, 3 and 4 (float32, and float64 in the double build); at micro = 1
its wrapper launches K1. The sweep kernel K1 is also held bit for bit to
its previous design (lws_sweeps.cu at git revision REV, default d38e7e7:
one bin per thread, the window read from device memory), built the same
way, on the cases of k1_cases(): Q = 4 ip3 jacobi, the no-future stencil,
Q = 2 color2x3, halo= / mean_amp=, an F that is not a multiple of 32, 2
and 3 bins per thread (F = 1025, 2049), the run-time path at Q = 5 and 16
and with the window in device memory (F = 3073), the table kernel at Q = 8
(LWS(2048, 256)'s batch and no-future stencils at 2 bins per thread, F =
513 at 1), Q = 8 at P = F (the run-time path); Q = 32, which the previous
K1 did not take, against the plain version only. A previous K1 whose entry
point takes the weight planes alone runs through k1_timing.legacy_k1. Its
launch plan (lws_sweeps_plan) is held to the Python mirror
(ops.lws_sweeps.sweep_plan).
Agreement shows the kernel's indexing,
barriers and host arguments compute what the plain version computes; only
the card shows that nvcc builds it and that it is fast (chip_smoke.py).
A barrier that not every thread reaches hangs: run under `timeout`.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lws_torch  # noqa: E402
from lws_torch.ops import _build  # noqa: E402
from lws_torch.ops import lws_sweeps as sweeps_mod  # noqa: E402
from lws_torch.ops import online as online_mod  # noqa: E402
from lws_torch.ops import packed as packed_mod  # noqa: E402
from k1_timing import bind_legacy as bind_legacy_k1  # noqa: E402
from k1_timing import legacy_k1  # noqa: E402
from online_timing import (bind_legacy, legacy_chunk, legacy_online,  # noqa: E402
                           legacy_weight_sets)
from packed_timing import bind_legacy_packed, legacy_grouped  # noqa: E402

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float2 { float x, y; };
struct double2 { double x, y; };

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline float* cpu_smem = nullptr;
inline std::barrier<>* cpu_bar = nullptr;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 1;  // no card to ask: the blocks run one after another
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "no error"; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrtf(double x) { return 1.0 / std::sqrt(x); }
inline void __syncthreads() { cpu_bar->arrive_and_wait(); }

template <class K, class... A>
void cpu_launch(K kernel, dim3 grid, dim3 block, size_t smem_bytes, cudaStream_t, A... args) {
  gridDim = grid;
  blockDim = block;
  std::vector<float> smem(smem_bytes / sizeof(float) + 1);
  for (unsigned b = 0; b < grid.x; ++b) {
    std::fill(smem.begin(), smem.end(), NAN);
    cpu_smem = smem.data();
    std::barrier<> bar(block.x);
    cpu_bar = &bar;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([=] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
"""

LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.DOTALL)


def cpu_source(text: str, real: str) -> str:
    """The .cu / .cuh text rewritten for g++: every float a `real`, shared
    memory from the shim's block buffer, <<<grid, block, smem, stream>>> as
    cpu_launch(...). The double build scales the shared-memory limit by
    sizeof(double) / sizeof(float), so its launch plans, counted in
    elements, are the float build's."""
    if real == "double":
        text = text.replace("kSmemLimit = 232448;", "kSmemLimit = 2 * 232448;")
        text = re.sub(r"\bfloat2\b", "double2", text)
    text = re.sub(r"\bfloat\b", real, text)
    text = text.replace(f"extern __shared__ {real} smem[];",
                        f"{real}* smem = reinterpret_cast<{real}*>(cpu_smem);")
    return LAUNCH.sub(lambda m: f"cpu_launch({m.group(1)}, {m.group(2)}, {m.group(3)});",
                      text)


def build_cpu(name: str, out_dir: Path, real: str = "float", csrc: Path = _build.CSRC,
              tag: str = "") -> ctypes.CDLL:
    """g++ build of csrc/<name>.cu; real="double" builds it with every float
    a double, to check its schedule without float32 rounding. `csrc` and
    `tag` build another copy of the sources (a previous revision)."""
    src_dir = out_dir / (real + tag)
    shim_dir = out_dir / "shim"
    for d in (src_dir, shim_dir):
        d.mkdir(parents=True, exist_ok=True)
    (shim_dir / "cuda_runtime.h").write_text(SHIM)
    for header in csrc.glob("*.cuh"):
        (src_dir / header.name).write_text(cpu_source(header.read_text(), real))
    src = src_dir / f"{name}.cpp"
    src.write_text(cpu_source((csrc / f"{name}.cu").read_text(), real))
    lib = src_dir / f"{name}.so"
    cmd = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-ffp-contract=off",
           f"-I{shim_dir}", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"g++ failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def online_float64(lib, sr, si, st_la, st_ai, st_af, thresholds, passes, color_k, rounds):
    """The online kernel built in double, launched on float64 tensors with
    the wrapper's own weight table (in float64) and thresholds."""
    B, T, F = sr.shape
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, :] * amp.mean(dim=(-2, -1))[:, None]).contiguous()
    wt = online_mod.online_weight_sets(st_la, st_ai, st_af)
    table = wt.table.double()
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    ring = [torch.empty((B, len(st_la) + st_af.Q, F), dtype=torch.float64) for _ in range(2)]
    ptrs = [t.data_ptr() for t in (sr, si, amp, out_r, out_i, table, wt.rows, wt.dks, thr,
                                   *ring)]
    lib.lws_online_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    err = lib.lws_online_launch(*ptrs, B, T, F, st_af.Q, st_af.L, len(st_la),
                                thresholds.shape[0], passes, color_k, rounds,
                                wt.dks.numel(), wt.period, None)
    assert err == 0, err
    return out_r, out_i


def chunk_float64(lib, sr, si, state, means, st_la, st_ai, st_af, thresholds, n_live,
                  passes, color_k, rounds):
    """K4 built in double, launched on float64 tensors with the wrapper's
    own amp, thresholds and weight table (in float64)."""
    B, N, F = sr.shape
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, None, :] * means[:, :, None]).contiguous()
    wt = online_mod.online_weight_sets(st_la, st_ai, st_af)
    table = wt.table.double()
    ins = [state.ring_r, state.ring_i, state.amp]
    outs = [torch.empty_like(t) for t in ins]
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    ptrs = [t.data_ptr() for t in (sr, si, amp, thr, *ins, *outs, out_r, out_i, table,
                                   wt.rows, wt.dks)]
    lib.lws_online_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 12
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    err = lib.lws_online_chunk_launch(*ptrs, B, N, F, st_af.Q, st_af.L, len(st_la),
                                      thresholds.shape[0], passes, color_k, rounds,
                                      wt.dks.numel(), wt.period, state.seen, n_live, None)
    assert err == 0, err
    return out_r, out_i, online_mod.ChunkState(*outs, state.seen + N)


def grouped_float64(lib, sr, si, st, thresholds, micro, inner_passes, halo=None, mean=None):
    """K5 built in double, launched at micro > 1 (jacobi passes) on float64
    tensors with the wrapper's own padded state, schedule and weight table
    (in float64), and room for the largest scratch."""
    B, T, F = sr.shape
    Q1 = st.Q - 1
    amp, thr, live = sweeps_mod.sweep_schedule(sr, si, thresholds, mean)
    planes = []
    for s, top, bot in ((sr, 0, 2), (si, 1, 3)):
        edges = ((s[:, :1].expand(B, Q1, F), s[:, -1:].expand(B, Q1, F)) if halo is None
                 else (halo[top], halo[bot]))
        planes.append(torch.cat([edges[0], s, edges[1]], 1).contiguous())
    wt = online_mod.weight_table([st])
    plan = packed_mod.packed_plan(F, st.Q, st.L, min(micro, T), wt.dks.numel(), wt.period)
    scratch = torch.empty((B, plan.slots * plan.width + (min(micro, T) + 1) * 3 * F * 2, 2),
                          dtype=torch.float64)
    lib.lws_packed_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    ptrs = [t.data_ptr() for t in (*planes, amp, wt.table, wt.rows, wt.dks, thr.contiguous(),
                                   live, scratch)]
    passes = max(1, inner_passes) if st.has_centre else 1
    err = lib.lws_packed_launch(*ptrs, B, T, F, st.Q, st.L, thresholds.shape[0], micro,
                                passes, int(st.has_centre), wt.dks.numel(), wt.period, None)
    assert err == 0, err
    return planes[0][:, Q1:Q1 + T], planes[1][:, Q1:Q1 + T]


def chunked(step, sr, si, proc, thr, fixed_mean):
    """Run `step` (K4 or its plain version) over (sr, si) chunked at (7, 1,
    rest), then one drain chunk of LA frames; returns the committed rows of
    the input's frames and the final state. The threshold scale is the
    running mean of |frame| (fixed_mean: the whole-input mean, as K3's)."""
    B, T, F = sr.shape
    LA = proc.look_ahead
    amp = torch.sqrt(sr * sr + si * si)
    if fixed_mean:
        means = amp.mean(dim=(-2, -1))[:, None].expand(B, T + LA)
    else:
        fm = torch.cat([amp.mean(dim=-1), torch.zeros((B, LA), dtype=sr.dtype)], dim=1)
        means = torch.cumsum(fm, dim=1) / torch.arange(1, T + LA + 1, dtype=sr.dtype)
    state = online_mod.online_chunk_init(proc._st_la, proc._st_af, sr[:, 0], si[:, 0])
    z = torch.zeros((B, LA, F), dtype=sr.dtype)
    rows_r, rows_i = [], []
    for a, b, r, i in ((0, 7, sr[:, :7], si[:, :7]), (7, 8, sr[:, 7:8], si[:, 7:8]),
                       (8, T, sr[:, 8:], si[:, 8:]), (T, T + LA, z, z)):
        if b > a:
            n_live = b - a if b <= T else 0
            cr, ci, state = step(r.contiguous(), i.contiguous(), state,
                                 means[:, a:b].contiguous(), n_live)
            rows_r.append(cr)
            rows_i.append(ci)
    return (torch.cat(rows_r, 1)[:, LA:], torch.cat(rows_i, 1)[:, LA:]), state


def random_phase(proc, frames, rng, B=2):
    t = np.arange(16000) / 16000.0
    x = np.stack([0.5 * np.sin(2 * np.pi * (200 + 90 * i) * t)
                  + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t) * t)
                  + 0.05 * rng.standard_normal(t.size) for i in range(B)])
    A = np.abs(proc.stft(x))[:, :frames]
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    return (A, torch.tensor(S.real, dtype=torch.float32),
            torch.tensor(S.imag, dtype=torch.float32))


def old_sources(rev: str, out_dir: Path, name: str = "lws_sweeps") -> Path:
    """csrc/<name>.cu and the headers it includes at git revision `rev`,
    written to out_dir/csrc_<name>_<rev>."""
    dest = out_dir / f"csrc_{name}_{rev}"
    dest.mkdir(parents=True, exist_ok=True)
    for path in _build.sources(name):
        rel = path.relative_to(ROOT).as_posix()
        text = subprocess.run(["git", "-C", str(ROOT), "show", f"{rev}:{rel}"],
                              capture_output=True, text=True, check=True).stdout
        (dest / path.name).write_text(text)
    return dest


# K1's cases: (label, LWS arguments, schedule, frames, halo / mean_amp,
# compare with the previous K1). "batch": 3 dense sweeps of the batch
# stencil; "dead": the same with the middle sweep's threshold above every
# bin (skipped, so the next sweep reloads the window); "nofuture": one
# sweep of the v=-1 stencil. F = 3073 takes the run-time path with the
# window in device memory; Q = 32 is past the previous K1's cap. Q = 8 with
# summarized weights (P = Q) takes the table kernel; use_simplifications=False
# gives the same geometry per-bin weights (P = F), the run-time path.
K1_CASES = (
    ("Q=4 ip3 jacobi F=257", dict(awin_or_fsize=512, fshift=128), "batch", 20, False, True),
    ("no-future v=-1 F=257", dict(awin_or_fsize=512, fshift=128), "nofuture", 20, False, True),
    ("Q=2 color2x3 F=129", dict(awin_or_fsize=256, fshift=128), "batch", 20, False, True),
    ("Q=4 halo= mean_amp= F=257", dict(awin_or_fsize=512, fshift=128), "batch", 20, True, True),
    ("Q=4 dead middle sweep F=257", dict(awin_or_fsize=512, fshift=128), "dead", 20, False,
     True),
    ("Q=4 F=513, weights partly staged", dict(awin_or_fsize=1024, fshift=256), "batch", 16,
     False, True),
    ("Q=5 (run-time path) F=289", dict(awin_or_fsize=576, fshift=128), "batch", 20, False, True),
    ("Q=4 F=1025, 2 bins per thread", dict(awin_or_fsize=2048, fshift=512), "batch", 12, False,
     True),
    ("Q=4 F=2049, 3 bins per thread", dict(awin_or_fsize=4096, fshift=1024), "batch", 10, False,
     True),
    ("Q=4 no-future F=2049", dict(awin_or_fsize=4096, fshift=1024), "nofuture", 10, False, True),
    ("Q=2 color2x3 F=2049, 3 bins per thread", dict(awin_or_fsize=4096, fshift=2048), "dead",
     10, False, True),
    ("Q=8 (table kernel) F=1025, 2 bins per thread", dict(awin_or_fsize=2048, fshift=256),
     "batch", 10, False, True),
    ("Q=16 (run-time path) F=513", dict(awin_or_fsize=1024, fshift=64), "batch", 12, True, True),
    ("Q=4 F=3073, window in device memory", dict(awin_or_fsize=6144, fshift=1536), "batch", 8,
     False, True),
    ("Q=32 L=3 F=129", dict(awin_or_fsize=256, fshift=8, L=3), "batch", 20, False, False),
    ("Q=8 no-future (table kernel) F=1025", dict(awin_or_fsize=2048, fshift=256), "nofuture",
     10, False, True),
    ("Q=8 P=F (run-time path) F=1025",
     dict(awin_or_fsize=2048, fshift=256, use_simplifications=False), "batch", 10, False, True),
    ("Q=8 (table kernel) F=513, 1 bin per thread, halo= mean_amp=",
     dict(awin_or_fsize=1024, fshift=128), "batch", 12, True, True),
)


def sweeps_float64(lib, sr, si, st, thresholds, inner_passes, inner_scheme, halo, mean):
    """K1 built in double, launched on float64 tensors with the wrapper's
    own padded state, schedule and launch arguments (the weight table where
    the plan picks the table kernel)."""
    B, T, F = sr.shape
    Q1 = st.Q - 1
    amp, thr, live = sweeps_mod.sweep_schedule(sr, si, thresholds, mean)
    planes = []
    for s, top, bot in ((sr, 0, 2), (si, 1, 3)):
        edges = ((s[:, :1].expand(B, Q1, F), s[:, -1:].expand(B, Q1, F)) if halo is None
                 else (halo[top], halo[bot]))
        planes.append(torch.cat([edges[0], s, edges[1]], 1).contiguous())
    lib.lws_sweeps_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    if sweeps_mod.stencil_plan(F, st).table:
        wt = packed_mod.packed_weights(st)
        weights = (None, None, wt.table.data_ptr(), wt.rows.data_ptr(), wt.dks.data_ptr())
    else:
        weights = (st.Wr.data_ptr(), st.Wi.data_ptr(), None, None, None)
    ptrs = [*(t.data_ptr() for t in (*planes, amp)), *weights,
            *(t.data_ptr() for t in (thr.contiguous(), live))]
    sched = (*sweeps_mod._schedule_args(st, inner_passes, inner_scheme), int(st.nz.sum()),
             st.period)
    err = lib.lws_sweeps_launch(*ptrs, B, T, F, st.Q, st.L, thresholds.shape[0], *sched, None)
    assert err == 0, err
    return planes[0][:, Q1:Q1 + T], planes[1][:, Q1:Q1 + T]


def k1_cases(old_lib, new_lib, lib64, rng):
    """Each K1 case through the wrapper on the new kernel, the previous one
    (where it takes the case) and the plain version; then the new kernel
    built in double against the plain version in float64, where the
    agreement does not depend on how well the input is conditioned.
    Returns (worst float32 vs plain, worst float64 vs plain, both / max amp,
    every compared case bit-equal)."""
    worst, worst64, equal = 0.0, 0.0, True
    tables = sweeps_mod.TABLE_LAUNCHES
    dense = torch.tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-3:], dtype=torch.float32)
    dead = dense.clone()
    dead[1] = 1e9
    nofuture = torch.tensor(lws_torch.get_thresholds(1, 1, 0.1, 1), dtype=torch.float32)
    for label, kw, stage, frames, edges, compare in K1_CASES:
        proc = lws_torch.LWS(**kw, device="cpu")
        A, sr, si = random_phase(proc, frames, rng)
        if stage == "nofuture":
            sched = (proc._st_nofuture, nofuture, 1, "jacobi")
        else:
            sched = (proc._st_batch, dense if stage == "batch" else dead,
                     proc.batch_inner_passes, proc.inner_scheme)
        B, T, F = sr.shape
        halo = mean = None
        if edges:
            Q1, scale = proc._Qi - 1, float(np.abs(A).mean())
            halo = tuple(torch.tensor(rng.standard_normal((B, Q1, F)) * scale,
                                      dtype=torch.float32) for _ in range(4))
            mean = torch.tensor(rng.uniform(0.5, 2.0, B) * scale, dtype=torch.float32)
        plan = sweeps_mod.stencil_plan(F, sched[0])
        _build.load = {"lws_sweeps": new_lib}.__getitem__
        k = sweeps_mod._launch(sr, si, *sched, halo, mean)
        p = sweeps_mod.tiled_lws_sweeps(sr, si, *sched, halo, mean, backend="torch")
        kind = "table" if plan.table else "fixed" if plan.fixed else "run-time"
        worst = max(worst, report(
            f"K1 {label} {stage} {tuple(sr.shape)} ({plan.bins} bins x {plan.threads} "
            f"threads, ring {plan.ring}, {plan.staged}/{plan.taps} taps staged, "
            f"{kind} kernel, {plan.bytes} B)", k, p, A))
        if compare:
            o = legacy_k1(old_lib, sr, si, *sched, halo, mean)
            same = torch.equal(k[0], o[0]) and torch.equal(k[1], o[1])
            equal = equal and same
            print(f"  vs the previous K1: {'bit-equal' if same else 'DIFFER'}", flush=True)
        proc64 = lws_torch.LWS(**kw, device="cpu", dtype=torch.float64)
        st64 = proc64._st_batch if stage != "nofuture" else proc64._st_nofuture
        args64 = (sr.double(), si.double(), st64, sched[1].double(), *sched[2:],
                  None if halo is None else tuple(h.double() for h in halo),
                  None if mean is None else mean.double())
        k64 = sweeps_float64(lib64, *args64)
        p64 = sweeps_mod.tiled_lws_sweeps(*args64, backend="torch")
        worst64 = max(worst64, report("  float64 build vs plain float64", k64, p64, A))
    print(f"K1 table kernel launches: {sweeps_mod.TABLE_LAUNCHES - tables}", flush=True)
    return worst, worst64, equal


def plan_matches(lib):
    """lws_sweeps_plan against ops.lws_sweeps.sweep_plan on a table of
    geometries."""
    _build.load = {"lws_sweeps": lib}.__getitem__
    ok = True
    for F in (6, 129, 257, 289, 513, 1025, 1525, 1526, 1533, 1534, 2049, 3073, 16385):
        for Q, L in ((4, 5), (2, 5), (5, 5), (8, 5), (16, 5), (32, 3), (1, 0)):
            if F < L + 1:
                continue
            for period, taps in ((None, None), (Q, 148), (Q, None)):
                mirror = sweeps_mod.sweep_plan(F, Q, L, period, taps)
                built = sweeps_mod.kernel_plan(F, Q, L, period, taps)
                if mirror != built:
                    ok = False
                    print(f"plan F={F} Q={Q} L={L} P={period} G={taps}: kernel {built} != "
                          f"mirror {mirror}")
    print(f"K1 launch plan, kernel vs Python mirror: {'equal' if ok else 'DIFFER'}", flush=True)
    return ok


def bit_equal(what, new, old):
    same = all(torch.equal(a, b) for a, b in zip(new, old))
    print(f"{what}: {'bit-equal' if same else 'DIFFER'}", flush=True)
    return same


def online_plan_matches():
    """lws_online_plan against ops.online.online_plan on a table of
    geometries and tables."""
    ok = True
    for F in (6, 129, 257, 513, 1025, 2049, 4097, 8193, 16385):
        for Q, L, LA in ((4, 5, 3), (4, 5, 0), (8, 5, 3), (32, 3, 3), (4, 5, 10), (2, 5, 3)):
            if F < L + 1:
                continue
            for chunk in (False, True):
                for taps, period in ((None, None), (216, Q), (216, F)):
                    mirror = online_mod.online_plan(F, Q, L, LA, chunk, taps, period)
                    built = online_mod.kernel_plan(F, Q, L, LA, chunk, taps, period)
                    if mirror != built:
                        ok = False
                        print(f"online plan F={F} Q={Q} L={L} LA={LA} chunk={chunk} taps={taps} "
                              f"P={period}: kernel {built} != mirror {mirror}")
    print(f"K3 / K4 launch plan, kernel vs Python mirror: {'equal' if ok else 'DIFFER'}",
          flush=True)
    return ok


# Geometries the previous K3 / K4 refused, then the compile-time kernel at
# 2 and 3 bins per thread (which the previous ones took: held to them bit
# for bit too): (label, LWS arguments, frames, rounds, compare with the
# previous K3 / K4). F = 2049 at Q = 8 is LWS(4096, 512, mode="music")'s online stage;
# Q = 32 reads its table from device memory; F = 8193 keeps the ring in
# device memory (seeded random magnitudes: a 1 s clip has 7 frames there;
# the others use random_phase); LWS(1000, 256) has per-bin (fractional)
# weights, P = F.
NEW_GEOMETRIES = (
    ("Q=8 F=2049", dict(awin_or_fsize=4096, fshift=512), 10, 1, False),
    ("Q=32 L=3 F=129", dict(awin_or_fsize=256, fshift=8, L=3), 12, 2, False),
    ("LA=10 F=257", dict(awin_or_fsize=512, fshift=128, look_ahead=10), 16, 2, False),
    ("F=8193, ring in device memory", dict(awin_or_fsize=16384, fshift=4096), 10, 1, False),
    ("fractional weights F=501", dict(awin_or_fsize=1000, fshift=256), 12, 2, False),
    ("Q=4 F=1025, 2 bins per thread", dict(awin_or_fsize=2048, fshift=512), 10, 1, True),
    ("Q=4 F=2049, 3 bins per thread", dict(awin_or_fsize=4096, fshift=1024), 10, 1, True),
)


# Float32 kernel-vs-plain comparisons of a dense online run hold its first
# frames bin by bin (chip_smoke.py's ONLINE_EARLY_FRAMES): later frames
# carry the commit chain's amplified rounding, which the float64 build's
# whole-run agreement rules out as a fault.
EARLY_FRAMES = 6


def random_spec(F, frames, rng, B=2, dtype=torch.float32):
    """Seeded random magnitudes and phases (B, frames, F)."""
    A = rng.uniform(0.1, 1.0, (B, frames, F))
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    return A, torch.tensor(S.real, dtype=dtype), torch.tensor(S.imag, dtype=dtype)


def new_geometries(lib64, old_online, rng):
    """K3 and K4 (chunked, running mean) against their plain versions at
    the geometries of NEW_GEOMETRIES: float32 through the wrappers (and
    against the previous K3 / K4 where flagged), then the double build
    against the plain version in float64. Returns the worst of each, / max
    amp, and whether every compared case was bit-equal."""
    worst, worst64, equal = 0.0, 0.0, True
    for label, kw, frames, iters, compare in NEW_GEOMETRIES:
        for dtype in (torch.float32, torch.float64):
            proc = lws_torch.LWS(**kw, device="cpu", dtype=dtype)
            F = proc.fftsize // 2 + 1
            if kw["awin_or_fsize"] > 16000:  # a 1 s clip holds too few frames
                A, sr, si = random_spec(F, frames, rng, dtype=dtype)
            else:
                A, sr, si = random_phase(proc, frames, rng)
                sr, si = sr.to(dtype), si.to(dtype)
            thr = torch.tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1), dtype=dtype)
            on = (proc._st_la, proc._st_nofuture, proc._st_af, thr)
            sch = (proc.inner_passes, proc.inner_scheme)
            wt = online_mod.online_weight_sets(*on[:3])
            plan = online_mod.online_plan(F, proc._Qi, proc.L, proc.look_ahead, True,
                                          wt.dks.numel(), wt.period)
            head = (f"{label} (Q={proc._Qi}, LA={proc.look_ahead}, P={wt.period}, "
                    f"{wt.dks.numel()} live taps; K4 plan: ring {plan.ring}, table "
                    f"{plan.table}, amp rows {plan.amp}, {plan.bins} bins x {plan.threads})")
            if dtype == torch.float32:
                k3 = online_mod._launch(sr, si, *on, *sch)

                def k4(r, i, st, means, n_live):
                    return online_mod._launch_chunk(r, i, st, means, *on, n_live, *sch)
                if compare:
                    legacy = legacy_weight_sets(*on[:3])

                    def old_k4(r, i, st, means, n_live):
                        return legacy_chunk(old_online, legacy, r, i, st, means, thr, n_live,
                                            *sch)
                    equal &= bit_equal(f"{label}: K3 vs the previous K3", k3, legacy_online(
                        old_online, legacy, sr, si, thr, proc.look_ahead, *sch))
                    equal &= bit_equal(f"{label}: K4 chunked vs the previous K4",
                                       chunked(k4, sr, si, proc, thr, False)[0],
                                       chunked(old_k4, sr, si, proc, thr, False)[0])
            else:
                passes, color_k, rounds = online_mod._scheme(*sch)
                k3 = online_float64(lib64, sr, si, *on, passes, color_k, rounds)

                def k4(r, i, st, means, n_live):
                    return chunk_float64(lib64, r, i, st, means, *on, n_live, passes,
                                         color_k, rounds)

            def plain(r, i, st, means, n_live):
                return online_mod.online_chunk(r, i, st, means, *on, n_live, *sch)

            p3 = online_mod.packed_rtisi_la(sr, si, *on, *sch, backend="torch")
            k, _ = chunked(k4, sr, si, proc, thr, False)
            p, _ = chunked(plain, sr, si, proc, thr, False)
            tag = "float64 build"
            if dtype == torch.float32:
                # the commit chain amplifies float32 rounding: first frames only
                tag = f"float32 (first {EARLY_FRAMES} frames)"
                k3, p3, k, p = ((r[:, :EARLY_FRAMES], i[:, :EARLY_FRAMES])
                                for r, i in (k3, p3, k, p))
            d = max(report(f"{tag} K3 {head} {tuple(sr.shape)}", k3, p3, A),
                    report(f"  {tag} K4 chunked, running mean", k, p, A))
            if dtype == torch.float32:
                worst = max(worst, d)
            else:
                worst64 = max(worst64, d)
    print(f"newly covered geometries, worst vs plain: float32 {worst:.3e}, float64 "
          f"{worst64:.3e}", flush=True)
    return worst, worst64, equal


def report(what, k, p, A):
    d = max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()))
    print(f"{what}: max|cpu-built kernel - plain| / max amp {d / A.max():.3e}", flush=True)
    return d / A.max()


# K5's cases: (label, LWS arguments, stage, frames, micro, halo / mean_amp,
# compare with the previous K5). "batch": 2 dense sweeps of the batch
# stencil (3 jacobi passes at Q = 4, 1 at Q = 2); "nofuture": one sweep of
# the v=-1 stencil (no centre row). Frame counts leave a ragged last group
# unless noted. The previous K5 refused micro x F past 9,686 (its shared
# memory), so F = 2049 at micro 5 is held to the plain version only.
K5_CASES = (
    ("Q=4 F=257 micro 2, 1 element per thread", dict(awin_or_fsize=512, fshift=128), "batch",
     23, 2, False, True),
    ("Q=4 F=257 micro 3, 2 elements per thread", dict(awin_or_fsize=512, fshift=128), "batch",
     23, 3, False, True),
    ("Q=4 F=257 micro 4, 2 elements per thread", dict(awin_or_fsize=512, fshift=128), "batch",
     23, 4, False, True),
    ("Q=4 F=257 micro 4, whole groups", dict(awin_or_fsize=512, fshift=128), "batch", 24, 4,
     False, True),
    ("no-future F=257 micro 2", dict(awin_or_fsize=512, fshift=128), "nofuture", 23, 2, False,
     True),
    ("no-future F=257 micro 4", dict(awin_or_fsize=512, fshift=128), "nofuture", 22, 4, False,
     True),
    ("Q=4 F=257 micro 4, halo= mean_amp=", dict(awin_or_fsize=512, fshift=128), "batch", 21, 4,
     True, True),
    ("Q=4 F=257 micro 8 > T", dict(awin_or_fsize=512, fshift=128), "batch", 6, 8, False, True),
    ("Q=4 F=513 micro 4, 3 elements per thread", dict(awin_or_fsize=1024, fshift=256), "batch",
     14, 4, False, True),
    ("Q=4 F=513 micro 2, 2 elements of one bin per thread", dict(awin_or_fsize=1024, fshift=256),
     "batch", 13, 2, False, True),
    ("Q=2 color2x3 F=129 micro 3 (run-time kernel)", dict(awin_or_fsize=256, fshift=128),
     "batch", 22, 3, False, True),
    ("fractional weights F=289 micro 2 (run-time kernel, P = F)",
     dict(awin_or_fsize=576, fshift=128), "batch", 21, 2, False, True),
    ("Q=4 F=1025 micro 5 (run-time kernel, 7 elements per thread)",
     dict(awin_or_fsize=2048, fshift=512), "batch", 12, 5, False, True),
    ("Q=16 F=513 micro 2 (run-time kernel), halo= mean_amp=",
     dict(awin_or_fsize=1024, fshift=64), "batch", 11, 2, True, True),
    ("Q=4 no-future F=2049 micro 5 (ring in device memory)",
     dict(awin_or_fsize=4096, fshift=1024), "nofuture", 11, 5, False, False),
    ("Q=4 F=2049 micro 5 (ring in device memory)", dict(awin_or_fsize=4096, fshift=1024),
     "batch", 11, 5, False, False),
)


def k5_cases(old_lib, lib64, rng):
    """Each K5 case through the wrapper (ops.packed.launch_grouped) on the
    new kernel, the previous one (where it takes the case) and the plain
    version; then the new kernel built in double against the plain version
    in float64. Returns (worst float32 vs plain, worst float64 vs plain,
    both / max amp, every compared case bit-equal)."""
    worst, worst64, equal = 0.0, 0.0, True
    dense = torch.tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-2:], dtype=torch.float32)
    nofuture = torch.tensor(lws_torch.get_thresholds(1, 1, 0.1, 1), dtype=torch.float32)
    for label, kw, stage, frames, micro, edges, compare in K5_CASES:
        proc = lws_torch.LWS(**kw, device="cpu")
        F = proc.fftsize // 2 + 1
        if F > 1025:  # a 1 s clip holds too few frames
            A, sr, si = random_spec(F, frames, rng)
        else:
            A, sr, si = random_phase(proc, frames, rng)
        st, th = ((proc._st_nofuture, nofuture) if stage == "nofuture"
                  else (proc._st_batch, dense))
        ip = proc.batch_inner_passes if stage == "batch" else 1
        B, T, F = sr.shape
        halo = mean = None
        if edges:
            Q1, scale = proc._Qi - 1, float(np.abs(A).mean())
            halo = tuple(torch.tensor(rng.standard_normal((B, Q1, F)) * scale,
                                      dtype=torch.float32) for _ in range(4))
            mean = torch.tensor(rng.uniform(0.5, 2.0, B) * scale, dtype=torch.float32)
        wt = packed_mod.packed_weights(st)
        plan = packed_mod.packed_plan(F, st.Q, st.L, min(micro, T), wt.dks.numel(), wt.period)
        k = packed_mod.launch_grouped(sr, si, st, th, micro, ip, halo, mean)
        p = sweeps_mod.tiled_lws_sweeps(sr, si, st, th, ip, proc.inner_scheme, halo, mean,
                                        backend="torch", micro=micro)
        worst = max(worst, report(
            f"K5 {label} {stage} {tuple(sr.shape)} (P={wt.period}, {wt.dks.numel()} live "
            f"taps; {plan.bins} elements x {plan.threads} threads, ring / table / centre / "
            f"sums in shared memory {plan.ring:d}{plan.table:d}{plan.centre:d}{plan.sums:d}, "
            f"{'fixed' if plan.fixed else 'run-time'} kernel)", k, p, A))
        if compare:
            o = legacy_grouped(old_lib, sr, si, st, th, micro, ip, halo, mean)
            same = torch.equal(k[0], o[0]) and torch.equal(k[1], o[1])
            equal = equal and same
            print(f"  vs the previous K5: {'bit-equal' if same else 'DIFFER'}", flush=True)
        proc64 = lws_torch.LWS(**kw, device="cpu", dtype=torch.float64)
        st64 = proc64._st_nofuture if stage == "nofuture" else proc64._st_batch
        args64 = (sr.double(), si.double(), st64, th.double())
        h64 = None if halo is None else tuple(h.double() for h in halo)
        m64 = None if mean is None else mean.double()
        k64 = grouped_float64(lib64, *args64, micro, ip, h64, m64)
        p64 = sweeps_mod.tiled_lws_sweeps(*args64, ip, proc.inner_scheme, h64, m64,
                                          backend="torch", micro=micro)
        worst64 = max(worst64, report("  float64 build vs plain float64", k64, p64, A))
    return worst, worst64, equal


def packed_plan_matches():
    """lws_packed_plan against ops.packed.packed_plan on a table of
    geometries and tables."""
    ok = True
    for F in (6, 129, 257, 513, 1025, 2049, 8193, 16385):
        for Q, L in ((4, 5), (2, 5), (16, 5), (8, 3)):
            if F < L + 1:
                continue
            for micro in (1, 2, 3, 4, 5, 64):
                for taps, period in ((None, None), (66, Q), (77, F)):
                    mirror = packed_mod.packed_plan(F, Q, L, micro, taps, period)
                    built = packed_mod.kernel_plan(F, Q, L, micro, taps, period)
                    if mirror != built:
                        ok = False
                        print(f"K5 plan F={F} Q={Q} L={L} micro={micro} taps={taps} "
                              f"P={period}: kernel {built} != mirror {mirror}")
    print(f"K5 launch plan, kernel vs Python mirror: {'equal' if ok else 'DIFFER'}", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", default=None,
                    help="where the g++ builds go (default: a temporary directory)")
    ap.add_argument("--old-k1", default="d38e7e7",
                    help="git revision of the previous K1 to hold the new one to bit for bit")
    ap.add_argument("--old-packed", default="b1968d1",
                    help="git revision of the previous K5 (per-bin weight planes, state in "
                         "device memory) to hold the new one to bit for bit")
    ap.add_argument("--old-online", default="4c91317",
                    help="git revision of the previous K3 / K4 (per-bin weight planes) to "
                         "hold the new ones to bit for bit")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.build_dir or tmp)
        libs = {n: build_cpu(n, out) for n in ("lws_sweeps", "lws_online")}
        old_k1 = bind_legacy_k1(build_cpu("lws_sweeps", out,
                                          csrc=old_sources(args.old_k1, out), tag="_old"))
        old_online = bind_legacy(build_cpu(
            "lws_online", out, csrc=old_sources(args.old_online, out, "lws_online"),
            tag="_old_online"))
        torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)

        # K1: the plan, then each case against the previous K1 and the plain
        # version (inputs from their own generator)
        plan_ok = plan_matches(libs["lws_sweeps"])
        lib_sw64 = build_cpu("lws_sweeps", out, "double")
        worst_k1, worst_k1_64, k1_equal = k1_cases(old_k1, libs["lws_sweeps"], lib_sw64,
                                                   np.random.default_rng(7))
        print(f"worst K1 vs plain: float32 {worst_k1:.3e}, float64 {worst_k1_64:.3e}; "
              f"previous K1 {'bit-equal on every case' if k1_equal else 'DIFFERS'}")
        _build.load = libs.__getitem__  # the wrappers' _library() loads these
        online_plan_ok = online_plan_matches()
        rng = np.random.default_rng(0)
        worst, old_equal = 0.0, True
        for fsize, fshift, la, iters in ((512, 128, 3, 2), (256, 128, 3, 2),
                                         (512 + 64, 128, 2, 2), (1024, 256, 3, 1),
                                         (512, 128, 0, 1)):
            proc = lws_torch.LWS(fsize, fshift, look_ahead=la, device="cpu")
            A, sr, si = random_phase(proc, 20, rng)
            thr = torch.tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1), dtype=torch.float32)
            on = (proc._st_la, proc._st_nofuture, proc._st_af, thr)
            legacy = legacy_weight_sets(*on[:3])
            for ip in sorted({proc.inner_passes, 2}):
                k = online_mod._launch(sr, si, *on, ip, proc.inner_scheme)
                p = online_mod.packed_rtisi_la(sr, si, *on, ip, proc.inner_scheme,
                                               backend="torch")
                worst = max(worst, report(
                    f"online LWS({fsize}, {fshift}) LA={la} {iters} rounds "
                    f"{proc.inner_scheme} passes={ip} {tuple(sr.shape)}", k, p, A))
                o = legacy_online(old_online, legacy, sr, si, thr, la, ip, proc.inner_scheme)
                old_equal &= bit_equal("  vs the previous K3", k, o)
            dense = torch.tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-2:],
                                 dtype=torch.float32)
            for st, ip, scheme, th in ((proc._st_batch, proc.batch_inner_passes,
                                        proc.inner_scheme, dense),
                                       (proc._st_nofuture, 1, "jacobi", thr[:1])):
                k = sweeps_mod._launch(sr, si, st, th, ip, scheme, None, None)
                p = sweeps_mod.tiled_lws_sweeps(sr, si, st, th, ip, scheme, backend="torch")
                worst = max(worst, report(
                    f"sweeps LWS({fsize}, {fshift}) v={'batch' if st is proc._st_batch else -1} "
                    f"{scheme} passes={ip}", k, p, A))
        print(f"worst float32 {worst:.3e}")

        # K4: chunked, against its plain version (running mean) and against
        # K3 (fixed mean, bit for bit), float32
        worst_chunk, k3_equal = 0.0, True
        for fsize, fshift, la, iters in ((512, 128, 3, 2), (256, 128, 3, 2),
                                         (512 + 64, 128, 2, 2), (512, 128, 0, 1)):
            proc = lws_torch.LWS(fsize, fshift, look_ahead=la, device="cpu")
            A, sr, si = random_phase(proc, 20, rng)
            thr = torch.tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1), dtype=torch.float32)
            on = (proc._st_la, proc._st_nofuture, proc._st_af, thr)
            sch = (proc.inner_passes, proc.inner_scheme)

            def k4(r, i, st, means, n_live):
                return online_mod._launch_chunk(r, i, st, means, *on, n_live, *sch)

            def plain(r, i, st, means, n_live):
                return online_mod.online_chunk(r, i, st, means, *on, n_live, *sch)

            legacy = legacy_weight_sets(*on[:3])

            def old_k4(r, i, st, means, n_live):
                return legacy_chunk(old_online, legacy, r, i, st, means, thr, n_live, *sch)

            (kr, ki), kst = chunked(k4, sr, si, proc, thr, False)
            (pr, pi), pst = chunked(plain, sr, si, proc, thr, False)
            (orr, ori), ost = chunked(old_k4, sr, si, proc, thr, False)
            old_equal &= bit_equal("  K4 chunked, running mean, vs the previous K4",
                                   (kr, ki, *kst[:3]), (orr, ori, *ost[:3]))
            d = report(f"chunked online LWS({fsize}, {fshift}) LA={la} {iters} rounds "
                       f"{proc.inner_scheme}, running mean", (kr, ki), (pr, pi), A)
            ds = report("  its final state", kst[:2], pst[:2], A)
            worst_chunk = max(worst_chunk, d, ds)
            (fr, fi), _ = chunked(k4, sr, si, proc, thr, True)
            old_equal &= bit_equal("  K4 chunked, fixed mean, vs the previous K4", (fr, fi),
                                   chunked(old_k4, sr, si, proc, thr, True)[0])
            k3 = online_mod._launch(sr, si, *on, *sch)
            same = torch.equal(fr, k3[0]) and torch.equal(fi, k3[1])
            k3_equal = k3_equal and same
            print(f"  K4 chunked (fixed mean) vs K3: {'bit-equal' if same else 'DIFFER'}",
                  flush=True)
        print(f"worst float32 chunked {worst_chunk:.3e}")

        # the online kernel's schedule in double: agreement to float64 rounding
        lib64 = build_cpu("lws_online", out, "double")
        worst64 = 0.0
        for fsize, fshift, la in ((512, 128, 3), (256, 128, 3), (512 + 64, 128, 2)):
            proc = lws_torch.LWS(fsize, fshift, look_ahead=la, device="cpu",
                                 dtype=torch.float64)
            A, sr, si = random_phase(proc, 20, rng)
            sr, si = sr.double(), si.double()
            thr = torch.tensor(lws_torch.get_thresholds(2, 1, 0.1, 1))
            on = (proc._st_la, proc._st_nofuture, proc._st_af, thr)
            colors = proc.inner_scheme != "jacobi"
            for ip in (1, 2):
                k = online_float64(lib64, sr, si, *on, 1 if colors else ip,
                                   2 if colors else 0, 3 if colors else 1)
                p = online_mod.packed_rtisi_la(sr, si, *on, ip, proc.inner_scheme)
                worst64 = max(worst64, report(
                    f"float64 online LWS({fsize}, {fshift}) LA={la} {proc.inner_scheme} "
                    f"passes={ip}", k, p, A))
            passes, color_k, rounds = online_mod._scheme(1, proc.inner_scheme)

            def k4_64(r, i, st, means, n_live, on=on, sch=(passes, color_k, rounds)):
                return chunk_float64(lib64, r, i, st, means, *on, n_live, *sch)

            def plain64(r, i, st, means, n_live, on=on, scheme=proc.inner_scheme):
                return online_mod.online_chunk(r, i, st, means, *on, n_live, 1, scheme)

            k, kst = chunked(k4_64, sr, si, proc, thr, False)
            p, pst = chunked(plain64, sr, si, proc, thr, False)
            worst64 = max(worst64, report(
                f"float64 chunked online LWS({fsize}, {fshift}) LA={la} {proc.inner_scheme}",
                k, p, A), report("  its final state", kst[:2], pst[:2], A))
        print(f"worst float64 {worst64:.3e}")
        print(f"previous K3 / K4 ({args.old_online}): "
              f"{'bit-equal on every case' if old_equal else 'DIFFER'}")
        worst_new, worst_new64, new_equal = new_geometries(lib64, old_online,
                                                           np.random.default_rng(11))

        # K5: the plan, then each case against the previous K5 (bit for bit)
        # and the plain group update (float32; the double build in float64)
        _build.load = libs.__getitem__
        packed_plan_ok = packed_plan_matches()
        old_packed = bind_legacy_packed(build_cpu(
            "lws_sweeps", out, csrc=old_sources(args.old_packed, out), tag="_old_packed"))
        worst_k5, worst_k5_64, k5_equal = k5_cases(old_packed, lib_sw64,
                                                   np.random.default_rng(13))
        print(f"worst K5 vs plain: float32 {worst_k5:.3e}, float64 {worst_k5_64:.3e}; "
              f"previous K5 ({args.old_packed}) "
              f"{'bit-equal on every case' if k5_equal else 'DIFFERS'}")
        ok = (worst < 2e-3 and worst_chunk < 2e-3 and k3_equal and worst64 < 1e-9
              and old_equal and new_equal and online_plan_ok and worst_new < 2e-3
              and worst_new64 < 1e-9
              and worst_k5 < 2e-3 and worst_k5_64 < 1e-9 and k5_equal and packed_plan_ok
              and plan_ok and k1_equal
              and worst_k1_64 < 1e-9)
        return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
