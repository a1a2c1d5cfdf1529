#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, to rehearse them before a card run.

    python port_tools/cuda_on_cpu.py [--build-dir DIR]

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
its wrapper launches K1. Agreement shows the kernel's indexing,
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
#define __launch_bounds__(x)

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
    cpu_launch(...)."""
    text = re.sub(r"\bfloat\b", real, text)
    text = text.replace(f"extern __shared__ {real} smem[];",
                        f"{real}* smem = reinterpret_cast<{real}*>(cpu_smem);")
    return LAUNCH.sub(lambda m: f"cpu_launch({m.group(1)}, {m.group(2)}, {m.group(3)});",
                      text)


def build_cpu(name: str, out_dir: Path, real: str = "float") -> ctypes.CDLL:
    """g++ build of csrc/<name>.cu; real="double" builds it with every float
    a double, to check its schedule without float32 rounding."""
    src_dir = out_dir / real
    shim_dir = out_dir / "shim"
    for d in (src_dir, shim_dir):
        d.mkdir(parents=True, exist_ok=True)
    (shim_dir / "cuda_runtime.h").write_text(SHIM)
    for header in _build.CSRC.glob("*.cuh"):
        (src_dir / header.name).write_text(cpu_source(header.read_text(), real))
    src = src_dir / f"{name}.cpp"
    src.write_text(cpu_source((_build.CSRC / f"{name}.cu").read_text(), real))
    lib = src_dir / f"{name}.so"
    cmd = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-ffp-contract=off",
           f"-I{shim_dir}", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"g++ failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def online_float64(lib, sr, si, st_la, st_ai, st_af, thresholds, passes, color_k, rounds):
    """The online kernel built in double, launched on float64 tensors with
    the wrapper's own weight sets and thresholds."""
    B, T, F = sr.shape
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, :] * amp.mean(dim=(-2, -1))[:, None]).contiguous()
    wr, wi, taps, counts = online_mod.online_weight_sets(st_la, st_ai, st_af)
    taps, counts = torch.as_tensor(taps), torch.as_tensor(counts)
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    ptrs = [t.data_ptr() for t in (sr, si, amp, out_r, out_i, wr, wi, taps, counts, thr)]
    lib.lws_online_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    err = lib.lws_online_launch(*ptrs, B, T, F, st_af.Q, st_af.L, len(st_la),
                                thresholds.shape[0], passes, color_k, rounds, None)
    assert err == 0, err
    return out_r, out_i


def chunk_float64(lib, sr, si, state, means, st_la, st_ai, st_af, thresholds, n_live,
                  passes, color_k, rounds):
    """K4 built in double, launched on float64 tensors with the wrapper's
    own amp, thresholds and weight sets."""
    B, N, F = sr.shape
    amp = torch.sqrt(sr * sr + si * si)
    thr = (thresholds[None, None, :] * means[:, :, None]).contiguous()
    wr, wi, taps, counts = online_mod.online_weight_sets(st_la, st_ai, st_af)
    taps, counts = torch.as_tensor(taps), torch.as_tensor(counts)
    ins = [state.ring_r, state.ring_i, state.amp]
    outs = [torch.empty_like(t) for t in ins]
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    ptrs = [t.data_ptr() for t in (sr, si, amp, thr, *ins, *outs, out_r, out_i, wr, wi,
                                   taps, counts)]
    lib.lws_online_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    err = lib.lws_online_chunk_launch(*ptrs, B, N, F, st_af.Q, st_af.L, len(st_la),
                                      thresholds.shape[0], passes, color_k, rounds,
                                      state.seen, n_live, None)
    assert err == 0, err
    return out_r, out_i, online_mod.ChunkState(*outs, state.seen + N)


def grouped_float64(lib, sr, si, st, thresholds, micro, inner_passes):
    """K5 built in double, launched at micro > 1 (jacobi passes) on float64
    tensors with the wrapper's own padded state and schedule."""
    B, T, F = sr.shape
    Q1 = st.Q - 1
    amp, thr, live = sweeps_mod.sweep_schedule(sr, si, thresholds)
    xr = torch.cat([sr[:, :1].expand(B, Q1, F), sr, sr[:, -1:].expand(B, Q1, F)], 1)
    xi = torch.cat([si[:, :1].expand(B, Q1, F), si, si[:, -1:].expand(B, Q1, F)], 1)
    xr, xi, thr = xr.contiguous(), xi.contiguous(), thr.contiguous()
    lib.lws_packed_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    ptrs = [t.data_ptr() for t in (xr, xi, amp, st.Wr, st.Wi, thr, live)]
    passes = max(1, inner_passes) if st.has_centre else 1
    err = lib.lws_packed_launch(*ptrs, B, T, F, st.Q, st.L, thresholds.shape[0], micro,
                                passes, int(st.has_centre), None)
    assert err == 0, err
    return xr[:, Q1:Q1 + T], xi[:, Q1:Q1 + T]


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


def report(what, k, p, A):
    d = max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()))
    print(f"{what}: max|cpu-built kernel - plain| / max amp {d / A.max():.3e}", flush=True)
    return d / A.max()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", default=None,
                    help="where the g++ builds go (default: a temporary directory)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.build_dir or tmp)
        libs = {n: build_cpu(n, out) for n in ("lws_sweeps", "lws_online")}
        _build.load = libs.__getitem__  # the wrappers' _library() loads these
        torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)
        rng = np.random.default_rng(0)
        worst = 0.0
        for fsize, fshift, la, iters in ((512, 128, 3, 2), (256, 128, 3, 2),
                                         (512 + 64, 128, 2, 2), (1024, 256, 3, 1),
                                         (512, 128, 0, 1)):
            proc = lws_torch.LWS(fsize, fshift, look_ahead=la, device="cpu")
            A, sr, si = random_phase(proc, 20, rng)
            thr = torch.tensor(lws_torch.get_thresholds(iters, 1, 0.1, 1), dtype=torch.float32)
            on = (proc._st_la, proc._st_nofuture, proc._st_af, thr)
            for ip in sorted({proc.inner_passes, 2}):
                k = online_mod._launch(sr, si, *on, ip, proc.inner_scheme)
                p = online_mod.packed_rtisi_la(sr, si, *on, ip, proc.inner_scheme,
                                               backend="torch")
                worst = max(worst, report(
                    f"online LWS({fsize}, {fshift}) LA={la} {iters} rounds "
                    f"{proc.inner_scheme} passes={ip} {tuple(sr.shape)}", k, p, A))
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

            (kr, ki), kst = chunked(k4, sr, si, proc, thr, False)
            (pr, pi), pst = chunked(plain, sr, si, proc, thr, False)
            d = report(f"chunked online LWS({fsize}, {fshift}) LA={la} {iters} rounds "
                       f"{proc.inner_scheme}, running mean", (kr, ki), (pr, pi), A)
            ds = report("  its final state", kst[:2], pst[:2], A)
            worst_chunk = max(worst_chunk, d, ds)
            (fr, fi), _ = chunked(k4, sr, si, proc, thr, True)
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

        # K5: the grouped sweeps against the plain group update
        worst_k5 = 0.0
        dense = torch.tensor(lws_torch.get_thresholds(100, 100, 0.1, 1)[-2:],
                             dtype=torch.float32)
        nofuture = torch.tensor(lws_torch.get_thresholds(1, 1, 0.1, 1), dtype=torch.float32)
        for fsize, fshift in ((512, 128), (256, 128), (512 + 64, 128)):
            proc = lws_torch.LWS(fsize, fshift, device="cpu")
            A, sr, si = random_phase(proc, 23, rng)
            for st, ip, scheme, th in ((proc._st_batch, proc.batch_inner_passes,
                                        proc.inner_scheme, dense),
                                       (proc._st_nofuture, 1, "jacobi", nofuture)):
                for micro in (2, 3, 4):
                    k = packed_mod._launch(sr, si, st, th, micro, ip, scheme)
                    p = packed_mod.packed_lws_sweeps(sr, si, st, th, micro, ip, scheme,
                                                     backend="torch")
                    worst_k5 = max(worst_k5, report(
                        f"grouped LWS({fsize}, {fshift}) "
                        f"{'batch' if st is proc._st_batch else 'no-future'} {scheme} "
                        f"passes={ip} micro={micro}", k, p, A))
        print(f"worst float32 grouped {worst_k5:.3e}")
        lib_sw64 = build_cpu("lws_sweeps", out, "double")
        worst_k5_64 = 0.0
        for fsize, fshift in ((512, 128), (256, 128)):
            proc = lws_torch.LWS(fsize, fshift, device="cpu", dtype=torch.float64)
            A, sr, si = random_phase(proc, 23, rng)
            sr, si = sr.double(), si.double()
            st = proc._st_batch
            thr64 = dense.double()
            for micro in (2, 4):
                k = grouped_float64(lib_sw64, sr, si, st, thr64, micro, proc.batch_inner_passes)
                p = packed_mod.packed_lws_sweeps(sr, si, st, thr64, micro,
                                                 proc.batch_inner_passes, proc.inner_scheme)
                worst_k5_64 = max(worst_k5_64, report(
                    f"float64 grouped LWS({fsize}, {fshift}) micro={micro}", k, p, A))
        print(f"worst float64 grouped {worst_k5_64:.3e}")
        ok = (worst < 2e-3 and worst_chunk < 2e-3 and k3_equal and worst64 < 1e-9
              and worst_k5 < 2e-3 and worst_k5_64 < 1e-9)
        return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
