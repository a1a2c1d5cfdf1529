// Thresholded Gauss-Seidel LWS sweeps on Hopper (sm_90a).
//
// Replaces the TPU kernel lws_tpu/ops/pallas_packed.py::tiled_lws_sweeps
// (_tiled_sweeps_kernel, frame body _window_sweep, _freq_halo,
// _color_rounds, the dead-sweep skip _live_iters). It computes what that
// kernel computes, not its VMEM tile plan:
//
//   for each sweep it (skipped when live[b, it] == 0, which is exact):
//     for each frame m in order (Gauss-Seidel: frames m-Q+1..m-1 hold this
//     sweep's values, m+1..m+Q-1 the previous sweep's):
//       temp(n) = sum over the (2Q-1) x (2L+1) taps of W[dr, dk, n] *
//                 S(m+dr-Q+1, n+dk-L), frequency margins read as conjugate
//                 reflections (j < 0 -> conj S[-j], j > F-1 -> conj
//                 S[2(F-1)-j]);
//       off-centre taps first, in (dr, dk) order; the centre row's taps
//       separately, `passes` jacobi re-passes (fallback: the ORIGINAL
//       centre row) or color_k x color_rounds red-black rounds (fallback:
//       the evolving row, only bins n % color_k == color update);
//       S(m, n) <- temp * amp * rsqrt(|temp|^2) where amp > thr && |temp|^2 > 0.
//
// Layout: the state is a wrapper-allocated padded plane pair
// (B, T + 2(Q-1), F) in device memory whose Q-1 rows at each end are the
// frozen time halos; amp is (B, T, F); weights (2Q-1, 2L+1, F), already
// visibility-masked; thr and live are (B, iters).
//
// Design (K1, lws_sweeps_kernel): one CTA per (virtual) utterance, all
// sweeps in one launch. Frames within a sweep are serial: a frame is one
// barrier step for its off-centre taps and one per in-frame pass (one in
// all on the no-future stencil, which has no centre taps).
//   - The window lives in shared memory: a ring of 2Q rows slotted by
//     absolute padded row (row r in slot r % 2Q), each row stored with its
//     L conjugate-reflected margin bins on both sides, so a tap is a plain
//     shared-memory read. Frame m reads the 2Q-1 rows m..m+2Q-2; after its
//     off-centre taps it issues the device-memory loads of row m+2Q-1
//     (frame m+1's newest, untouched by frame m), which overlap its first
//     pass; the values land in the one slot frame m does not read and are
//     visible after the frame's last barrier. Each live sweep starts by
//     loading rows 0..2Q-2 (the frozen halo and the rows the last sweep
//     wrote back). A frame's new centre row goes to its ring slot and to
//     device memory.
//   - Each thread owns `bins` bins, bins = ceil(F / 1024) on
//     round_up(ceil(F / bins), 32) threads (F = 2049: 3 bins on 704
//     threads, not 1024, 1024 and 1), strided (tid, tid + threads, ...) so
//     that a warp's loads of state and weights are contiguous. Its
//     off-centre sums, original centre values and amp stay in registers
//     across the frame's barriers, and its bins' taps run in one body.
//   - Specialised at compile time for (Q, L) = (4, 5) (the batch, music and
//     longform paths) and (2, 5) (color2x3) at 1-3 bins per thread on at
//     most 768 threads: a row's tap loop unrolls, so all of a bin's row
//     loads issue before its multiply-adds (rows run one at a time:
//     unrolling them too spills), and with every row of weights staged
//     (F = 257) the kernel holds no device-memory weight path. Any other
//     (Q, L) or thread count takes the run-time path: the same steps with
//     run-time loops, and no cap on Q. Where the ring does not fit
//     (F > ~2,900 at Q = 4) the run-time path reads the window from device
//     memory with the same arithmetic.
//   - Weights: the rows of taps that fit beside the ring are staged in
//     shared memory, the centre row first (the passes read it `passes`
//     times), then the off-centre rows in dr order; the other rows are
//     read through the read-only path, so each row's loads are of one kind.
//     F = 257: all 7 rows; F = 513: 4; F = 2049: none.
//   - Each bin's arithmetic is the previous K1's, operation for operation:
//     the off-centre sum in (dr, dk) order, the centre sum in dk order,
//     phase_update. With -fmad=false the result is the same bit for bit
//     (port_tools/cuda_on_cpu.py holds the two to it).
//   The launch plan (bins, threads, row width, ring, staged taps, bytes) is
//   sweep_plan below; lws_sweeps_plan exports it, and
//   lws_torch/ops/lws_sweeps.py::sweep_plan mirrors it.
//
// Bound on this card: still the serial frame chain, not bytes or FLOPs:
// T x live sweeps x (1 + passes) barrier steps per CTA on B CTAs (32 on the
// batch path; S = 8 on the longform path). Inside a step, the ring takes
// device-memory latency off the taps; what is left is shared-memory
// traffic (F = 257) and, where the weights do not fit, the weights through
// L2: (2Q-2 + passes)(2L+1) tap planes of 8F bytes per frame, 1.62 MB at
// F = 2049 into one SM, beside the 3 x 33 shared-memory reads per bin and
// frame, all through the SM's one load/store pipe (PERF.md has the
// measured times). Only splitting F across a thread-block cluster (a
// weight slice per CTA in shared memory, the +-L halo bins through
// distributed shared memory) removes that floor; that is the next change.
//
// Built with -fmad=false so each product and sum rounds as in the plain
// PyTorch version (lws_torch/core/stencil.py). read_bin and the epilogue
// are shared with the online kernel (lws_common.cuh).
//
// The grouped kernel (lws_packed_kernel) replaces the TPU kernel
// lws_tpu/ops/pallas_packed.py::packed_lws_sweeps (_sweeps_kernel) at
// micro > 1, its group_update: it updates `micro` frames at a time, every
// one from the state as it was before the group (block Jacobi inside a
// group), with threads over the group's micro x F bins: the off-centre tap
// sums of the whole group into shared memory, a barrier, then the in-frame
// jacobi passes over the group's centre rows (lws_tpu's group update runs
// jacobi passes whatever the scheme), a barrier. It keeps the tap helpers
// below (off_centre_taps, centre_update), which read the state from device
// memory. At micro = 1 packed_lws_sweeps is K1's frame order, and its
// wrapper launches lws_sweeps_kernel. It is bound like K1 by its serial
// chain, with micro times fewer barrier steps per sweep.

#include <cuda_runtime.h>

#include "lws_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K5's tap helpers: the state read from device memory.

template <bool kSmemWeights>
__device__ __forceinline__ float load_w(const float* w, int idx) {
  if (kSmemWeights) return w[idx];
  return __ldg(w + idx);
}

// Off-centre taps of frame m at bin n: the sum over dr != Q-1 and dk of
// W[dr, dk, n] * S(m+dr-Q+1, n+dk-L), in (dr, dk) order, read from the
// padded state (frame m's row is m+Q-1).
template <bool kSmemWeights>
__device__ __forceinline__ void off_centre_taps(const float* Xr, const float* Xi,
                                                const float* Wr, const float* Wi,
                                                int m, int n, int F, int Q1, int K,
                                                int L, float& tr, float& ti) {
  tr = 0.f;
  ti = 0.f;
  for (int dr = 0; dr < 2 * Q1 + 1; ++dr) {
    if (dr == Q1) continue;
    const float* rr = Xr + (size_t)(m + dr) * F;
    const float* ri = Xi + (size_t)(m + dr) * F;
    for (int dk = 0; dk < K; ++dk) {
      float br, bi;
      read_bin(rr, ri, n + dk - L, F, br, bi);
      const int w = (dr * K + dk) * F + n;
      const float wr = load_w<kSmemWeights>(Wr, w);
      const float wi = load_w<kSmemWeights>(Wi, w);
      tr = tr + (wr * br - wi * bi);
      ti = ti + (wr * bi + wi * br);
    }
  }
}

// One in-frame pass at bin n: the centre taps over the row (src_r, src_i),
// added to the off-centre sum, then the epilogue; (nr, ni) hold the
// fallback on entry.
template <bool kSmemWeights>
__device__ __forceinline__ void centre_update(const float* src_r, const float* src_i,
                                              const float* Wr, const float* Wi, int n,
                                              int F, int Q1, int K, int L, float tr,
                                              float ti, float a, float th, float& nr,
                                              float& ni) {
  float cr = 0.f, ci = 0.f;
  for (int dk = 0; dk < K; ++dk) {
    float br, bi;
    read_bin(src_r, src_i, n + dk - L, F, br, bi);
    const int w = (Q1 * K + dk) * F + n;
    const float wr = load_w<kSmemWeights>(Wr, w);
    const float wi = load_w<kSmemWeights>(Wi, w);
    cr = cr + (wr * br - wi * bi);
    ci = ci + (wr * bi + wi * br);
  }
  phase_update(tr + cr, ti + ci, a, th, nr, ni);
}

// ---------------------------------------------------------------------------
// K1: the launch plan.

constexpr int kMaxBins = 16;  // bins per thread of the run-time path (F <= 16384)
// Most threads of a fixed kernel: its launch bound (with one block per SM),
// which leaves it 80 registers a thread (1024 would leave 64, and the
// unrolled taps spill).
constexpr int kFixedThreads = 768;

struct SweepPlan {
  int bins;        // bins per thread, strided: tid, tid + threads, ...
  int threads;     // round_up(ceil(F / bins), 32)
  int width;       // floats per buffered row: F and L margin bins each side
  int ring;        // 1: the 2Q-row window lives in shared memory
  int staged;      // tap planes staged in shared memory: whole rows, centre row first
  int taps;        // (2Q - 1)(2L + 1)
  int fixed;       // 1: a compile-time (Q, L, bins) kernel runs
  long long bytes; // dynamic shared memory
};

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

SweepPlan sweep_plan(int F, int Q, int L) {
  SweepPlan p;
  p.bins = (F + kMaxThreads - 1) / kMaxThreads;
  p.threads = ((F + p.bins - 1) / p.bins + 31) / 32 * 32;
  p.width = F + 2 * L;
  const long long row = 2LL * p.width * (long long)sizeof(float);  // re and im
  const long long pingpong = 2 * row;
  const long long ring = 2LL * Q * row;
  p.ring = pingpong + ring <= kSmemLimit;
  const long long used = pingpong + (p.ring ? ring : 0);
  const int K = 2 * L + 1;
  p.taps = (2 * Q - 1) * K;
  const long long tap_row = 2LL * K * F * (long long)sizeof(float);  // a row's K planes
  const long long room = kSmemLimit - used;
  const long long rows = room > 0 ? room / tap_row : 0;
  p.staged = (int)(rows < 2 * Q - 1 ? rows : 2 * Q - 1) * K;
  p.fixed = p.ring && L == 5 && (Q == 4 || Q == 2) && p.bins <= 3 &&
            p.threads <= kFixedThreads;
  p.bytes = used + p.staged * 2LL * F * (long long)sizeof(float);
  return p;
}

struct SweepArgs {
  float* xr;  // the padded state: written, so not read-only
  float* xi;
  const float* amp;
  const float* wr;
  const float* wi;
  const float* thr;
  const int* live;
  int T, F, Q, L, iters, n_pass, color_k;
  int bins, width, staged;
};

// ---------------------------------------------------------------------------
// K1: device helpers.

// Bin n of a row into a shared-memory row buffer (bin j at index j + L),
// with the margin cells that reflect it: index L - n for 1 <= n <= L, and
// 2(F-1) - n + L for F-1-L <= n <= F-2, imaginary part negated (read_bin's
// reflection, stored once instead of branched on per tap).
__device__ __forceinline__ void put_bin(float* br, float* bi, int n, int F, int L,
                                        float vr, float vi) {
  br[n + L] = vr;
  bi[n + L] = vi;
  if (n >= 1 && n <= L) {
    br[L - n] = vr;
    bi[L - n] = -vi;
  }
  if (n >= F - 1 - L && n <= F - 2) {
    const int k = 2 * (F - 1) - n + L;
    br[k] = vr;
    bi[k] = -vi;
  }
}

// put_bin for each of this thread's own bins.
template <int KB>
__device__ __forceinline__ void put_bins(float* br, float* bi, const int (&nw)[KB],
                                         const bool (&own)[KB], int F, int L,
                                         const float (&vr)[KB], const float (&vi)[KB]) {
#pragma unroll
  for (int j = 0; j < KB; ++j)
    if (own[j]) put_bin(br, bi, nw[j], F, L, vr[j], vi[j]);
}

// One row's taps for this thread's bins, each bin's taps in dk order:
// acc[j] += sum over dk of W[dk, n_j] * S(row, n_j + dk - L). The row
// (rr, ri) is a shared-memory buffer (bin j at j + L) when kBuf, else a
// device-memory row read with reflections; (w_r, w_i) is the row's first
// tap plane, in shared memory when kSmemW. KK > 0 fixes the taps per row
// (K) at compile time: a bin's row values are loaded first, then its
// weights and multiply-adds. KB is the bins array size, nb the bins in use.
template <int KK, int KB, bool kBuf, bool kSmemW>
__device__ __forceinline__ void row_taps(const float* rr, const float* ri,
                                         const float* __restrict__ w_r,
                                         const float* __restrict__ w_i,
                                         const int (&nw)[KB], int nb, int K, int L, int F,
                                         float (&acc_r)[KB], float (&acc_i)[KB]) {
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j >= nb) continue;
    const int n = nw[j];
    if constexpr (KK > 0) {
      float vr[KK], vi[KK];
#pragma unroll
      for (int dk = 0; dk < KK; ++dk) {
        if (kBuf) {
          vr[dk] = rr[n + dk];
          vi[dk] = ri[n + dk];
        } else {
          read_bin(rr, ri, n + dk - L, F, vr[dk], vi[dk]);
        }
      }
#pragma unroll
      for (int dk = 0; dk < KK; ++dk) {
        const float wr = kSmemW ? w_r[dk * F + n] : __ldg(w_r + dk * F + n);
        const float wi = kSmemW ? w_i[dk * F + n] : __ldg(w_i + dk * F + n);
        acc_r[j] = acc_r[j] + (wr * vr[dk] - wi * vi[dk]);
        acc_i[j] = acc_i[j] + (wr * vi[dk] + wi * vr[dk]);
      }
    } else {
      for (int dk = 0; dk < K; ++dk) {
        float br, bi;
        if (kBuf) {
          br = rr[n + dk];
          bi = ri[n + dk];
        } else {
          read_bin(rr, ri, n + dk - L, F, br, bi);
        }
        const float wr = kSmemW ? w_r[dk * F + n] : __ldg(w_r + dk * F + n);
        const float wi = kSmemW ? w_i[dk * F + n] : __ldg(w_i + dk * F + n);
        acc_r[j] = acc_r[j] + (wr * br - wi * bi);
        acc_i[j] = acc_i[j] + (wr * bi + wi * br);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1: the kernel. KQ, KL, KNB > 0 fix Q, L and the bins per thread at
// compile time; 0 takes them from the arguments. kRing: the window in
// shared memory (else in device memory, run-time path only). kAllStaged:
// every row of taps is in shared memory, and the kernel holds no path that
// reads weights from device memory.
template <int KQ, int KL, int KNB, bool kRing, bool kAllStaged>
__global__ void __launch_bounds__(KQ > 0 ? kFixedThreads : kMaxThreads, 1)
    lws_sweeps_kernel(SweepArgs a) {
  static_assert(KQ == 0 || (kRing && KNB > 0), "the fixed kernels keep the ring");
  extern __shared__ float smem[];
  constexpr int kBins = KNB > 0 ? KNB : kMaxBins;
  constexpr int kK = KQ > 0 ? 2 * KL + 1 : 0;
  const int Q = KQ > 0 ? KQ : a.Q;
  const int L = KQ > 0 ? KL : a.L;
  const int NB = KNB > 0 ? KNB : a.bins;
  const int Q1 = Q - 1;
  const int R = 2 * Q - 1;  // rows a frame reads
  const int S = 2 * Q;      // ring slots
  const int K = 2 * L + 1;
  const int F = a.F;
  const int T = a.T;
  const int W = a.width;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const size_t plane = (size_t)(T + 2 * Q1) * F;
  float* Xr = a.xr + b * plane;
  float* Xi = a.xi + b * plane;
  const float* __restrict__ A = a.amp + (size_t)b * T * F;
  const float* __restrict__ g_wr = a.wr;
  const float* __restrict__ g_wi = a.wi;
  const int staged_rows = a.staged / K;  // the centre row first, then dr = 0, 1, ...

  // shared memory: two ping-pong centre rows, the ring, the staged rows of taps
  float* pp = smem;            // buffer k, plane c at pp + (2k + c) W
  float* ring = smem + 4 * W;  // slot s, plane c at ring + (2s + c) W
  float* s_wr = ring + (kRing ? 2 * S * W : 0);
  float* s_wi = s_wr + a.staged * F;
  for (int i = tid; i < a.staged * F; i += nth) {
    const int r = i / (K * F);  // staging rank of the row
    const int dr = r == 0 ? Q1 : (r - 1 < Q1 ? r - 1 : r);
    const int at = (dr * K) * F + (i - r * K * F);
    s_wr[i] = __ldg(g_wr + at);
    s_wi[i] = __ldg(g_wi + at);
  }

  // this thread's bins tid, tid + nth, ... (those < F are its own); reads
  // and weights use the bin clamped to F - 1, so threads past F read inside
  // the buffers and write nothing
  int nw[kBins];
  bool own[kBins];
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    nw[j] = imin(tid + j * nth, F - 1);
    own[j] = j < NB && tid + j * nth < F;
  }

  const int n_pass = a.n_pass;
  const int color_k = a.color_k;
  const int iters = a.iters;

  for (int it = 0; it < iters; ++it) {
    if (__ldg(a.live + b * iters + it) == 0) continue;  // uniform over the CTA
    const float th = __ldg(a.thr + b * iters + it);
    if constexpr (kRing) {
      // frame 0's window: padded rows 0 .. R-1 into slots 0 .. R-1
      for (int r = 0; r < R; ++r) {
        float* br = ring + 2 * r * W;
#pragma unroll
        for (int j = 0; j < kBins; ++j)
          if (own[j])
            put_bin(br, br + W, nw[j], F, L, Xr[(size_t)r * F + nw[j]],
                    Xi[(size_t)r * F + nw[j]]);
      }
    }
    __syncthreads();  // the window and the staged taps are complete

    int base = 0;  // ring slot of padded row m
    for (int m = 0; m < T; ++m) {
      // off-centre taps, in (dr, dk) order per bin; one row at a time
      // (unrolling the rows too hoists every row's loads and spills)
      float tr[kBins], ti[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        tr[j] = 0.f;
        ti[j] = 0.f;
      }
#pragma unroll 1
      for (int dr = 0; dr < R; ++dr) {
        if (dr == Q1) continue;
        int slot = base + dr;
        slot = slot >= S ? slot - S : slot;
        const float* rr = kRing ? ring + 2 * slot * W : Xr + (size_t)(m + dr) * F;
        const float* ri = kRing ? rr + W : Xi + (size_t)(m + dr) * F;
        const int rank = 1 + (dr < Q1 ? dr : dr - 1);  // the row's staging rank
        if (kAllStaged || rank < staged_rows) {
          const size_t at = (size_t)rank * K * F;
          row_taps<kK, kBins, kRing, true>(rr, ri, s_wr + at, s_wi + at, nw, NB, K, L, F,
                                           tr, ti);
        } else {
          const size_t at = (size_t)dr * K * F;
          row_taps<kK, kBins, kRing, false>(rr, ri, g_wr + at, g_wi + at, nw, NB, K, L, F,
                                            tr, ti);
        }
      }

      // amp, row m + R (frame m+1's newest row, which this frame does not
      // read: its loads overlap the first pass, and it lands in the slot of
      // row m - 1), and the original centre row (the jacobi fallback)
      const bool fetch = kRing && m + R < T + 2 * Q1;
      float am[kBins], fr[kBins], fi[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        if (j < NB) am[j] = __ldg(A + (size_t)m * F + nw[j]);
        if (fetch && own[j]) {
          fr[j] = Xr[(size_t)(m + R) * F + nw[j]];
          fi[j] = Xi[(size_t)(m + R) * F + nw[j]];
        }
      }
      int fslot = base + R;
      fslot = fslot >= S ? fslot - S : fslot;
      float* f_r = ring + 2 * fslot * W;
      int cslot = base + Q1;
      cslot = cslot >= S ? cslot - S : cslot;
      float* cen_r = ring + 2 * cslot * W;  // ring only
      float* cen_i = cen_r + W;
      float* dev_r = Xr + (size_t)(m + Q1) * F;
      float* dev_i = Xi + (size_t)(m + Q1) * F;
      float orr[kBins], ori[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        if (j < NB) {
          orr[j] = kRing ? cen_r[nw[j] + L] : dev_r[nw[j]];
          ori[j] = kRing ? cen_i[nw[j] + L] : dev_i[nw[j]];
        }
      }

      if (n_pass == 0) {
        // no centre taps (the no-future stencil): no thread reads the
        // centre row during this frame, so write it at once
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          if (own[j]) {
            float nr = orr[j], ni = ori[j];
            phase_update(tr[j], ti[j], am[j], th, nr, ni);
            dev_r[nw[j]] = nr;
            dev_i[nw[j]] = ni;
            if (kRing) put_bin(cen_r, cen_i, nw[j], F, L, nr, ni);
          }
        }
        if (fetch) put_bins(f_r, f_r + W, nw, own, F, L, fr, fi);
      } else {
#pragma unroll
        for (int j = 0; j < kBins; ++j)
          if (own[j]) put_bin(pp, pp + W, nw[j], F, L, orr[j], ori[j]);
      }

      const bool cen_staged = staged_rows > 0;
      for (int p = 0; p < n_pass; ++p) {
        __syncthreads();  // the row this pass reads is complete
        const float* src_r = pp + 2 * (p & 1) * W;
        const float* src_i = src_r + W;
        float* dst_r = pp + 2 * ((p + 1) & 1) * W;
        float* dst_i = dst_r + W;
        const bool last = p + 1 == n_pass;
        const int color = color_k > 0 ? p % color_k : -1;
        float cr[kBins], ci[kBins];
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          cr[j] = 0.f;
          ci[j] = 0.f;
        }
        if (kAllStaged || cen_staged) {
          row_taps<kK, kBins, true, true>(src_r, src_i, s_wr, s_wi, nw, NB, K, L, F, cr, ci);
        } else {
          const size_t at = (size_t)Q1 * K * F;
          row_taps<kK, kBins, true, false>(src_r, src_i, g_wr + at, g_wi + at, nw, NB, K, L,
                                           F, cr, ci);
        }
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          if (own[j]) {
            const int n = nw[j];
            // jacobi falls back to the original centre row; colors to the
            // evolving row, and only bins of this pass's color update
            float nr = color_k > 0 ? src_r[n + L] : orr[j];
            float ni = color_k > 0 ? src_i[n + L] : ori[j];
            if (color < 0 || n % color_k == color)
              phase_update(tr[j] + cr[j], ti[j] + ci[j], am[j], th, nr, ni);
            if (last) {
              dev_r[n] = nr;
              dev_i[n] = ni;
              if (kRing) put_bin(cen_r, cen_i, n, F, L, nr, ni);
            } else {
              put_bin(dst_r, dst_i, n, F, L, nr, ni);
            }
          }
        }
        if (p == 0 && fetch) put_bins(f_r, f_r + W, nw, own, F, L, fr, fi);
      }
      __syncthreads();  // frame m is written before frame m+1 reads it
      base = base + 1 == S ? 0 : base + 1;
    }
  }
}

typedef void (*SweepKernel)(SweepArgs);

// The kernel sweep_plan picks: a fixed one for (Q, L) = (4, 5) or (2, 5) at
// 1-3 bins per thread on at most kFixedThreads threads with the ring (at 1
// bin with every row staged, the one without device-memory weights), else
// the run-time one.
template <int KQ>
SweepKernel fixed_kernel(const SweepPlan& p) {
  if (p.bins == 1) {
    return p.staged == p.taps ? lws_sweeps_kernel<KQ, 5, 1, true, true>
                              : lws_sweeps_kernel<KQ, 5, 1, true, false>;
  }
  return p.bins == 2 ? lws_sweeps_kernel<KQ, 5, 2, true, false>
                     : lws_sweeps_kernel<KQ, 5, 3, true, false>;
}

SweepKernel pick_kernel(const SweepPlan& p, int Q) {
  if (p.fixed) return Q == 4 ? fixed_kernel<4>(p) : fixed_kernel<2>(p);
  if (!p.ring) return lws_sweeps_kernel<0, 0, 0, false, false>;
  if (p.bins == 1) return lws_sweeps_kernel<0, 0, 1, true, false>;
  return lws_sweeps_kernel<0, 0, 0, true, false>;
}

// The grouped sweeps (K5) at micro > 1: the same state layout and
// arguments as lws_sweeps_launch, frames updated `micro` at a time, jacobi
// passes. Shared memory holds the off-centre sums and the centre-row
// ping-pong of micro rows, then the weights when they fit.
template <bool kSmemWeights>
__global__ void __launch_bounds__(kMaxThreads)
lws_packed_kernel(float* xr, float* xi, const float* __restrict__ amp,
                  const float* __restrict__ wr_g, const float* __restrict__ wi_g,
                  const float* __restrict__ thr, const int* __restrict__ live,
                  int T, int F, int Q, int L, int iters, int micro, int passes,
                  int has_centre) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int Q1 = Q - 1;
  const int K = 2 * L + 1;
  const int MF = micro * F;
  const size_t plane = (size_t)(T + 2 * Q1) * F;
  float* Xr = xr + b * plane;
  float* Xi = xi + b * plane;
  const float* A = amp + (size_t)b * T * F;

  float* s_tr = smem;  // off-centre tap sums of the group, (micro, F)
  float* s_ti = smem + MF;
  float* s_row[2][2] = {{smem + 2 * MF, smem + 3 * MF},  // centre rows, ping-pong
                        {smem + 4 * MF, smem + 5 * MF}};
  const float* Wr = wr_g;
  const float* Wi = wi_g;
  if (kSmemWeights) {
    const int nw = (2 * Q - 1) * K * F;
    float* s_wr = smem + 6 * MF;
    float* s_wi = s_wr + nw;
    for (int i = tid; i < nw; i += nth) {
      s_wr[i] = __ldg(wr_g + i);
      s_wi[i] = __ldg(wi_g + i);
    }
    __syncthreads();
    Wr = s_wr;
    Wi = s_wi;
  }

  const int n_pass = has_centre ? passes : 0;

  for (int it = 0; it < iters; ++it) {
    if (__ldg(live + b * iters + it) == 0) continue;  // uniform over the CTA
    const float th = __ldg(thr + b * iters + it);
    for (int start = 0; start < T; start += micro) {
      const int gF = (T - start < micro ? T - start : micro) * F;  // the last group stops at T-1

      for (int e = tid; e < gF; e += nth) {
        const int j = e / F;
        const int n = e - j * F;
        const int m = start + j;
        float tr, ti;
        off_centre_taps<kSmemWeights>(Xr, Xi, Wr, Wi, m, n, F, Q1, K, L, tr, ti);
        s_tr[e] = tr;
        s_ti[e] = ti;
        s_row[0][0][e] = Xr[(size_t)(m + Q1) * F + n];
        s_row[0][1][e] = Xi[(size_t)(m + Q1) * F + n];
      }
      __syncthreads();  // every tap of the group is read before any write

      if (n_pass == 0) {
        // no centre taps (the no-future stencil): the epilogue alone
        for (int e = tid; e < gF; e += nth) {
          const int j = e / F;
          const int n = e - j * F;
          const size_t at = (size_t)(start + j + Q1) * F + n;
          float nr = s_row[0][0][e], ni = s_row[0][1][e];
          phase_update(s_tr[e], s_ti[e], __ldg(A + (size_t)(start + j) * F + n), th, nr,
                       ni);
          Xr[at] = nr;
          Xi[at] = ni;
        }
      }
      for (int p = 0; p < n_pass; ++p) {
        if (p > 0) __syncthreads();  // the rows this pass reads are complete
        const float* src_r = s_row[p & 1][0];
        const float* src_i = s_row[p & 1][1];
        const bool last = p + 1 == n_pass;
        float* dst_r = s_row[(p + 1) & 1][0];
        float* dst_i = s_row[(p + 1) & 1][1];
        for (int e = tid; e < gF; e += nth) {
          const int j = e / F;
          const int n = e - j * F;
          const size_t at = (size_t)(start + j + Q1) * F + n;
          // jacobi falls back to the original centre row (in device memory
          // until the last pass writes it: thread e alone reads and writes
          // that bin there)
          float nr = Xr[at];
          float ni = Xi[at];
          centre_update<kSmemWeights>(src_r + j * F, src_i + j * F, Wr, Wi, n, F, Q1, K, L,
                                      s_tr[e], s_ti[e],
                                      __ldg(A + (size_t)(start + j) * F + n), th, nr, ni);
          if (last) {
            Xr[at] = nr;
            Xi[at] = ni;
          } else {
            dst_r[e] = nr;
            dst_i[e] = ni;
          }
        }
      }
      __syncthreads();  // the group is written before the next group reads it
    }
  }
}

long long smem_bytes(int F, int Q, int L, bool weights, int micro = 1) {
  const long long base = 6LL * micro * F * (long long)sizeof(float);
  return weights ? base + 2LL * (2 * Q - 1) * (2 * L + 1) * F * (long long)sizeof(float)
                 : base;
}

template <bool kSmemWeights>
cudaError_t launch_packed(int B, int threads, int bytes, cudaStream_t s, float* xr,
                          float* xi, const float* amp, const float* wr, const float* wi,
                          const float* thr, const int* live, int T, int F, int Q, int L,
                          int iters, int micro, int passes, int has_centre) {
  cudaError_t err = cudaFuncSetAttribute(
      lws_packed_kernel<kSmemWeights>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  lws_packed_kernel<kSmemWeights><<<B, threads, bytes, s>>>(
      xr, xi, amp, wr, wi, thr, live, T, F, Q, L, iters, micro, passes, has_centre);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs `iters` sweeps over the padded state (xr, xi) in place on `stream`.
// Returns the cudaError_t of the launch (0 on success); a shared-memory
// plan that does not fit one block is cudaErrorInvalidValue.
int lws_sweeps_launch(void* xr, void* xi, const void* amp, const void* wr,
                      const void* wi, const void* thr, const void* live,
                      int B, int T, int F, int Q, int L, int iters,
                      int passes, int color_k, int color_rounds,
                      int has_centre, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || L < 0 || F < L + 1 || iters < 0 || passes < 1 ||
      color_k < 0 || color_rounds < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (iters == 0) return (int)cudaSuccess;
  const SweepPlan p = sweep_plan(F, Q, L);
  if (p.bytes > kSmemLimit || p.bins > kMaxBins) return (int)cudaErrorInvalidValue;
  SweepArgs a;
  a.xr = (float*)xr;
  a.xi = (float*)xi;
  a.amp = (const float*)amp;
  a.wr = (const float*)wr;
  a.wi = (const float*)wi;
  a.thr = (const float*)thr;
  a.live = (const int*)live;
  a.T = T;
  a.F = F;
  a.Q = Q;
  a.L = L;
  a.iters = iters;
  a.n_pass = has_centre ? (color_k > 0 ? color_k * color_rounds : passes) : 0;
  a.color_k = color_k;
  a.bins = p.bins;
  a.width = p.width;
  a.staged = p.staged;
  const SweepKernel kernel = pick_kernel(p, Q);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, p.threads, (size_t)p.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K1's launch plan for (F, Q, L) into out[0..7]: bins per thread, threads,
// row width, ring (0/1), staged tap planes, taps, fixed kernel (0/1),
// shared-memory bytes. Returns 0 when it fits one block, else
// cudaErrorInvalidValue.
int lws_sweeps_plan(int F, int Q, int L, long long* out) {
  if (F < 1 || Q < 1 || L < 0) return (int)cudaErrorInvalidValue;
  const SweepPlan p = sweep_plan(F, Q, L);
  const long long v[8] = {p.bins, p.threads, p.width, p.ring,
                          p.staged, p.taps, p.fixed, p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return p.bytes <= kSmemLimit && p.bins <= kMaxBins ? (int)cudaSuccess
                                                     : (int)cudaErrorInvalidValue;
}

// The grouped sweeps (K5) over the same padded state, `micro` >= 2 frames
// per group, `passes` jacobi passes. Returns the cudaError_t of the launch
// (0 on success); a shared-memory plan that does not fit one block is
// cudaErrorInvalidValue.
int lws_packed_launch(void* xr, void* xi, const void* amp, const void* wr,
                      const void* wi, const void* thr, const void* live,
                      int B, int T, int F, int Q, int L, int iters, int micro,
                      int passes, int has_centre, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || Q > kMaxQ || L < 0 || F < L + 1 || iters < 0 ||
      micro < 2 || passes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (iters == 0) return (int)cudaSuccess;
  if (smem_bytes(F, Q, L, false, micro) > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int threads = threads_for(micro * F);  // micro * F < kSmemLimit here
  const bool stage = smem_bytes(F, Q, L, true, micro) <= kSmemLimit;
  const int bytes = (int)smem_bytes(F, Q, L, stage, micro);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      stage ? launch_packed<true>(B, threads, bytes, s, (float*)xr, (float*)xi,
                                  (const float*)amp, (const float*)wr, (const float*)wi,
                                  (const float*)thr, (const int*)live, T, F, Q, L, iters,
                                  micro, passes, has_centre)
            : launch_packed<false>(B, threads, bytes, s, (float*)xr, (float*)xi,
                                   (const float*)amp, (const float*)wr, (const float*)wi,
                                   (const float*)thr, (const int*)live, T, F, Q, L, iters,
                                   micro, passes, has_centre);
  return (int)err;
}

const char* lws_sweeps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
