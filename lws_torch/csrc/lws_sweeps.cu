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
//     (F = 257) the kernel holds no device-memory weight path. And for
//     (8, 5) with weights of period Q at 1-2 bins per thread on at most
//     768 threads (the table kernel, kTable: LWS(2048, 256), the mel
//     vocoder's F = 1025). Any other (Q, L), period or thread count takes
//     the run-time path: the same steps with run-time loops, and no cap on
//     Q. Where the ring does not fit (F > ~2,900 at Q = 4, F > 1,604 at
//     Q = 8) the run-time path reads the window from device memory with
//     the same arithmetic.
//   - Weights: the rows of taps that fit beside the ring are staged in
//     shared memory, the centre row first (the passes read it `passes`
//     times), then the off-centre rows in dr order; the other rows are
//     read through the read-only path, so each row's loads are of one kind.
//     F = 257: all 7 rows; F = 513: 4; F = 2049: none. The table kernel
//     stages instead the stencil's period-Q table (K5's, below: its live
//     taps by Q columns, 148 x 8 float2 = 9,472 B at Q = 8, against 165
//     planes of 8,200 B at F = 1025, none of which fits beside the ring)
//     and its tap lists after the ring. A thread's bins share their column
//     (threads is a multiple of 32), so each weight is read once for its
//     bins; a full row of taps runs in two halves (the whole row's weights
//     and values spill at 2 bins), a partial one walks its live taps, and
//     dead taps (the no-future stencil's first row, the centre row's 9 of
//     11) are not summed.
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
// batch path; S = 8 on the longform path; 128 on the vocoder cell). Inside
// a step, the ring takes device-memory latency off the taps; what is left
// is shared-memory traffic (F = 257; the table kernel) and, where the
// weights do not fit, the weights through L2: (2Q-2 + passes)(2L+1) tap
// planes of 8F bytes per frame, 1.62 MB at F = 2049 into one SM (1.35 MB
// at Q = 8, F = 1025, before the table kernel), beside the 3 x 33
// shared-memory reads per bin and frame, all through the SM's one
// load/store pipe (PERF.md has the measured times). The table kernel takes
// the L2 reads and the run-time loops off Q = 8: per frame a thread issues
// 2 x 148 value and 148 weight reads from shared memory, with 17 warps per
// SM to hide them. Only splitting F across a thread-block cluster (a
// weight slice per CTA in shared memory, the +-L halo bins through
// distributed shared memory) removes the chain's floor; that is the next
// change.
//
// Built with -fmad=false so each product and sum rounds as in the plain
// PyTorch version (lws_torch/core/stencil.py). read_bin and the epilogue
// are shared with the online kernel (lws_common.cuh).
//
// The grouped kernel (K5, lws_packed_kernel) replaces the TPU kernel
// lws_tpu/ops/pallas_packed.py::packed_lws_sweeps (_sweeps_kernel, its
// group_update) at micro > 1, and serves lws_tpu's other entry points at
// micro > 1 too (tiled_lws_sweeps, segmented_lws_sweeps): it updates
// `micro` frames at a time, every one from the state as it was before the
// group (block Jacobi inside a group); the in-frame passes over the group's
// centre rows are jacobi passes whatever the scheme, as lws_tpu's group
// update runs them. At micro = 1 its wrapper launches lws_sweeps_kernel.
//   - The group's window, padded rows start .. start+micro+2Q-3, lives in a
//     ring of 2 micro + 2(Q-1) rows slotted by absolute padded row, each
//     row (re, im) interleaved with its L conjugate-reflected margin bins
//     (put_cbin), so a tap is one 8-byte shared-memory read with no branch.
//     While a group computes, each thread loads the next group's `micro`
//     new rows for its elements into slots this group does not read; they
//     are visible after the group's last barrier. The group's new centre
//     rows go to their ring slots and to device memory.
//   - Weights: a table of the stencil's live taps (off-centre rows in dr
//     order, then the centre row, each in dk order) by P columns, bin n
//     reading column n mod P: P = Q where the weights repeat with period Q
//     in the bin index (summarized weights, Stencil.period: LWS(512, 128)'s
//     60 live taps x 4 columns, 1.9 KB, against 158 KB of per-bin planes at
//     F = 257), else P = F (ops/online.py::weight_table builds it for K3 /
//     K4 and for K5). Dead taps are not summed.
//   - The micro x F elements (frame j, bin n) of a group are strided over
//     threads (bins = ceil(micro F / 768) per thread on round_up(ceil(micro
//     F / bins), 32) threads, e = tid, tid + threads, ...), so a warp loads
//     contiguous bins of a row; each element's (j, n) is computed once.
//     Where H F threads fit, H = ceil(micro / bins), the compile-time
//     kernel strides them by H F instead: a thread's elements are frames
//     h, h + H, ... of one bin and share each weight read (micro 4 at F =
//     257: 514 threads, frames h and h + 2).
//   - The compile-time kernel, (Q, L) = (4, 5) with P = Q at 1-3 elements
//     per thread (micro 2 and 4 at F = 257 and 513), keeps each element's
//     off-centre sums, original centre value and amp in registers across
//     the passes. A full row of taps (the batch stencil's outer rows) loads
//     its 11 weights and values at once, then sums them; a partial row (the
//     centre row's 2 live taps, rows 1 and 5's 7) walks its live-tap list,
//     loading no dead tap. A group is one barrier step for the off-centre
//     taps with the first pass (both read only the ring's old rows) and one
//     per further pass, the passes ping-ponging between two shared centre
//     buffers of `micro` rows, the last one writing the ring and device
//     memory (no pass re-reads the original centre row from device memory).
//   - Every other geometry (any Q <= 16, L and micro, fractional weights)
//     runs the run-time kernel: the same steps with run-time loops over
//     the elements and the live-tap lists, the off-centre sums kept per
//     element in memory, the last pass's rows committed to the ring and
//     device memory after a barrier. The ring, the table, the centre
//     buffers and the sums each sit in shared memory where they fit, else
//     in a device-memory scratch the wrapper allocates (the table: where it
//     is), read with the same arithmetic.
//   Each bin sums its live taps in the order the previous K5 summed every
//   tap (off-centre in (dr, dk) order, centre in dk order, phase_update):
//   a dead tap adds +-0 to a sum that is never -0, so with -fmad=false the
//   result is the same bit for bit (port_tools/cuda_on_cpu.py --old-packed
//   and port_tools/packed_timing.py hold the two to it). The launch plan
//   is packed_plan below; lws_packed_plan exports it, and
//   lws_torch/ops/packed.py::packed_plan mirrors it.
// K5 is bound like K1 by its serial chain: ceil(T / micro) groups per live
// sweep, each (1 + passes) steps of the old count, on B CTAs.

#include <cuda_runtime.h>

#include "lws_common.cuh"

namespace {

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
  int table;       // 1: (fixed) the weights come from the period-Q table in shared memory
  long long bytes; // dynamic shared memory
};

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// The plan for F bins, (Q, L) and a stencil of G live taps whose weights
// repeat with period P in the bin index (P = F: they do not).
SweepPlan sweep_plan(int F, int Q, int L, int G, int P) {
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
  // the (8, 5) table kernel: the table (G x P float2) and the tap lists
  // beside the ring; three bins (F > 2048) never leave room for the ring
  const long long table = (long long)sizeof(float2) * G * P +
                          (long long)sizeof(int) * (3LL * (2 * Q - 1) + G);
  p.table = p.ring && Q == 8 && L == 5 && P == Q && p.bins <= 2 &&
            p.threads <= kFixedThreads && used + table <= kSmemLimit;
  if (p.table) {
    p.staged = 0;
    p.fixed = 1;
    p.bytes = used + table;
    return p;
  }
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
  const float* wr;  // the tap planes (null for the table kernel)
  const float* wi;
  const float* thr;
  const int* live;
  int T, F, Q, L, iters, n_pass, color_k;
  int bins, width, staged;
  const float2* table;  // the table kernel's (G, Q) weight table and tap lists, as K5's
  const int* rows;
  const int* dks;
  int G;
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

// One row's live taps for this thread's bins from the period-KP weight
// table (the table kernel): the row's taps are table entries first ..
// first + count - 1, in dk order, and every bin of the thread reads column
// col (its bins n, n + threads, ... share n mod KP: threads is a multiple of
// 32). A full row (KK live taps) runs in two halves: a half's weights are
// loaded once, then each bin's values of that half, then their sums (the
// whole row at once holds 22 weight and 44 value registers at 2 bins, past
// the 80 of the 768-thread bound, and spills); a partial row walks its live
// taps. Each bin sums its taps in dk order, and a dead tap would add +-0 to
// a sum that is never -0, so the sums are K1's bit for bit.
template <int KK, int KP, int KB>
__device__ __forceinline__ void table_row(const float* rr, const float* ri,
                                          const float2* table, const int* dks, int col,
                                          int first, int count, const int (&nw)[KB],
                                          float (&acc_r)[KB], float (&acc_i)[KB]) {
  if (count == KK) {
    constexpr int KH = (KK + 1) / 2;
#pragma unroll
    for (int h = 0; h < KK; h += KH) {
      float2 wt[KH];
#pragma unroll
      for (int d = 0; d < KH; ++d)
        if (h + d < KK) wt[d] = table[(first + h + d) * KP + col];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float2 v[KH];
#pragma unroll
        for (int d = 0; d < KH; ++d)
          if (h + d < KK) v[d] = float2{rr[nw[j] + h + d], ri[nw[j] + h + d]};
#pragma unroll
        for (int d = 0; d < KH; ++d)
          if (h + d < KK) cmac(acc_r[j], acc_i[j], wt[d], v[d]);
      }
    }
  } else {
#pragma unroll 4
    for (int g = first; g < first + count; ++g) {
      const int dk = dks[g];
      const float2 w = table[g * KP + col];
#pragma unroll
      for (int j = 0; j < KB; ++j)
        cmac(acc_r[j], acc_i[j], w, float2{rr[nw[j] + dk], ri[nw[j] + dk]});
    }
  }
}

// ---------------------------------------------------------------------------
// K1: the kernel. KQ, KL, KNB > 0 fix Q, L and the bins per thread at
// compile time; 0 takes them from the arguments. kRing: the window in
// shared memory (else in device memory, run-time path only). kAllStaged:
// every row of taps is in shared memory, and the kernel holds no path that
// reads weights from device memory. kTable: the weights come from the
// period-KQ table (its live taps only) staged in shared memory after the
// ring, in place of the tap planes.
template <int KQ, int KL, int KNB, bool kRing, bool kAllStaged, bool kTable = false>
__global__ void __launch_bounds__(KQ > 0 ? kFixedThreads : kMaxThreads, 1)
    lws_sweeps_kernel(SweepArgs a) {
  static_assert(KQ == 0 || (kRing && KNB > 0), "the fixed kernels keep the ring");
  static_assert(!kTable || (KQ > 0 && !kAllStaged), "the table kernel is a fixed one");
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

  // shared memory: two ping-pong centre rows, the ring, then the staged
  // rows of taps, or (kTable) the weight table and its tap lists
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
  float2* s_table = reinterpret_cast<float2*>(s_wr);
  int* s_rows = reinterpret_cast<int*>(s_table + a.G * KQ);  // per row: mask, first, count
  int* s_dks = s_rows + 3 * R;
  if constexpr (kTable) {
    for (int i = tid; i < a.G * KQ; i += nth) s_table[i] = __ldg(a.table + i);
    for (int i = tid; i < 3 * R; i += nth) s_rows[i] = __ldg(a.rows + i);
    for (int i = tid; i < a.G; i += nth) s_dks[i] = __ldg(a.dks + i);
  }
  const int col = tid % (KQ > 0 ? KQ : 1);  // the table column of all this thread's bins

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
    __syncthreads();  // the window and the staged taps (or the table) are complete

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
        if (dr == Q1 || (kTable && s_rows[3 * dr + 2] == 0)) continue;
        int slot = base + dr;
        slot = slot >= S ? slot - S : slot;
        const float* rr = kRing ? ring + 2 * slot * W : Xr + (size_t)(m + dr) * F;
        const float* ri = kRing ? rr + W : Xi + (size_t)(m + dr) * F;
        const int rank = 1 + (dr < Q1 ? dr : dr - 1);  // the row's staging rank
        if constexpr (kTable) {
          table_row<kK, KQ>(rr, ri, s_table, s_dks, col, s_rows[3 * dr + 1],
                            s_rows[3 * dr + 2], nw, tr, ti);
        } else if (kAllStaged || rank < staged_rows) {
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
        if constexpr (kTable) {
          table_row<kK, KQ>(src_r, src_i, s_table, s_dks, col, s_rows[3 * Q1 + 1],
                            s_rows[3 * Q1 + 2], nw, cr, ci);
        } else if (kAllStaged || cen_staged) {
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

// The kernel sweep_plan picks: the table kernel at (8, 5) and 1-2 bins per
// thread; a fixed one for (Q, L) = (4, 5) or (2, 5) at 1-3 bins per thread
// on at most kFixedThreads threads with the ring (at 1 bin with every row
// staged, the one without device-memory weights); else the run-time one.
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
  if (p.table)
    return p.bins == 1 ? lws_sweeps_kernel<8, 5, 1, true, false, true>
                       : lws_sweeps_kernel<8, 5, 2, true, false, true>;
  if (p.fixed) return Q == 4 ? fixed_kernel<4>(p) : fixed_kernel<2>(p);
  if (!p.ring) return lws_sweeps_kernel<0, 0, 0, false, false>;
  if (p.bins == 1) return lws_sweeps_kernel<0, 0, 1, true, false>;
  return lws_sweeps_kernel<0, 0, 0, true, false>;
}

// ---------------------------------------------------------------------------
// K5: the launch plan.

// Most threads of a K5 launch: the elements (frame, bin) of a group are
// spread over at most this many. It is the kernels' launch bound, which
// (with one block per SM) leaves them 80 registers a thread.
constexpr int kPackedThreads = 768;

struct PackedPlan {
  int bins;          // elements of a group per thread, strided: tid, tid + stride, ...
  int threads;       // round_up(ceil(micro F / bins), 32), or round_up(stride, 32)
  int stride;        // threads, or H F with H = ceil(micro / bins) where a thread's
                     // elements then share their bin (shared)
  int width;         // float2 per ring or centre row: F and L margin bins each side
  int slots;         // ring rows: 2 micro + 2(Q-1)
  int ring;          // 1: the ring in shared memory (else in the device-memory scratch)
  int table;         // 1: the weight table in shared memory (else read where it is)
  int centre;        // 1: the two centre buffers of micro rows in shared memory
  int sums;          // 1: the run-time kernel's off-centre sums in shared memory
  int fixed;         // 1: the compile-time (4, 5) kernel runs
  int shared;        // 1: (fixed) a thread's elements are frames h, h + H, ... of one bin
  long long bytes;   // dynamic shared memory
  long long scratch; // float2 per CTA in device memory: what does not fit shared memory
};

// The plan for F bins, (Q, L), `micro` frames a group and a table of G live
// taps by P columns. Always in shared memory: the tap lists. The
// compile-time kernel ((Q, L) = (4, 5), P = Q, at most 3 elements per
// thread) needs the ring, the centre buffers and the table there too, and
// keeps the off-centre sums in registers; otherwise the ring, the table,
// the centre buffers and the sums each go to shared memory where they
// still fit, in that order, and the rest (but the table) to the scratch.
PackedPlan packed_plan(int F, int Q, int L, int micro, int G, int P) {
  PackedPlan p;
  const long long E = (long long)micro * F;
  p.bins = (int)((E + kPackedThreads - 1) / kPackedThreads);
  p.threads = (int)(((E + p.bins - 1) / p.bins + 31) / 32 * 32);
  p.stride = p.threads;
  p.shared = 0;
  p.width = F + 2 * L;
  p.slots = 2 * micro + 2 * (Q - 1);
  const long long f2 = (long long)sizeof(float2);
  const long long ring = f2 * p.slots * p.width;
  const long long centre = f2 * 2 * micro * p.width;
  const long long table = f2 * G * P;
  const long long sums = f2 * E;
  long long used = (long long)sizeof(int) * (3LL * (2 * Q - 1) + G);
  p.fixed = Q == 4 && L == 5 && P == Q && p.bins <= 3 &&
            used + ring + centre + table <= kSmemLimit;
  if (p.fixed) {
    p.ring = p.table = p.centre = 1;
    p.sums = 0;
    used += ring + centre + table;
    // a thread's elements share their bin (and weights) where H F threads,
    // H = ceil(micro / bins), take the stride H F
    const int H = (micro + p.bins - 1) / p.bins;
    p.shared = p.bins > 1 && (long long)H * F <= kPackedThreads;
    p.stride = p.shared ? H * F : p.threads;
    p.threads = p.shared ? (H * F + 31) / 32 * 32 : p.threads;
  } else {
    p.ring = used + ring <= kSmemLimit;
    used += p.ring ? ring : 0;
    p.table = used + table <= kSmemLimit;
    used += p.table ? table : 0;
    p.centre = used + centre <= kSmemLimit;
    used += p.centre ? centre : 0;
    p.sums = used + sums <= kSmemLimit;
    used += p.sums ? sums : 0;
  }
  p.bytes = used;
  p.scratch = ((p.ring ? 0 : ring) + (p.centre ? 0 : centre) +
               (p.fixed || p.sums ? 0 : sums)) / f2;
  return p;
}

bool packed_fits(const PackedPlan& p) { return p.bytes <= kSmemLimit; }

struct PackedArgs {
  float* xr;  // the padded state (B, T + 2(Q-1), F), updated in place
  float* xi;
  const float* amp;     // (B, T, F)
  const float2* table;  // (G, P): live tap g, column p
  const int* rows;      // (2Q-1, 3): per row of taps, its live-dk mask, first tap, count
  const int* dks;       // (G): the dk of each live tap
  const float* thr;     // (B, iters)
  const int* live;      // (B, iters)
  float2* scratch;      // (B, scratch) or null
  long long scratch_per_cta;
  int T, F, Q, L, iters, micro, n_pass, G, P, stride;
  int width, slots, ring_smem, table_smem, centre_smem, sums_smem;  // from the plan
};

// One CTA's buffers: the ring (S, W), the centre buffers (2, micro, W), the
// table (G, P), the run-time kernel's sums (micro, F) (shared memory or the
// CTA's slice of the scratch), the tap lists (shared memory). Shared memory
// holds, in order, those of the ring, centre buffers, table and sums that
// it holds, then the lists; kFixed: the ring, centre buffers and table.
template <bool kFixed>
__device__ __forceinline__ void packed_buffers(float* smem, const PackedArgs& a, float2*& ring,
                                               float2*& centre, const float2*& table,
                                               float2*& sums, const int*& rows,
                                               const int*& dks) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  float2* at = reinterpret_cast<float2*>(smem);
  float2* sc = a.scratch ? a.scratch + blockIdx.x * a.scratch_per_cta : nullptr;
  const long long n_ring = (long long)a.slots * a.width;
  const long long n_centre = 2LL * a.micro * a.width;
  if (kFixed || a.ring_smem) {
    ring = at;
    at += n_ring;
  } else {
    ring = sc;
    sc += n_ring;
  }
  if (kFixed || a.centre_smem) {
    centre = at;
    at += n_centre;
  } else {
    centre = sc;
    sc += n_centre;
  }
  if (kFixed || a.table_smem) {
    for (int i = tid; i < a.G * a.P; i += nth) at[i] = __ldg(a.table + i);
    table = at;
    at += a.G * a.P;
  } else {
    table = a.table;
  }
  sums = nullptr;
  if (!kFixed) {
    if (a.sums_smem) {
      sums = at;
      at += (long long)a.micro * a.F;
    } else {
      sums = sc;
    }
  }
  int* lists = reinterpret_cast<int*>(at);
  const int nr = 3 * (2 * a.Q - 1);
  for (int i = tid; i < nr; i += nth) lists[i] = __ldg(a.rows + i);
  for (int i = tid; i < a.G; i += nth) lists[nr + i] = __ldg(a.dks + i);
  rows = lists;
  dks = lists + nr;
}

// A sweep's first window: padded rows 0 .. n_rows-1 into ring slots 0 ..
// n_rows-1 (n_rows <= slots).
__device__ __forceinline__ void load_window(float2* ring, const float* Xr, const float* Xi,
                                            int n_rows, int F, int L, int W) {
  for (int i = threadIdx.x; i < n_rows * F; i += blockDim.x) {
    const int r = i / F;
    const int n = i - r * F;
    put_cbin(ring + (size_t)r * W, n, F, L, Xr[(size_t)r * F + n], Xi[(size_t)r * F + n]);
  }
}

// One row of live taps of the compile-time kernel for the thread's KNB
// elements, KK = 2L+1: element k's row at row[k] (row[k][dk] is bin
// n_k + dk - L), its weights from column col[k] (the row's live taps at
// table indices first .. first + count - 1, in dk order). A full row
// (every tap live: the batch stencil's outer rows) loads its KK weights
// and an element's KK values at once, then sums them; a partial one (the
// centre row's 2 live taps, the 7 of rows 1 and 5) walks its live taps.
// kShared: the elements share their bin, so each weight is loaded once for
// all of them. The branch is uniform over the CTA.
template <int KK, int KP, int KNB, bool kShared>
__device__ __forceinline__ void packed_rows(const float2* const (&row)[KNB],
                                            const float2* table, const int* dks,
                                            const int (&col)[KNB], int first, int count,
                                            float (&ar)[KNB], float (&ai)[KNB]) {
  if (count == KK) {
    float2 wt[KK];
    if constexpr (kShared) {
#pragma unroll
      for (int dk = 0; dk < KK; ++dk) wt[dk] = table[(first + dk) * KP + col[0]];
    }
#pragma unroll
    for (int k = 0; k < KNB; ++k) {
      if constexpr (!kShared) {
#pragma unroll
        for (int dk = 0; dk < KK; ++dk) wt[dk] = table[(first + dk) * KP + col[k]];
      }
      float2 v[KK];
#pragma unroll
      for (int dk = 0; dk < KK; ++dk) v[dk] = row[k][dk];
#pragma unroll
      for (int dk = 0; dk < KK; ++dk) cmac(ar[k], ai[k], wt[dk], v[dk]);
    }
  } else {
#pragma unroll 4
    for (int g = first; g < first + count; ++g) {
      const int dk = dks[g];
#pragma unroll
      for (int k = 0; k < KNB; ++k)
        cmac(ar[k], ai[k], table[g * KP + col[kShared ? 0 : k]], row[k][dk]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: the compile-time kernel's sweeps, (Q, L) = (4, 5), P = Q, KNB elements
// per thread in registers.
template <int KNB, bool kShared>
__device__ __forceinline__ void packed_fixed(const PackedArgs& a, float* Xr, float* Xi,
                                             const float* __restrict__ A, float2* ring,
                                             float2* centre, const float2* table,
                                             const int* rows, const int* dks) {
  constexpr int KQ = 4, KL = 5, KK = 2 * KL + 1, Q1 = KQ - 1, R = 2 * KQ - 1;
  const int F = a.F;
  const int T = a.T;
  const int M = a.micro;
  const int W = a.width;
  const int S = a.slots;
  const int E = M * F;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int b = blockIdx.x;

  // this thread's elements e = tid + k * stride: frame j, bin n, column n
  // mod Q; those past E (and the threads past the stride) are clamped to the
  // last element and write nothing
  int ej[KNB], en[KNB], col[KNB];
  bool real[KNB];
#pragma unroll
  for (int k = 0; k < KNB; ++k) {
    const int e = tid + k * a.stride;
    real[k] = tid < a.stride && e < E;
    const int c = real[k] ? e : E - 1;
    ej[k] = c / F;
    en[k] = c - ej[k] * F;
    col[k] = en[k] % KQ;
  }
  const float2* rp[KNB];
  const int cfirst = rows[3 * Q1 + 1];
  const int ccount = rows[3 * Q1 + 2];

  for (int it = 0; it < a.iters; ++it) {
    if (__ldg(a.live + b * a.iters + it) == 0) continue;  // uniform over the CTA
    const float th = __ldg(a.thr + b * a.iters + it);
    load_window(ring, Xr, Xi, (M < T ? M : T) + 2 * Q1, F, KL, W);
    __syncthreads();  // the window is complete

    int base = 0;  // ring slot of padded row `start`
    for (int start = 0; start < T; start += M) {
      const int g = T - start < M ? T - start : M;
      // the next group's new row for each element (row start+M+2Q-2+j,
      // frame start+M+Q-1+j, which no frame before it has written this
      // sweep): its loads overlap this group's taps; and amp
      float fr[KNB], fi[KNB], am[KNB];
#pragma unroll
      for (int k = 0; k < KNB; ++k) {
        if (real[k] && start + M + ej[k] < T) {
          const size_t at = (size_t)(start + M + 2 * Q1 + ej[k]) * F + en[k];
          fr[k] = Xr[at];
          fi[k] = Xi[at];
        }
        const int m = start + ej[k] < T ? start + ej[k] : T - 1;
        am[k] = __ldg(A + (size_t)m * F + en[k]);
      }

      // off-centre taps, in (dr, dk) order per element; one row at a time
      float tr[KNB], ti[KNB];
#pragma unroll
      for (int k = 0; k < KNB; ++k) {
        tr[k] = 0.f;
        ti[k] = 0.f;
      }
#pragma unroll 1
      for (int dr = 0; dr < R; ++dr) {
        const int count = rows[3 * dr + 2];
        if (dr == Q1 || count == 0) continue;
        const int first = rows[3 * dr + 1];
#pragma unroll
        for (int k = 0; k < KNB; ++k) {
          int sl = base + ej[k] + dr;
          sl = sl >= S ? sl - S : sl;
          rp[k] = ring + (size_t)sl * W + en[k];
        }
        packed_rows<KK, KQ, KNB, kShared>(rp, table, dks, col, first, count, tr, ti);
      }

      // the first pass (or, without centre taps, the epilogue alone), from
      // the ring's centre rows: this group's old values, which every
      // element falls back to
      int cs[KNB];
      float orr[KNB], ori[KNB], nr[KNB], ni[KNB], cr[KNB], ci[KNB];
#pragma unroll
      for (int k = 0; k < KNB; ++k) {
        const int c = base + ej[k] + Q1;
        cs[k] = c >= S ? c - S : c;
        const float2 o = ring[(size_t)cs[k] * W + en[k] + KL];
        orr[k] = o.x;
        ori[k] = o.y;
        nr[k] = o.x;
        ni[k] = o.y;
        rp[k] = ring + (size_t)cs[k] * W + en[k];
        cr[k] = 0.f;
        ci[k] = 0.f;
      }
      if (a.n_pass > 0)
        packed_rows<KK, KQ, KNB, kShared>(rp, table, dks, col, cfirst, ccount, cr, ci);
#pragma unroll
      for (int k = 0; k < KNB; ++k) {
        if (a.n_pass == 0)
          phase_update(tr[k], ti[k], am[k], th, nr[k], ni[k]);
        else
          phase_update(tr[k] + cr[k], ti[k] + ci[k], am[k], th, nr[k], ni[k]);
      }
      // the next group's new rows land in slots this group does not read
#pragma unroll
      for (int k = 0; k < KNB; ++k) {
        if (real[k] && start + M + ej[k] < T) {
          int fs = base + M + 2 * Q1 + ej[k];
          fs = fs >= S ? fs - S : fs;
          put_cbin(ring + (size_t)fs * W, en[k], F, KL, fr[k], fi[k]);
        }
      }

      if (a.n_pass <= 1) {
        __syncthreads();  // every read of the group's old rows precedes the writes
#pragma unroll
        for (int k = 0; k < KNB; ++k) {
          if (real[k] && ej[k] < g) {
            put_cbin(ring + (size_t)cs[k] * W, en[k], F, KL, nr[k], ni[k]);
            Xr[(size_t)(start + ej[k] + Q1) * F + en[k]] = nr[k];
            Xi[(size_t)(start + ej[k] + Q1) * F + en[k]] = ni[k];
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < KNB; ++k)
          if (real[k] && ej[k] < g)
            put_cbin(centre + (size_t)ej[k] * W, en[k], F, KL, nr[k], ni[k]);
        for (int p = 1; p < a.n_pass; ++p) {
          __syncthreads();  // the rows this pass reads are complete
          const float2* src = centre + (size_t)((p - 1) & 1) * M * W;
          float2* dst = centre + (size_t)(p & 1) * M * W;
          const bool last = p + 1 == a.n_pass;
#pragma unroll
          for (int k = 0; k < KNB; ++k) {
            rp[k] = src + (size_t)ej[k] * W + en[k];
            cr[k] = 0.f;
            ci[k] = 0.f;
          }
          packed_rows<KK, KQ, KNB, kShared>(rp, table, dks, col, cfirst, ccount, cr, ci);
#pragma unroll
          for (int k = 0; k < KNB; ++k) {
            // jacobi: the fallback is the original centre value
            nr[k] = orr[k];
            ni[k] = ori[k];
            phase_update(tr[k] + cr[k], ti[k] + ci[k], am[k], th, nr[k], ni[k]);
          }
#pragma unroll
          for (int k = 0; k < KNB; ++k) {
            if (!(real[k] && ej[k] < g)) continue;
            if (last) {
              put_cbin(ring + (size_t)cs[k] * W, en[k], F, KL, nr[k], ni[k]);
              Xr[(size_t)(start + ej[k] + Q1) * F + en[k]] = nr[k];
              Xi[(size_t)(start + ej[k] + Q1) * F + en[k]] = ni[k];
            } else {
              put_cbin(dst + (size_t)ej[k] * W, en[k], F, KL, nr[k], ni[k]);
            }
          }
        }
      }
      __syncthreads();  // the group is written before the next group reads it
      base += M;
      base = base >= S ? base - S : base;
    }
  }
}

// ---------------------------------------------------------------------------
// K5: the run-time kernel's sweeps: any Q, L, micro and table; the elements
// in run-time loops, their off-centre sums in `sums`.

// The live taps of row `row` (row[dk] is bin n + dk - L) in dk order, from
// table column col: tap indices first .. first + count - 1.
__device__ __forceinline__ void packed_taps(const float2* row, const float2* table,
                                            const int* dks, int P, int col, int first,
                                            int count, float& ar, float& ai) {
  for (int g = first; g < first + count; ++g) cmac(ar, ai, table[(size_t)g * P + col], row[dks[g]]);
}

__device__ __forceinline__ void packed_runtime(const PackedArgs& a, float* Xr, float* Xi,
                                               const float* __restrict__ A, float2* ring,
                                               float2* centre, const float2* table,
                                               float2* sums, const int* rows, const int* dks) {
  const int F = a.F;
  const int T = a.T;
  const int M = a.micro;
  const int W = a.width;
  const int S = a.slots;
  const int L = a.L;
  const int P = a.P;
  const int Q1 = a.Q - 1;
  const int R = 2 * a.Q - 1;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int b = blockIdx.x;
  const int cfirst = rows[3 * Q1 + 1];
  const int ccount = rows[3 * Q1 + 2];
  const size_t MW = (size_t)M * W;

  for (int it = 0; it < a.iters; ++it) {
    if (__ldg(a.live + b * a.iters + it) == 0) continue;  // uniform over the CTA
    const float th = __ldg(a.thr + b * a.iters + it);
    load_window(ring, Xr, Xi, (M < T ? M : T) + 2 * Q1, F, L, W);
    __syncthreads();  // the window is complete

    int base = 0;  // ring slot of padded row `start`
    for (int start = 0; start < T; start += M) {
      const int gF = (T - start < M ? T - start : M) * F;
      // every element's off-centre taps and first step, from the ring's old
      // rows, into centre buffer 0
      for (int e = tid; e < gF; e += nth) {
        const int j = e / F;
        const int n = e - j * F;
        const int col = n % P;
        float tr = 0.f, ti = 0.f;
        for (int dr = 0; dr < R; ++dr) {
          if (dr == Q1) continue;
          int sl = base + j + dr;
          sl = sl >= S ? sl - S : sl;
          packed_taps(ring + (size_t)sl * W + n, table, dks, P, col, rows[3 * dr + 1],
                      rows[3 * dr + 2], tr, ti);
        }
        int cs = base + j + Q1;
        cs = cs >= S ? cs - S : cs;
        const float2 o = ring[(size_t)cs * W + n + L];
        const float am = __ldg(A + (size_t)(start + j) * F + n);
        float nr = o.x, ni = o.y;
        if (a.n_pass == 0) {
          phase_update(tr, ti, am, th, nr, ni);
        } else {
          sums[e] = float2{tr, ti};
          float cr = 0.f, ci = 0.f;
          packed_taps(ring + (size_t)cs * W + n, table, dks, P, col, cfirst, ccount, cr, ci);
          phase_update(tr + cr, ti + ci, am, th, nr, ni);
        }
        put_cbin(centre + (size_t)j * W, n, F, L, nr, ni);
      }
      __syncthreads();  // the rows the next pass reads are complete
      for (int p = 1; p < a.n_pass; ++p) {
        const float2* src = centre + ((p - 1) & 1) * MW;
        float2* dst = centre + (p & 1) * MW;
        for (int e = tid; e < gF; e += nth) {
          const int j = e / F;
          const int n = e - j * F;
          int cs = base + j + Q1;
          cs = cs >= S ? cs - S : cs;
          const float2 o = ring[(size_t)cs * W + n + L];  // old until the commit
          const float2 s = sums[e];
          float cr = 0.f, ci = 0.f;
          packed_taps(src + (size_t)j * W + n, table, dks, P, n % P, cfirst, ccount, cr, ci);
          float nr = o.x, ni = o.y;
          phase_update(s.x + cr, s.y + ci, __ldg(A + (size_t)(start + j) * F + n), th, nr, ni);
          put_cbin(dst + (size_t)j * W, n, F, L, nr, ni);
        }
        __syncthreads();  // the pass is written before the next one reads it
      }
      // commit the last rows to the ring and device memory, and load the
      // next group's new rows into the slots this group did not read
      const float2* done = centre + ((a.n_pass > 1 ? a.n_pass - 1 : 0) & 1) * MW;
      for (int e = tid; e < gF; e += nth) {
        const int j = e / F;
        const int n = e - j * F;
        int cs = base + j + Q1;
        cs = cs >= S ? cs - S : cs;
        const float2 v = done[(size_t)j * W + n + L];
        put_cbin(ring + (size_t)cs * W, n, F, L, v.x, v.y);
        Xr[(size_t)(start + j + Q1) * F + n] = v.x;
        Xi[(size_t)(start + j + Q1) * F + n] = v.y;
      }
      const int next = T - start - M;
      for (int e = tid; e < (next < M ? next : M) * F; e += nth) {
        const int j = e / F;
        const int n = e - j * F;
        int fs = base + M + 2 * Q1 + j;
        fs = fs >= S ? fs - S : fs;
        const size_t at = (size_t)(start + M + 2 * Q1 + j) * F + n;
        put_cbin(ring + (size_t)fs * W, n, F, L, Xr[at], Xi[at]);
      }
      __syncthreads();  // the group is written before the next group reads it
      base += M;
      base = base >= S ? base - S : base;
    }
  }
}

// K5. KQ, KL, KNB > 0: the compile-time kernel ((4, 5), KNB elements per
// thread, sharing their bin where kShared); 0: the run-time one.
template <int KQ, int KL, int KNB, bool kShared>
__global__ void __launch_bounds__(kPackedThreads, 1) lws_packed_kernel(PackedArgs a) {
  static_assert(KQ == 0 || (KQ == 4 && KL == 5 && KNB > 0), "one compile-time geometry");
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const size_t plane = (size_t)(a.T + 2 * (a.Q - 1)) * a.F;
  float* Xr = a.xr + b * plane;
  float* Xi = a.xi + b * plane;
  const float* A = a.amp + (size_t)b * a.T * a.F;
  float2 *ring, *centre, *sums;
  const float2* table;
  const int *rows, *dks;
  packed_buffers<(KQ > 0)>(smem, a, ring, centre, table, sums, rows, dks);
  __syncthreads();  // the table and the tap lists are in place
  if constexpr (KQ > 0) {
    packed_fixed<KNB, kShared>(a, Xr, Xi, A, ring, centre, table, rows, dks);
  } else {
    packed_runtime(a, Xr, Xi, A, ring, centre, table, sums, rows, dks);
  }
}

typedef void (*PackedKernel)(PackedArgs);

PackedKernel pick_packed(const PackedPlan& p) {
  if (p.fixed) {
    if (p.bins == 1) return lws_packed_kernel<4, 5, 1, false>;
    if (p.bins == 2)
      return p.shared ? lws_packed_kernel<4, 5, 2, true> : lws_packed_kernel<4, 5, 2, false>;
    return p.shared ? lws_packed_kernel<4, 5, 3, true> : lws_packed_kernel<4, 5, 3, false>;
  }
  return lws_packed_kernel<0, 0, 0, false>;
}

}  // namespace

extern "C" {

// Runs `iters` sweeps over the padded state (xr, xi) in place on `stream`,
// for a stencil of G live taps whose weights repeat with period P in the bin
// index (P = F: they do not). The weights: the tap planes (wr, wi), or,
// where the plan picks the table kernel, the (G, P) weight table with its
// tap lists (rows (2Q-1, 3), dks (G)); the other may be null. Returns the
// cudaError_t of the launch (0 on success); a shared-memory plan that does
// not fit one block, or missing weights, is cudaErrorInvalidValue.
int lws_sweeps_launch(void* xr, void* xi, const void* amp, const void* wr,
                      const void* wi, const void* table, const void* rows, const void* dks,
                      const void* thr, const void* live, int B, int T, int F, int Q, int L,
                      int iters, int passes, int color_k, int color_rounds, int has_centre,
                      int G, int P, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || L < 0 || F < L + 1 || iters < 0 || passes < 1 ||
      color_k < 0 || color_rounds < 1 || G < 0 || P < 1 || P > F) {
    return (int)cudaErrorInvalidValue;
  }
  if (iters == 0) return (int)cudaSuccess;
  const SweepPlan p = sweep_plan(F, Q, L, G, P);
  if (p.bytes > kSmemLimit || p.bins > kMaxBins ||
      (p.table ? !table || !rows || !dks : !wr || !wi)) {
    return (int)cudaErrorInvalidValue;
  }
  SweepArgs a;
  a.xr = (float*)xr;
  a.xi = (float*)xi;
  a.amp = (const float*)amp;
  a.wr = (const float*)wr;
  a.wi = (const float*)wi;
  a.table = (const float2*)table;
  a.rows = (const int*)rows;
  a.dks = (const int*)dks;
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
  a.G = G;
  const SweepKernel kernel = pick_kernel(p, Q);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, p.threads, (size_t)p.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K1's launch plan for (F, Q, L) and a stencil of G live taps of period P
// into out[0..8]: bins per thread, threads, row width, ring (0/1), staged
// tap planes, taps, fixed kernel (0/1), table kernel (0/1), shared-memory
// bytes. Returns 0 when it fits one block, else cudaErrorInvalidValue.
int lws_sweeps_plan(int F, int Q, int L, int G, int P, long long* out) {
  if (F < 1 || Q < 1 || L < 0 || G < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const SweepPlan p = sweep_plan(F, Q, L, G, P);
  const long long v[9] = {p.bins, p.threads, p.width, p.ring,  p.staged,
                          p.taps, p.fixed,   p.table, p.bytes};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return p.bytes <= kSmemLimit && p.bins <= kMaxBins ? (int)cudaSuccess
                                                     : (int)cudaErrorInvalidValue;
}

// Blocks of the kernel lws_sweeps_launch runs for (F, Q, L, G, P) that one
// SM of the current device holds at once, as the CUDA runtime counts them
// (its registers, its dynamic shared memory, its threads) into *blocks.
// Returns the cudaError_t of the query; a plan that does not fit one block
// is cudaErrorInvalidValue.
int lws_sweeps_occupancy(int F, int Q, int L, int G, int P, int* blocks) {
  *blocks = 0;
  if (F < 1 || Q < 1 || L < 0 || G < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const SweepPlan p = sweep_plan(F, Q, L, G, P);
  if (p.bytes > kSmemLimit || p.bins > kMaxBins) return (int)cudaErrorInvalidValue;
  const SweepKernel kernel = pick_kernel(p, Q);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, p.threads,
                                                            (size_t)p.bytes);
}

// K5's launch plan for (F, Q, L, micro) and a table of G live taps by P
// columns into out[0..12]: elements per thread, threads, element stride,
// row width, ring slots, ring, table, centre buffers and sums in shared
// memory (0/1), fixed kernel (0/1), shared bins (0/1), shared-memory bytes,
// scratch float2 per CTA. Returns 0 when it fits one block, else
// cudaErrorInvalidValue.
int lws_packed_plan(int F, int Q, int L, int micro, int G, int P, long long* out) {
  if (F < 1 || Q < 1 || L < 0 || micro < 1 || G < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const PackedPlan p = packed_plan(F, Q, L, micro, G, P);
  const long long v[13] = {p.bins,  p.threads, p.stride, p.width, p.slots,
                           p.ring,  p.table,   p.centre, p.sums,  p.fixed,
                           p.shared, p.bytes,  p.scratch};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return packed_fits(p) ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// The grouped sweeps (K5) over the same padded state as lws_sweeps_launch,
// `micro` >= 2 frames per group (a group past T holds T frames), `passes`
// jacobi passes where the stencil has centre taps, the weights as a table
// (G, P) with its tap lists (rows (2Q-1, 3), dks (G)); `scratch` holds B x
// the plan's scratch float2 (may be null when that is 0). Returns the
// cudaError_t of the launch (0 on success).
int lws_packed_launch(void* xr, void* xi, const void* amp, const void* table,
                      const void* rows, const void* dks, const void* thr, const void* live,
                      void* scratch, int B, int T, int F, int Q, int L, int iters, int micro,
                      int passes, int has_centre, int G, int P, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || Q > kMaxQ || L < 0 || F < L + 1 || iters < 0 ||
      micro < 2 || passes < 1 || G < 0 || P < 1 || P > F) {
    return (int)cudaErrorInvalidValue;
  }
  if (iters == 0) return (int)cudaSuccess;
  const int M = micro < T ? micro : T;
  const PackedPlan p = packed_plan(F, Q, L, M, G, P);
  if (!packed_fits(p) || (p.scratch > 0 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  PackedArgs a = {};
  a.xr = (float*)xr;
  a.xi = (float*)xi;
  a.amp = (const float*)amp;
  a.table = (const float2*)table;
  a.rows = (const int*)rows;
  a.dks = (const int*)dks;
  a.thr = (const float*)thr;
  a.live = (const int*)live;
  a.scratch = (float2*)scratch;
  a.scratch_per_cta = p.scratch;
  a.T = T;
  a.F = F;
  a.Q = Q;
  a.L = L;
  a.iters = iters;
  a.micro = M;
  a.n_pass = has_centre ? passes : 0;
  a.G = G;
  a.P = P;
  a.stride = p.stride;
  a.width = p.width;
  a.slots = p.slots;
  a.ring_smem = p.ring;
  a.table_smem = p.table;
  a.centre_smem = p.centre;
  a.sums_smem = p.sums;
  const PackedKernel kernel = pick_packed(p);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, p.threads, (size_t)p.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* lws_sweeps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
