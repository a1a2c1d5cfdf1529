// Online RTISI-LA (TF-domain, look-ahead LA) on Hopper (sm_90a): two kernels.
//
// K3, lws_online_kernel, replaces the TPU kernel
// lws_tpu/ops/pallas_packed.py::packed_rtisi_la (_online_kernel, its row
// updates _online_row_update_fns). It computes what the frame-commit loop
// lws_torch/core/online.py::rtisi_la computes, not the TPU's sublane packs,
// lane padding or VMEM plan:
//
//   for each newest frame m = 0..T-1:
//     update frame m with set 0 (asym-init, v = -1) at threshold 0;
//     `iters` rounds h, each:
//       update frames m-d, d = LA..1 (skipped when m-d < 0), with set
//       2+d-1 (the batch stencil at visibility min(d, Q-1));
//       update frame m with set 1 (asym-full, v = 0);
//       threshold thr[b, h] = thresholds[h] * mean |S[b]|;
//     frame m-LA is final: commit it to the output.
//   then commit the last LA frames.
//
// K4, lws_online_chunk_kernel, replaces
// lws_tpu/ops/pallas_packed.py::online_chunk (_online_chunk_kernel): the
// same schedule over a chunk of N frames of a stream, the plain version
// being lws_torch/core/online.py::online_chunk. It differs from K3 in four
// ways: the ring and the amp rows of the last LA+1 frames come in from a
// state and go back out to it, with frame slots taken from the absolute
// frame index (`seen` + m), so a chunk boundary is invisible to the
// arithmetic; the threshold of step m is thr[b, m, h], the stream's running
// mean at frame m; steps m >= n_live are drain steps (the frame enters the
// ring with amp 0, nothing is updated); and step m commits frame m-LA to
// output row m, whatever it holds (the host drops rows before the stream
// start and past its last live frame).
//
// A frame update (row_update, shared by K3 and K4) is the sweep kernel's:
// off-centre taps first, in (dr, dk) order, then the centre row's taps,
// `passes` jacobi re-passes (fallback: the original row) or color_k x
// color_rounds red-black rounds (fallback: the evolving row), then the
// rsqrt epilogue. Only live taps are summed, each bin's in that order, so
// K3 and K4 agree bit for bit with the same amp, thresholds and ring, and
// both agree bit for bit with the previous design of this file (per-bin
// weight planes through L2, revision 4c91317);
// port_tools/cuda_on_cpu.py --old-online holds them to it.
//
// Layout: input, amp and output are (B, T, F); the output is a buffer of
// its own, so a committed row is never read back as input. The weights of
// the 2+LA sets are a table (G, P) of (re, im) pairs: G live taps (each
// set's live off-centre taps in (dr, dk) order, then its live centre taps)
// by P columns, bin n using column n mod P. P = Q where every bin's weights
// equal those of bin n mod Q (summarized weights, the library default: 6.9
// KB at Q = 4, LA = 3, against 886 KB of per-bin planes at F = 513), else
// P = F. `rows` (S, 2Q-1, 3) holds, per set and row of taps, the bit mask
// of its live dk (used where 2L+1 <= 32), the table index of its first live
// tap and its count; `dks` (G) the dk of each live tap.
//
// Design: one CTA per utterance (K3) or stream (K4), strided bins n = tid +
// j * threads, j < bins (the plan below). The frames a step can read,
// m-LA-(Q-1) .. m, are a ring of WR = LA+Q rows indexed by absolute frame
// modulo WR: loading frame m overwrites frame m-WR, which no update reads
// any more. Slots of frames before the start hold frame 0's input, as the
// plain version's frozen edge-replica halo rows, and are never updated.
//   - The ring lives in shared memory where it fits, each row F + 2L
//     (re, im) pairs wide with its L conjugate-reflected margin bins stored
//     on both sides (K1's ring rows), so a tap is one 8-byte shared-memory
//     read with no branch. Else (F > ~6,000 at Q = 4) it is (WR, F) planes
//     in device memory (K3: a scratch the wrapper allocates; K4: the
//     state-out buffers), read with reflections.
//   - The weight table sits in shared memory where it fits beside the ring
//     (Q = 8, F = 2049: 28 KB), else it is read from device memory (Q = 32,
//     fractional weights); the run-time kernels read it through a generic
//     pointer either way. In the compile-time kernels P = Q divides the
//     threads, so a thread's bins share their column and each weight is
//     read once per tap for all of them.
//   - K4's amp rows (LA+1) sit in shared memory where they fit, else in
//     its amp state-out buffer.
//   - A row update keeps its off-centre sums, the original centre bins and
//     the amp in registers. One pass: compute, barrier, write the row,
//     barrier. More passes ping-pong between the ring row and one shared
//     centre-row copy, ending in the ring; a pass whose source is its
//     destination splits into compute, barrier, write.
//   - (Q, L) = (4, 5) (the music and streaming paths' defaults) at 1-3
//     bins per thread with the ring and the table in shared memory and P =
//     Q runs a compile-time kernel: a row's 2L+1 weights and values are
//     loaded at once, then summed with the row's live mask selecting, not
//     branching (fixed_row). Every other geometry runs the run-time kernel
//     (live-tap loop, per-bin columns), any Q, L and LA.
// The launch plan (bins, threads, width, where the ring, the table and
// K4's amp rows live, bytes) is online_plan below; lws_online_plan exports
// it, and lws_torch/ops/online.py::online_plan mirrors it.
//
// Bound on this card: the serial chain of row updates, T x (1 + iters x
// (LA+1)) per CTA, each two or more barrier-separated steps, on B CTAs.
// Bytes (input, amp, output, states, weights once) and operations (8 flops
// per live tap and bin) are both far below it. One launch runs the whole
// stage (K3) or the whole chunk (K4).

#include <cuda_runtime.h>

#include "lws_common.cuh"

namespace {

// Most threads of a compile-time kernel: its launch bound, one block per SM.
constexpr int kOnlineFixedThreads = 768;
// Bins per thread of the run-time kernels (F <= 16384).
constexpr int kOnlineMaxBins = 16;

struct OnlinePlan {
  int bins;        // bins per thread, strided: tid, tid + threads, ...
  int threads;     // round_up(ceil(F / bins), 32)
  int width;       // (re, im) pairs per ring row: F and L margin bins each side
  int ring;        // 1: the ring in shared memory (else device memory)
  int table;       // 1: the weight table in shared memory (else device memory)
  int amp;         // 1: K4's LA+1 amp rows in shared memory (K3: 0)
  int fixed;       // 1: the compile-time (4, 5) kernel runs
  long long bytes; // dynamic shared memory
};

// The plan for F bins, (Q, L), look-ahead LA, K4 when chunk, a table of G
// live taps by P columns. Always in shared memory: one centre-row copy and
// the tap lists; then the ring, the table and K4's amp rows, each where it
// still fits, in that order.
OnlinePlan online_plan(int F, int Q, int L, int LA, int chunk, int G, int P) {
  OnlinePlan p;
  p.bins = (F + kMaxThreads - 1) / kMaxThreads;
  p.threads = ((F + p.bins - 1) / p.bins + 31) / 32 * 32;
  p.width = F + 2 * L;
  const long long row = (long long)sizeof(float2) * p.width;
  const long long lists = (long long)sizeof(int) * (3LL * (2 + LA) * (2 * Q - 1) + G);
  const long long ring = (long long)(LA + Q) * row;
  const long long table = (long long)sizeof(float2) * G * P;
  const long long amp = (long long)sizeof(float) * (LA + 1) * F;
  long long used = row + lists;
  p.ring = used + ring <= kSmemLimit;
  if (p.ring) used += ring;
  p.table = used + table <= kSmemLimit;
  if (p.table) used += table;
  p.amp = chunk && used + amp <= kSmemLimit;
  if (p.amp) used += amp;
  p.fixed = Q == 4 && L == 5 && P == Q && p.ring && p.table && p.bins <= 3 &&
            p.threads <= kOnlineFixedThreads;
  p.bytes = used;
  return p;
}

struct OnlineArgs {
  const float* sr;  // (B, T, F) input (K4: the chunk)
  const float* si;
  const float* amp;  // (B, T, F) |input|
  const float* thr;  // K3 (B, iters); K4 (B, N, iters)
  float* out_r;      // (B, T, F) committed rows
  float* out_i;
  const float2* table;  // (G, P)
  const int* rows;      // (S, 2Q-1, 3)
  const int* dks;       // (G)
  float* ring_r;        // (B, WR, F) the ring in device memory (K3: scratch;
  float* ring_i;        //   K4: the state out), or null
  const float* ring_r_in;  // K4: the state in, (B, WR, F) and (B, LA+1, F)
  const float* ring_i_in;
  const float* amp_in;
  float* amp_out;  // K4: (B, LA+1, F), the amp rows' home when not in shared memory
  long long seen;  // K4: absolute index of the chunk's first frame
  int T, F, Q, L, LA, iters, passes, color_k, color_rounds, G, P, n_live;
  int bins, width, table_smem, amp_smem;  // from the plan
};

// One CTA's window: where its ring, centre-row copy, table and tap lists
// are, and the geometry a row update needs.
struct Window {
  float2* ring;  // (WR, W) in shared memory, or null
  float* gr;     // (WR, F) planes in device memory, or null
  float* gi;
  float2* copy;         // (W) centre-row copy
  const float2* table;  // (G, P), shared or device memory
  const int* rows;      // (S, R, 3), shared memory
  const int* dks;       // (G), shared memory
  int WR, F, W, L, Q1, P, passes, color_k, color_rounds, base;

  __device__ int slot(int f) const {
    const int s = (f + base) % WR;
    return s < 0 ? s + WR : s;
  }
  // the slot of the frame d before the one in slot s, 0 <= d < WR
  __device__ __forceinline__ int back(int s, int d) const {
    return s - d < 0 ? s - d + WR : s - d;
  }
};

// Row `slot` of the window, bin n + dk - L (dk: the tap's column in 0..2L).
template <bool kRing>
__device__ __forceinline__ float2 ring_tap(const Window& w, int slot, int n, int dk) {
  if (kRing) return w.ring[slot * w.W + n + dk];
  float br, bi;
  read_bin(w.gr + slot * w.F, w.gi + slot * w.F, n + dk - w.L, w.F, br, bi);
  return float2{br, bi};
}

// Per-thread bins: nb[j] = min(tid + j * threads, F - 1) (a clamped bin
// computes and writes nothing), own[j] when it is a real bin, col[j] its
// table column.
template <int KNB>
struct Bins {
  int nb[KNB];
  bool own[KNB];
  int col[KNB];
  int count;  // bins in use (the plan's bins)
};

template <int KNB>
__device__ Bins<KNB> my_bins(const OnlineArgs& a) {
  Bins<KNB> t;
  t.count = KNB == 1 ? 1 : a.bins;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    const int n = tid + j * nth;
    t.nb[j] = n < a.F ? n : a.F - 1;
    t.own[j] = j < t.count && n < a.F;
    t.col[j] = t.nb[j] % a.P;
  }
  return t;
}

// One row of taps of the compile-time kernel, KK = 2L+1: the row's KK
// weights (the live ones at table indices first, first + 1, ... in dk
// order; column col serves every bin of the thread, P | threads) and each
// bin's KK row values are loaded first, whatever the mask, then the live
// taps are summed in dk order, a dead tap leaving the sums as they are (a
// select, not a branch, so the loads need not wait for the sums). A dead
// tap's weight read lands on the next live tap's, or just past the table,
// inside shared memory (the tap lists follow it).
template <int KK, int KNB>
__device__ __forceinline__ void fixed_row(const float2* row, const float2* table, int P,
                                          int col, unsigned mask, int first,
                                          const Bins<KNB>& t, float (&ar)[KNB],
                                          float (&ai)[KNB]) {
  float2 wt[KK];
  int g = first;
#pragma unroll
  for (int dk = 0; dk < KK; ++dk) {
    wt[dk] = table[g * P + col];
    g += (mask >> dk) & 1u;
  }
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    float2 v[KK];
#pragma unroll
    for (int dk = 0; dk < KK; ++dk) v[dk] = row[t.nb[j] + dk];
#pragma unroll
    for (int dk = 0; dk < KK; ++dk) {
      float r = ar[j], i = ai[j];
      cmac(r, i, wt[dk], v[dk]);
      const bool live = (mask >> dk) & 1u;
      ar[j] = live ? r : ar[j];
      ai[j] = live ? i : ai[j];
    }
  }
}

// Off-centre taps of a frame (s0: the ring slot of its row dr = 0) for
// every bin of the thread, set `meta` (its (R, 3) rows), into (tr, ti).
template <int KQ, int KL, int KNB, bool kRing>
__device__ __forceinline__ void off_centre(const Window& w, const Bins<KNB>& t,
                                           const int* meta, int s0, float (&tr)[KNB],
                                           float (&ti)[KNB]) {
  constexpr bool kFixed = KQ > 0;
  const int Q1 = kFixed ? KQ - 1 : w.Q1;
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    tr[j] = 0.f;
    ti[j] = 0.f;
  }
  // a dead row has no live tap; live rows lie inside the ring
  if constexpr (kFixed) {
    // every row's mask and first tap at once, then the rows unrolled
    constexpr int R = 2 * KQ - 1;
    unsigned mask[R];
    int first[R];
#pragma unroll
    for (int dr = 0; dr < R; ++dr) {
      mask[dr] = (unsigned)meta[3 * dr];
      first[dr] = meta[3 * dr + 1];
    }
#pragma unroll
    for (int dr = 0; dr < R; ++dr) {
      if (dr == KQ - 1 || mask[dr] == 0) continue;
      const int slot = s0 + dr >= w.WR ? s0 + dr - w.WR : s0 + dr;
      fixed_row<2 * KL + 1>(w.ring + slot * w.W, w.table, w.P, t.col[0], mask[dr],
                            first[dr], t, tr, ti);
    }
  } else {
#pragma unroll 1
    for (int dr = 0; dr < 2 * Q1 + 1; ++dr) {
      const int count = meta[3 * dr + 2];
      if (dr == Q1 || count == 0) continue;
      const int first = meta[3 * dr + 1];
      const int slot = s0 + dr >= w.WR ? s0 + dr - w.WR : s0 + dr;
      for (int g = first; g < first + count; ++g) {
        const int dk = w.dks[g];
#pragma unroll
        for (int j = 0; j < KNB; ++j) {
          if (j < t.count)
            cmac(tr[j], ti[j], w.table[g * w.P + t.col[j]],
                 ring_tap<kRing>(w, slot, t.nb[j], dk));
        }
      }
    }
  }
}

// Centre taps over one centre row for bin j: the row is the ring slot cs
// when src == 0, the shared copy when src == 1.
template <int KQ, int KL, int KNB, bool kRing>
__device__ __forceinline__ void centre_taps(const Window& w, const Bins<KNB>& t,
                                            const int* cmeta, int cs, int src,
                                            float (&cr)[KNB], float (&ci)[KNB]) {
  constexpr bool kFixed = KQ > 0;
  const int first = cmeta[1];
  const int count = cmeta[2];
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    cr[j] = 0.f;
    ci[j] = 0.f;
  }
  if constexpr (kFixed) {
    fixed_row<2 * KL + 1>(src ? w.copy : w.ring + cs * w.W, w.table, w.P, t.col[0],
                          (unsigned)cmeta[0], first, t, cr, ci);
  } else {
    for (int g = first; g < first + count; ++g) {
      const int dk = w.dks[g];
#pragma unroll
      for (int j = 0; j < KNB; ++j) {
        if (j < t.count) {
          const float2 v = src ? w.copy[t.nb[j] + dk] : ring_tap<kRing>(w, cs, t.nb[j], dk);
          cmac(cr[j], ci[j], w.table[g * w.P + t.col[j]], v);
        }
      }
    }
  }
}

// Centre bin n of ring slot cs (kRing) or the shared copy (src == 1).
template <bool kRing>
__device__ __forceinline__ float2 centre_bin(const Window& w, int cs, int src, int n) {
  if (src) return w.copy[n + w.L];
  if (kRing) return w.ring[cs * w.W + n + w.L];
  return float2{w.gr[cs * w.F + n], w.gi[cs * w.F + n]};
}

// Write the thread's own bins (nr, ni) into ring slot cs (dst == 0) or the
// shared copy (dst == 1).
template <bool kRing, int KNB>
__device__ __forceinline__ void write_row(const Window& w, const Bins<KNB>& t, int cs, int dst,
                                          const float (&nr)[KNB], const float (&ni)[KNB]) {
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    if (!t.own[j]) continue;
    const int n = t.nb[j];
    if (dst) {
      put_cbin(w.copy, n, w.F, w.L, nr[j], ni[j]);
    } else if (kRing) {
      put_cbin(w.ring + cs * w.W, n, w.F, w.L, nr[j], ni[j]);
    } else {
      w.gr[cs * w.F + n] = nr[j];
      w.gi[cs * w.F + n] = ni[j];
    }
  }
}

// Update the frame in ring slot cs (all F bins) with weight set `set` at
// threshold th and target magnitudes amp_f (thread reads its own bins
// only). Called by every thread of the CTA; returns after a barrier, with
// the row written.
template <int KQ, int KL, int KNB, bool kRing>
__device__ __forceinline__ void row_update(const Window& w, const Bins<KNB>& t, int cs, int set,
                                           float th, const float* amp_f) {
  const int Q1 = KQ > 0 ? KQ - 1 : w.Q1;
  const int R = 2 * Q1 + 1;
  const int* meta = w.rows + 3 * set * R;
  const int s0 = w.back(cs, Q1);

  float tr[KNB], ti[KNB], orr[KNB], ori[KNB], am[KNB];
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    if (j < t.count) {
      am[j] = amp_f[t.nb[j]];
      const float2 o = centre_bin<kRing>(w, cs, 0, t.nb[j]);
      orr[j] = o.x;
      ori[j] = o.y;
    }
  }
  off_centre<KQ, KL, KNB, kRing>(w, t, meta, s0, tr, ti);

  const int* cmeta = meta + 3 * Q1;
  const int n_cen = cmeta[2];
  const bool colors = n_cen > 0 && w.color_k > 0;
  const int n_pass = n_cen == 0 ? 0 : (colors ? w.color_k * w.color_rounds : w.passes);
  float nr[KNB], ni[KNB];
  if (n_pass == 0) {
    // no centre taps: no thread reads row f during this update
#pragma unroll
    for (int j = 0; j < KNB; ++j) {
      nr[j] = orr[j];
      ni[j] = ori[j];
      if (t.own[j]) phase_update(tr[j], ti[j], am[j], th, nr[j], ni[j]);
    }
    write_row<kRing>(w, t, cs, 0, nr, ni);
    __syncthreads();  // row f is written before anything reads it
    return;
  }
  // the passes ping-pong between the ring row (0) and the copy (1), the
  // last one writing the ring row
  int src = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int dst = (n_pass - 1 - p) & 1;
    const int color = colors ? p % w.color_k : -1;
    float cr[KNB], ci[KNB];
    centre_taps<KQ, KL, KNB, kRing>(w, t, cmeta, cs, src, cr, ci);
#pragma unroll
    for (int j = 0; j < KNB; ++j) {
      if (!t.own[j]) continue;
      // jacobi falls back to the original row, colors to the evolving one
      if (colors) {
        const float2 e = centre_bin<kRing>(w, cs, src, t.nb[j]);
        nr[j] = e.x;
        ni[j] = e.y;
      } else {
        nr[j] = orr[j];
        ni[j] = ori[j];
      }
      if (color < 0 || t.nb[j] % w.color_k == color)
        phase_update(tr[j] + cr[j], ti[j] + ci[j], am[j], th, nr[j], ni[j]);
    }
    if (dst == src) __syncthreads();  // every read of the row precedes its writes
    write_row<kRing>(w, t, cs, dst, nr, ni);
    __syncthreads();  // the row is written before the next pass or update reads it
    src = dst;
  }
}

// Shared memory, in order: the ring (float2, when in shared memory), the
// centre-row copy (float2), the table (float2, when in shared memory),
// K4's amp rows (float, when in shared memory), then the tap lists (int),
// loaded here. The caller syncs before the first update.
__device__ __forceinline__ Window make_window(float* smem, const OnlineArgs& a, bool ring,
                                              bool table, bool amp, float** amp_rows) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int S = 2 + a.LA;
  const int R = 2 * a.Q - 1;
  Window w;
  w.WR = a.LA + a.Q;
  w.F = a.F;
  w.W = a.width;
  w.L = a.L;
  w.Q1 = a.Q - 1;
  w.P = a.P;
  w.passes = a.passes;
  w.color_k = a.color_k;
  w.color_rounds = a.color_rounds;
  w.base = 0;
  float2* at = reinterpret_cast<float2*>(smem);
  w.ring = ring ? at : nullptr;
  at += ring ? w.WR * w.W : 0;
  w.gr = ring ? nullptr : a.ring_r + (size_t)blockIdx.x * w.WR * a.F;
  w.gi = ring ? nullptr : a.ring_i + (size_t)blockIdx.x * w.WR * a.F;
  w.copy = at;
  at += w.W;
  if (table) {
    float2* s_table = at;
    for (int i = tid; i < a.G * a.P; i += nth) s_table[i] = __ldg(a.table + i);
    w.table = s_table;
    at += a.G * a.P;
  } else {
    w.table = a.table;
  }
  float* fl = reinterpret_cast<float*>(at);
  *amp_rows = amp ? fl : nullptr;
  fl += amp ? (a.LA + 1) * a.F : 0;
  int* s_rows = reinterpret_cast<int*>(fl);
  int* s_dks = s_rows + 3 * S * R;
  for (int i = tid; i < 3 * S * R; i += nth) s_rows[i] = __ldg(a.rows + i);
  for (int i = tid; i < a.G; i += nth) s_dks[i] = __ldg(a.dks + i);
  w.rows = s_rows;
  w.dks = s_dks;
  return w;
}

// Frame (vr, vi) of the thread's own bins into ring slot s.
template <bool kRing, int KNB>
__device__ __forceinline__ void load_row(const Window& w, const Bins<KNB>& t, int s,
                                         const float* vr, const float* vi) {
  float nr[KNB], ni[KNB];
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    if (t.own[j]) {
      nr[j] = __ldg(vr + t.nb[j]);
      ni[j] = __ldg(vi + t.nb[j]);
    }
  }
  write_row<kRing>(w, t, s, 0, nr, ni);
}

// Ring slot s's own bins to (or_, oi) (interior bins only).
template <bool kRing, int KNB>
__device__ __forceinline__ void store_row(const Window& w, const Bins<KNB>& t, int s,
                                          float* or_, float* oi) {
#pragma unroll
  for (int j = 0; j < KNB; ++j) {
    if (t.own[j]) {
      const float2 v = centre_bin<kRing>(w, s, 0, t.nb[j]);
      or_[t.nb[j]] = v.x;
      oi[t.nb[j]] = v.y;
    }
  }
}

template <int KQ, int KL, int KNB, bool kRing>
__global__ void __launch_bounds__(KQ > 0 ? kOnlineFixedThreads : kMaxThreads, 1)
    lws_online_kernel(OnlineArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int T = a.T;
  const int F = a.F;
  const size_t plane = (size_t)T * F;
  const float* Sr = a.sr + b * plane;
  const float* Si = a.si + b * plane;
  const float* A = a.amp + b * plane;
  float* Or = a.out_r + b * plane;
  float* Oi = a.out_i + b * plane;
  float* unused;
  const Window w = make_window(smem, a, kRing, KQ > 0 || a.table_smem, false, &unused);
  const Bins<KNB> t = my_bins<KNB>(a);

  // every slot starts as frame 0: the frozen edge-replica rows before the
  // start keep it for good
  for (int s = 0; s < w.WR; ++s) load_row<kRing>(w, t, s, Sr, Si);
  __syncthreads();

  for (int m = 0; m < T; ++m) {
    const int sm = w.slot(m);
    load_row<kRing>(w, t, sm, Sr + (size_t)m * F, Si + (size_t)m * F);
    __syncthreads();
    row_update<KQ, KL, KNB, kRing>(w, t, sm, 0, 0.f, A + (size_t)m * F);
    for (int h = 0; h < a.iters; ++h) {
      const float th = __ldg(a.thr + b * a.iters + h);
      for (int d = a.LA; d >= 1; --d) {
        const int f = m - d;
        if (f >= 0)
          row_update<KQ, KL, KNB, kRing>(w, t, w.back(sm, d), 2 + d - 1, th,
                                                 A + (size_t)f * F);
      }
      row_update<KQ, KL, KNB, kRing>(w, t, sm, 1, th, A + (size_t)m * F);
    }
    // frame m-LA is final; thread n commits its own bins, which only it
    // rewrites when a later frame reuses the slot
    const int c = m - a.LA;
    if (c >= 0) store_row<kRing>(w, t, w.back(sm, a.LA), Or + (size_t)c * F, Oi + (size_t)c * F);
  }
  for (int c = T - a.LA > 0 ? T - a.LA : 0; c < T; ++c)
    store_row<kRing>(w, t, w.slot(c), Or + (size_t)c * F, Oi + (size_t)c * F);
}

// K4: one chunk of N frames per stream. State (per stream b): ring
// (WR, F) re / im, frame f in slot f mod WR; amp rows (LA+1, F), frame f in
// slot f mod (LA+1); `seen` is the absolute index of chunk frame 0. The
// state is read from the *_in buffers and written to the *_out ones (which
// hold the ring or the amp rows during the chunk where shared memory does
// not).
template <int KQ, int KL, int KNB, bool kRing>
__global__ void __launch_bounds__(KQ > 0 ? kOnlineFixedThreads : kMaxThreads, 1)
    lws_online_chunk_kernel(OnlineArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int N = a.T;
  const int F = a.F;
  const int WR = a.LA + a.Q;
  const int WA = a.LA + 1;
  const size_t plane = (size_t)N * F;
  const float* Sr = a.sr + b * plane;
  const float* Si = a.si + b * plane;
  const float* A = a.amp + b * plane;
  const float* Th = a.thr + (size_t)b * N * a.iters;
  float* Or = a.out_r + b * plane;
  float* Oi = a.out_i + b * plane;
  float* amp_rows;
  Window w = make_window(smem, a, kRing, KQ > 0 || a.table_smem, a.amp_smem, &amp_rows);
  // chunk-relative frame f (f < 0: the state's frames) is absolute seen + f
  w.base = (int)(a.seen % WR);
  const Bins<KNB> t = my_bins<KNB>(a);
  float* amp_ring = amp_rows ? amp_rows : a.amp_out + (size_t)b * WA * F;
  const int abase = (int)(a.seen % WA);
  auto amp_row = [&](int f) {
    const int s = (f + abase) % WA;
    return amp_ring + (s < 0 ? s + WA : s) * F;
  };

  const size_t ring_off = (size_t)b * WR * F;
  for (int s = 0; s < WR; ++s)
    load_row<kRing>(w, t, s, a.ring_r_in + ring_off + (size_t)s * F,
                    a.ring_i_in + ring_off + (size_t)s * F);
#pragma unroll
  for (int j = 0; j < KNB; ++j)
    if (t.own[j])
      for (int s = 0; s < WA; ++s)
        amp_ring[s * F + t.nb[j]] = __ldg(a.amp_in + ((size_t)b * WA + s) * F + t.nb[j]);
  __syncthreads();

  for (int m = 0; m < N; ++m) {
    const bool live = m < a.n_live;
    float* amp_m = amp_row(m);
    const int sm = w.slot(m);
    load_row<kRing>(w, t, sm, Sr + (size_t)m * F, Si + (size_t)m * F);
#pragma unroll
    for (int j = 0; j < KNB; ++j)
      if (t.own[j]) amp_m[t.nb[j]] = live ? __ldg(A + (size_t)m * F + t.nb[j]) : 0.f;
    __syncthreads();
    if (live) {
      row_update<KQ, KL, KNB, kRing>(w, t, sm, 0, 0.f, amp_m);
      for (int h = 0; h < a.iters; ++h) {
        const float th = __ldg(Th + (size_t)m * a.iters + h);
        for (int d = a.LA; d >= 1; --d) {
          // frames before the stream start are frozen replicas
          if (a.seen + m - d >= 0)
            row_update<KQ, KL, KNB, kRing>(w, t, w.back(sm, d), 2 + d - 1, th,
                                                   amp_row(m - d));
        }
        row_update<KQ, KL, KNB, kRing>(w, t, sm, 1, th, amp_m);
      }
    }
    // frame m-LA is final: output row m. The thread commits its own bins,
    // which only it rewrites when a later frame reuses the slot
    store_row<kRing>(w, t, w.back(sm, a.LA), Or + (size_t)m * F, Oi + (size_t)m * F);
  }
  // the state out: each thread its own bins (a device-memory ring and amp
  // rows are there already)
  if (kRing)
    for (int s = 0; s < WR; ++s)
      store_row<kRing>(w, t, s, a.ring_r + ring_off + (size_t)s * F,
                       a.ring_i + ring_off + (size_t)s * F);
  if (amp_rows) {
#pragma unroll
    for (int j = 0; j < KNB; ++j)
      if (t.own[j])
        for (int s = 0; s < WA; ++s)
          a.amp_out[((size_t)b * WA + s) * F + t.nb[j]] = amp_rows[s * F + t.nb[j]];
  }
}

typedef void (*OnlineKernel)(OnlineArgs);

template <bool kChunk, int KQ, int KL, int KNB, bool kRing>
OnlineKernel kernel_of() {
  if constexpr (kChunk) return lws_online_chunk_kernel<KQ, KL, KNB, kRing>;
  else return lws_online_kernel<KQ, KL, KNB, kRing>;
}

// The kernel the plan picks: the compile-time (4, 5) kernel at 1-3 bins;
// else the run-time kernel for up to 4 bins (ring in shared memory) or up
// to 16 (ring in shared or device memory). The run-time kernels read the
// table through a generic pointer, in shared or device memory.
template <bool kChunk>
OnlineKernel pick_kernel(const OnlinePlan& p) {
  if (p.fixed) {
    if (p.bins == 1) return kernel_of<kChunk, 4, 5, 1, true>();
    return p.bins == 2 ? kernel_of<kChunk, 4, 5, 2, true>() : kernel_of<kChunk, 4, 5, 3, true>();
  }
  if (p.ring) {
    return p.bins <= 4 ? kernel_of<kChunk, 0, 0, 4, true>() : kernel_of<kChunk, 0, 0, 16, true>();
  }
  return kernel_of<kChunk, 0, 0, 16, false>();
}

bool plan_fits(const OnlinePlan& p) {
  return p.bins <= kOnlineMaxBins && p.bytes <= kSmemLimit;
}

// Launch arguments a kernel does not take (checked before any launch).
bool bad_geometry(int B, int T, int F, int Q, int L, int LA, int iters, int passes,
                  int color_k, int color_rounds, int G, int P) {
  return B < 1 || T < 1 || Q < 1 || L < 0 || F < L + 1 || LA < 0 || iters < 1 ||
         passes < 1 || color_k < 0 || color_rounds < 1 || G < 0 || P < 1 || P > F;
}

template <bool kChunk>
int launch(OnlineArgs a, int B, void* stream) {
  const OnlinePlan p = online_plan(a.F, a.Q, a.L, a.LA, kChunk, a.G, a.P);
  if (!plan_fits(p) || (!p.ring && (a.ring_r == nullptr || a.ring_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.bins = p.bins;
  a.width = p.width;
  a.table_smem = p.table;
  a.amp_smem = p.amp;
  const OnlineKernel kernel = pick_kernel<kChunk>(p);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, p.threads, (size_t)p.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for (F, Q, L, LA), K4 when chunk, a table of G live taps
// by P columns, into out[0..7]: bins per thread, threads, width, ring (0/1),
// table (0/1), amp rows (0/1), fixed kernel (0/1), shared-memory bytes.
// Returns 0 when it fits one block, else cudaErrorInvalidValue.
int lws_online_plan(int F, int Q, int L, int LA, int chunk, int G, int P, long long* out) {
  if (F < 1 || Q < 1 || L < 0 || LA < 0 || G < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const OnlinePlan p = online_plan(F, Q, L, LA, chunk, G, P);
  const long long v[8] = {p.bins, p.threads, p.width, p.ring,
                          p.table, p.amp, p.fixed, p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return plan_fits(p) ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// Runs the online stage over (sr, si) into (out_r, out_i) on `stream`, with
// the weight table (G, P) and its tap lists; (ring_r, ring_i) (B, LA+Q, F)
// is the ring's scratch where the plan keeps it in device memory (else
// unused, may be null). Returns the cudaError_t of the launch (0 on
// success).
int lws_online_launch(const void* sr, const void* si, const void* amp, void* out_r,
                      void* out_i, const void* table, const void* rows, const void* dks,
                      const void* thr, void* ring_r, void* ring_i, int B, int T, int F,
                      int Q, int L, int LA, int iters, int passes, int color_k,
                      int color_rounds, int G, int P, void* stream) {
  if (bad_geometry(B, T, F, Q, L, LA, iters, passes, color_k, color_rounds, G, P)) {
    return (int)cudaErrorInvalidValue;
  }
  OnlineArgs a = {};
  a.sr = (const float*)sr;
  a.si = (const float*)si;
  a.amp = (const float*)amp;
  a.thr = (const float*)thr;
  a.out_r = (float*)out_r;
  a.out_i = (float*)out_i;
  a.table = (const float2*)table;
  a.rows = (const int*)rows;
  a.dks = (const int*)dks;
  a.ring_r = (float*)ring_r;
  a.ring_i = (float*)ring_i;
  a.T = T;
  a.F = F;
  a.Q = Q;
  a.L = L;
  a.LA = LA;
  a.iters = iters;
  a.passes = passes;
  a.color_k = color_k;
  a.color_rounds = color_rounds;
  a.G = G;
  a.P = P;
  return launch<false>(a, B, stream);
}

// Runs K4 over one chunk (sr, si, amp: (B, N, F); thr: (B, N, iters)) from
// the state (ring_*_in, amp_in) into (out_r, out_i) and the state buffers
// (ring_*_out, amp_out), on `stream`; frames m >= n_live are drain steps.
// Returns the cudaError_t of the launch (0 on success).
int lws_online_chunk_launch(const void* sr, const void* si, const void* amp,
                            const void* thr, const void* ring_r_in, const void* ring_i_in,
                            const void* amp_in, void* ring_r_out, void* ring_i_out,
                            void* amp_out, void* out_r, void* out_i, const void* table,
                            const void* rows, const void* dks, int B, int N, int F, int Q,
                            int L, int LA, int iters, int passes, int color_k,
                            int color_rounds, int G, int P, long long seen, int n_live,
                            void* stream) {
  if (bad_geometry(B, N, F, Q, L, LA, iters, passes, color_k, color_rounds, G, P) ||
      seen < 0 || n_live < 0) {
    return (int)cudaErrorInvalidValue;
  }
  OnlineArgs a = {};
  a.sr = (const float*)sr;
  a.si = (const float*)si;
  a.amp = (const float*)amp;
  a.thr = (const float*)thr;
  a.out_r = (float*)out_r;
  a.out_i = (float*)out_i;
  a.table = (const float2*)table;
  a.rows = (const int*)rows;
  a.dks = (const int*)dks;
  a.ring_r = (float*)ring_r_out;
  a.ring_i = (float*)ring_i_out;
  a.ring_r_in = (const float*)ring_r_in;
  a.ring_i_in = (const float*)ring_i_in;
  a.amp_in = (const float*)amp_in;
  a.amp_out = (float*)amp_out;
  a.seen = seen;
  a.T = N;
  a.F = F;
  a.Q = Q;
  a.L = L;
  a.LA = LA;
  a.iters = iters;
  a.passes = passes;
  a.color_k = color_k;
  a.color_rounds = color_rounds;
  a.G = G;
  a.P = P;
  a.n_live = n_live;
  return launch<true>(a, B, stream);
}

const char* lws_online_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
