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
// A frame update is the sweep kernel's (lws_sweeps.cu): off-centre taps
// first, in (dr, dk) order, then the centre row's taps, `passes` jacobi
// re-passes (fallback: the original row) or color_k x color_rounds
// red-black rounds (fallback: the evolving row), then the rsqrt epilogue.
// K3 and K4 share it (row_update), so with the same amp, thresholds and
// ring they agree bit for bit.
//
// Layout: input, amp and output are (B, T, F); the output is a buffer of
// its own, so a committed row is never read back as input. The 2+LA weight
// sets are stacked (S, 2Q-1, 2L+1, F), visibility-masked; `taps` holds,
// for each set, the indices dr*(2L+1)+dk of its live off-centre taps
// followed by its live centre taps (counts[2s], counts[2s+1]): a masked
// tap costs nothing.
//
// Design: one CTA per utterance (K3) or stream (K4), threads over the F
// bins (a loop when F > blockDim). The frames a step can read,
// m-LA-(Q-1) .. m, are a ring of WR = LA+Q rows x F bins (re, im) in shared
// memory, indexed modulo WR: loading frame m overwrites frame m-WR, which
// no update reads any more. Slots of frames before the start hold frame
// 0's input, as the plain version's frozen edge-replica halo rows, and are
// never updated. Every row update ends in __syncthreads(), so the next one
// reads it whole; the centre-row passes ping-pong through shared memory as
// in the sweep kernel. The weights (1.58 MB at F=513, LA=3) do not fit
// shared memory and are read through the read-only path (L2 holds them).
//
// Bound on this card: the serial chain of row updates, T x (1 + iters x
// (LA+1)) per CTA, each two or more barrier-separated steps, on B CTAs.
// Bytes (input, amp, output, states, weights once) and operations (8 flops
// per live tap and bin) are both far below it. One launch runs the whole
// stage (K3) or the whole chunk (K4).

#include <cuda_runtime.h>

#include "lws_common.cuh"

namespace {

constexpr int kMaxLA = 8;

struct Window {
  float* ring_r;  // (WR, F) phase window, frame f in slot f mod WR
  float* ring_i;
  float* s_tr;    // off-centre tap sums of the row being updated
  float* s_ti;
  float* s_row[2][2];  // centre-row ping-pong
  const int* taps;     // (S, R*K) live tap lists, in shared memory
  const int* counts;   // (S, 2) off-centre / centre tap counts
  const float* wr;     // (S, R, K, F) stacked weights, device memory
  const float* wi;
  int WR, F, L, Q1, RK, passes, color_k, color_rounds;
  int base;  // slot of frame 0 (K4: the absolute index of the chunk's first frame mod WR)

  __device__ int slot(int f) const {
    const int s = (f + base) % WR;
    return s < 0 ? s + WR : s;
  }
};

// Update frame f (all F bins) with weight set `set` at threshold th and
// target magnitudes amp_f (device memory in K3, shared memory in K4; thread
// n reads bin n only). Called by every thread of the CTA; returns after a
// barrier, with the row written.
__device__ __forceinline__ void row_update(const Window& w, int f, int set, float th,
                           const float* __restrict__ amp_f) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int F = w.F;
  const int K = 2 * w.L + 1;
  const int n_off = w.counts[2 * set];
  const int n_cen = w.counts[2 * set + 1];
  const int* tap = w.taps + set * w.RK;
  const float* Wr = w.wr + (size_t)set * w.RK * F;
  const float* Wi = w.wi + (size_t)set * w.RK * F;
  float* cen_r = w.ring_r + w.slot(f) * F;
  float* cen_i = w.ring_i + w.slot(f) * F;
  const bool colors = n_cen > 0 && w.color_k > 0;
  const int n_pass = n_cen == 0 ? 0 : (colors ? w.color_k * w.color_rounds : w.passes);

  for (int n = tid; n < F; n += nth) {
    float tr = 0.f, ti = 0.f;
    for (int t = 0; t < n_off; ++t) {
      const int idx = tap[t];
      const int dr = idx / K;
      const int dk = idx - dr * K;
      const int row = w.slot(f + dr - w.Q1) * F;
      float br, bi;
      read_bin(w.ring_r + row, w.ring_i + row, n + dk - w.L, F, br, bi);
      const float wr = __ldg(Wr + (size_t)idx * F + n);
      const float wi = __ldg(Wi + (size_t)idx * F + n);
      tr = tr + (wr * br - wi * bi);
      ti = ti + (wr * bi + wi * br);
    }
    if (n_pass == 0) {
      // no centre taps: no thread reads row f during this update
      float nr = cen_r[n], ni = cen_i[n];
      phase_update(tr, ti, amp_f[n], th, nr, ni);
      cen_r[n] = nr;
      cen_i[n] = ni;
    } else {
      w.s_tr[n] = tr;
      w.s_ti[n] = ti;
      w.s_row[0][0][n] = cen_r[n];
      w.s_row[0][1][n] = cen_i[n];
    }
  }

  for (int p = 0; p < n_pass; ++p) {
    __syncthreads();  // the row this pass reads is complete
    const float* src_r = w.s_row[p & 1][0];
    const float* src_i = w.s_row[p & 1][1];
    const bool last = p + 1 == n_pass;
    float* dst_r = last ? cen_r : w.s_row[(p + 1) & 1][0];
    float* dst_i = last ? cen_i : w.s_row[(p + 1) & 1][1];
    const int color = colors ? p % w.color_k : -1;
    for (int n = tid; n < F; n += nth) {
      // jacobi falls back to the original row (in the ring until the last
      // pass writes it, thread n alone touching bin n there); colors fall
      // back to the evolving row
      float nr = colors ? src_r[n] : cen_r[n];
      float ni = colors ? src_i[n] : cen_i[n];
      if (color < 0 || n % w.color_k == color) {
        float cr = 0.f, ci = 0.f;
        for (int t = n_off; t < n_off + n_cen; ++t) {
          const int idx = tap[t];
          const int dk = idx - w.Q1 * K;
          float br, bi;
          read_bin(src_r, src_i, n + dk - w.L, F, br, bi);
          const float wr = __ldg(Wr + (size_t)idx * F + n);
          const float wi = __ldg(Wi + (size_t)idx * F + n);
          cr = cr + (wr * br - wi * bi);
          ci = ci + (wr * bi + wi * br);
        }
        phase_update(w.s_tr[n] + cr, w.s_ti[n] + ci, amp_f[n], th, nr, ni);
      }
      dst_r[n] = nr;
      dst_i[n] = ni;
    }
  }
  __syncthreads();  // row f is written before anything reads it
}

// The Window of one CTA over dynamic shared memory: the ring, six F-rows of
// scratch, `extra` floats for the caller (K4's amp rows), then the tap
// lists and counts, loaded here. The caller syncs before the first update.
__device__ Window make_window(float* smem, int F, int Q, int L, int LA, int passes,
                              int color_k, int color_rounds, const float* wr,
                              const float* wi, const int* taps, const int* counts,
                              int base, int extra, float** extra_out) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int S = 2 + LA;
  Window w;
  w.WR = LA + Q;
  w.F = F;
  w.L = L;
  w.Q1 = Q - 1;
  w.RK = (2 * Q - 1) * (2 * L + 1);
  w.passes = passes;
  w.color_k = color_k;
  w.color_rounds = color_rounds;
  w.base = base;
  w.wr = wr;
  w.wi = wi;
  w.ring_r = smem;
  w.ring_i = smem + w.WR * F;
  float* rest = smem + 2 * w.WR * F;
  w.s_tr = rest;
  w.s_ti = rest + F;
  w.s_row[0][0] = rest + 2 * F;
  w.s_row[0][1] = rest + 3 * F;
  w.s_row[1][0] = rest + 4 * F;
  w.s_row[1][1] = rest + 5 * F;
  *extra_out = rest + 6 * F;
  int* s_taps = reinterpret_cast<int*>(rest + 6 * F + extra);
  int* s_counts = s_taps + S * w.RK;
  for (int i = tid; i < S * w.RK; i += nth) s_taps[i] = __ldg(taps + i);
  for (int i = tid; i < 2 * S; i += nth) s_counts[i] = __ldg(counts + i);
  w.taps = s_taps;
  w.counts = s_counts;
  return w;
}

__global__ void __launch_bounds__(kMaxThreads)
lws_online_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                  const float* __restrict__ amp, float* __restrict__ out_r,
                  float* __restrict__ out_i, const float* __restrict__ wr,
                  const float* __restrict__ wi, const int* __restrict__ taps,
                  const int* __restrict__ counts,
                  const float* __restrict__ thr, int T, int F, int Q, int L,
                  int LA, int iters, int passes, int color_k,
                  int color_rounds) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const size_t plane = (size_t)T * F;
  const float* Sr = sr + b * plane;
  const float* Si = si + b * plane;
  const float* A = amp + b * plane;
  float* Or = out_r + b * plane;
  float* Oi = out_i + b * plane;
  float* unused;
  const Window w = make_window(smem, F, Q, L, LA, passes, color_k, color_rounds, wr, wi,
                               taps, counts, 0, 0, &unused);

  // every slot starts as frame 0: the frozen edge-replica rows before the
  // start keep it for good
  for (int i = tid; i < w.WR * F; i += nth) {
    const int n = i % F;
    w.ring_r[i] = __ldg(Sr + n);
    w.ring_i[i] = __ldg(Si + n);
  }
  __syncthreads();

  for (int m = 0; m < T; ++m) {
    const int newest = w.slot(m) * F;
    for (int n = tid; n < F; n += nth) {
      w.ring_r[newest + n] = __ldg(Sr + (size_t)m * F + n);
      w.ring_i[newest + n] = __ldg(Si + (size_t)m * F + n);
    }
    __syncthreads();
    row_update(w, m, 0, 0.f, A + (size_t)m * F);
    for (int h = 0; h < iters; ++h) {
      const float th = __ldg(thr + b * iters + h);
      for (int d = LA; d >= 1; --d) {
        const int f = m - d;
        if (f >= 0) row_update(w, f, 2 + d - 1, th, A + (size_t)f * F);
      }
      row_update(w, m, 1, th, A + (size_t)m * F);
    }
    // frame m-LA is final; thread n commits bin n, which only thread n
    // rewrites when a later frame reuses the slot
    const int c = m - LA;
    if (c >= 0) {
      const int row = w.slot(c) * F;
      for (int n = tid; n < F; n += nth) {
        Or[(size_t)c * F + n] = w.ring_r[row + n];
        Oi[(size_t)c * F + n] = w.ring_i[row + n];
      }
    }
  }
  for (int c = T - LA > 0 ? T - LA : 0; c < T; ++c) {
    const int row = w.slot(c) * F;
    for (int n = tid; n < F; n += nth) {
      Or[(size_t)c * F + n] = w.ring_r[row + n];
      Oi[(size_t)c * F + n] = w.ring_i[row + n];
    }
  }
}

// K4: one chunk of N frames per stream. State (per stream b): ring
// (WR, F) re / im, frame f in slot f mod WR; amp rows (LA+1, F), frame f in
// slot f mod (LA+1); `seen` is the absolute index of chunk frame 0. The
// state is read from the *_in buffers and written to the *_out ones.
__global__ void __launch_bounds__(kMaxThreads)
lws_online_chunk_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                        const float* __restrict__ amp, const float* __restrict__ thr,
                        const float* __restrict__ ring_r_in,
                        const float* __restrict__ ring_i_in,
                        const float* __restrict__ amp_in, float* __restrict__ ring_r_out,
                        float* __restrict__ ring_i_out, float* __restrict__ amp_out,
                        float* __restrict__ out_r, float* __restrict__ out_i,
                        const float* __restrict__ wr, const float* __restrict__ wi,
                        const int* __restrict__ taps, const int* __restrict__ counts,
                        int N, int F, int Q, int L, int LA, int iters, int passes,
                        int color_k, int color_rounds, long long seen, int n_live) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int WR = LA + Q;
  const int WA = LA + 1;
  const size_t plane = (size_t)N * F;
  const float* Sr = sr + b * plane;
  const float* Si = si + b * plane;
  const float* A = amp + b * plane;
  const float* Th = thr + (size_t)b * N * iters;
  float* Or = out_r + b * plane;
  float* Oi = out_i + b * plane;
  float* amp_ring;
  // chunk-relative frame f (f < 0: the state's frames) is absolute seen + f
  const Window w = make_window(smem, F, Q, L, LA, passes, color_k, color_rounds, wr, wi,
                               taps, counts, (int)(seen % WR), WA * F, &amp_ring);
  const int abase = (int)(seen % WA);
  auto amp_row = [&](int f) {
    const int s = (f + abase) % WA;
    return amp_ring + (s < 0 ? s + WA : s) * F;
  };

  const size_t ring_off = (size_t)b * WR * F;
  for (int i = tid; i < WR * F; i += nth) {
    w.ring_r[i] = __ldg(ring_r_in + ring_off + i);
    w.ring_i[i] = __ldg(ring_i_in + ring_off + i);
  }
  for (int i = tid; i < WA * F; i += nth) amp_ring[i] = __ldg(amp_in + (size_t)b * WA * F + i);
  __syncthreads();

  for (int m = 0; m < N; ++m) {
    const bool live = m < n_live;
    const int newest = w.slot(m) * F;
    float* amp_m = amp_row(m);
    for (int n = tid; n < F; n += nth) {
      w.ring_r[newest + n] = __ldg(Sr + (size_t)m * F + n);
      w.ring_i[newest + n] = __ldg(Si + (size_t)m * F + n);
      amp_m[n] = live ? __ldg(A + (size_t)m * F + n) : 0.f;
    }
    __syncthreads();
    if (live) {
      row_update(w, m, 0, 0.f, amp_m);
      for (int h = 0; h < iters; ++h) {
        const float th = __ldg(Th + (size_t)m * iters + h);
        for (int d = LA; d >= 1; --d) {
          // frames before the stream start are frozen replicas
          if (seen + m - d >= 0) row_update(w, m - d, 2 + d - 1, th, amp_row(m - d));
        }
        row_update(w, m, 1, th, amp_m);
      }
    }
    // frame m-LA is final: output row m. Thread n commits bin n, which only
    // thread n rewrites when a later frame reuses the slot
    const int row = w.slot(m - LA) * F;
    for (int n = tid; n < F; n += nth) {
      Or[(size_t)m * F + n] = w.ring_r[row + n];
      Oi[(size_t)m * F + n] = w.ring_i[row + n];
    }
  }
  __syncthreads();  // the state goes out whole
  for (int i = tid; i < WR * F; i += nth) {
    ring_r_out[ring_off + i] = w.ring_r[i];
    ring_i_out[ring_off + i] = w.ring_i[i];
  }
  for (int i = tid; i < WA * F; i += nth) amp_out[(size_t)b * WA * F + i] = amp_ring[i];
}

// Launch arguments a kernel does not take (checked before any launch).
bool bad_geometry(int B, int T, int F, int Q, int L, int LA, int iters, int passes,
                  int color_k, int color_rounds) {
  return B < 1 || T < 1 || Q < 1 || Q > kMaxQ || L < 0 || F < L + 1 || LA < 0 ||
         LA > kMaxLA || iters < 1 || passes < 1 || color_k < 0 || color_rounds < 1;
}

}  // namespace

extern "C" {

// Shared memory one CTA needs: the ring, six F-rows of scratch, the tap
// lists and counts.
int lws_online_smem_bytes(int F, int Q, int L, int LA) {
  const int S = 2 + LA;
  const int WR = LA + Q;
  return (int)sizeof(float) * ((2 * WR + 6) * F) +
         (int)sizeof(int) * (S * (2 * Q - 1) * (2 * L + 1) + 2 * S);
}

// Shared memory of one K4 CTA: K3's and the LA+1 amp rows.
int lws_online_chunk_smem_bytes(int F, int Q, int L, int LA) {
  return lws_online_smem_bytes(F, Q, L, LA) + (int)sizeof(float) * (LA + 1) * F;
}

// Runs the online stage over (sr, si) into (out_r, out_i) on `stream`.
// Returns the cudaError_t of the launch (0 on success).
int lws_online_launch(const void* sr, const void* si, const void* amp,
                      void* out_r, void* out_i, const void* wr, const void* wi,
                      const void* taps, const void* counts, const void* thr,
                      int B, int T, int F, int Q, int L, int LA, int iters,
                      int passes, int color_k, int color_rounds, void* stream) {
  if (bad_geometry(B, T, F, Q, L, LA, iters, passes, color_k, color_rounds)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = lws_online_smem_bytes(F, Q, L, LA);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lws_online_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  lws_online_kernel<<<B, threads_for(F), bytes, (cudaStream_t)stream>>>(
      (const float*)sr, (const float*)si, (const float*)amp, (float*)out_r,
      (float*)out_i, (const float*)wr, (const float*)wi, (const int*)taps,
      (const int*)counts, (const float*)thr, T, F, Q, L, LA, iters, passes,
      color_k, color_rounds);
  return (int)cudaGetLastError();
}

// Runs K4 over one chunk (sr, si, amp: (B, N, F); thr: (B, N, iters)) from
// the state (ring_*_in, amp_in) into (out_r, out_i) and the state buffers
// (ring_*_out, amp_out), on `stream`; frames m >= n_live are drain steps.
// Returns the cudaError_t of the launch (0 on success).
int lws_online_chunk_launch(const void* sr, const void* si, const void* amp,
                            const void* thr, const void* ring_r_in, const void* ring_i_in,
                            const void* amp_in, void* ring_r_out, void* ring_i_out,
                            void* amp_out, void* out_r, void* out_i, const void* wr,
                            const void* wi, const void* taps, const void* counts, int B,
                            int N, int F, int Q, int L, int LA, int iters, int passes,
                            int color_k, int color_rounds, long long seen, int n_live,
                            void* stream) {
  if (bad_geometry(B, N, F, Q, L, LA, iters, passes, color_k, color_rounds) ||
      seen < 0 || n_live < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = lws_online_chunk_smem_bytes(F, Q, L, LA);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lws_online_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  lws_online_chunk_kernel<<<B, threads_for(F), bytes, (cudaStream_t)stream>>>(
      (const float*)sr, (const float*)si, (const float*)amp, (const float*)thr,
      (const float*)ring_r_in, (const float*)ring_i_in, (const float*)amp_in,
      (float*)ring_r_out, (float*)ring_i_out, (float*)amp_out, (float*)out_r,
      (float*)out_i, (const float*)wr, (const float*)wi, (const int*)taps,
      (const int*)counts, N, F, Q, L, LA, iters, passes, color_k, color_rounds, seen,
      n_live);
  return (int)cudaGetLastError();
}

const char* lws_online_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
