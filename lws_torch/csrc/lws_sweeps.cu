// Thresholded Gauss-Seidel LWS sweeps on Hopper (sm_90a).
//
// Replaces the TPU kernel lws_tpu/ops/pallas_packed.py::tiled_lws_sweeps
// (_tiled_sweeps_kernel, frame body _window_sweep, _freq_halo,
// _color_rounds, the dead-sweep skip _live_iters). It computes what that
// kernel computes, not its VMEM tile plan:
//
//   for each sweep it (skipped when live[b, it] == 0, which is exact):
//     for each frame m in order (Gauss-Seidel: frames m-Q+1..m-1 hold this
//     sweep's values, m+1..m+Q-1 the previous sweep's, read in place):
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
// Design: one CTA per utterance, threads over the F bins (a loop when
// F > blockDim). Frames within a sweep are serial, so each frame is one
// step of the CTA with __syncthreads() between the reads of a row and the
// writes to it: every thread's write of frame m lands before any thread
// reads it for frame m+1. In-frame passes ping-pong the centre row
// between two shared-memory buffers. The weights are staged in shared
// memory when they fit (158 KB at Q=4, L=5, F=257) and read through the
// read-only path otherwise. All sweeps run in one launch.
//
// Bound on this card: not bytes and not FLOPs but the serial frame chain.
// A batch_lws call is T x live sweeps x (1 + in-frame passes)
// barrier-separated steps per CTA, and only B CTAs (32 on the main path)
// run on the H100's 132 SMs, each with ~9 warps. Splitting F across a
// thread-block cluster, packing several utterances per CTA and keeping the
// 2Q-1 row window resident in shared memory are left to a later change.
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
// jacobi passes whatever the scheme), a barrier. It shares the tap sums,
// the centre pass and the epilogue with lws_sweeps_kernel. At micro = 1
// packed_lws_sweeps is K1's frame order, and its wrapper launches
// lws_sweeps_kernel. It is bound like K1 by its serial chain, with micro
// times fewer barrier steps per sweep; the state stays in device memory
// (L2), not resident in shared memory.

#include <cuda_runtime.h>

#include "lws_common.cuh"

namespace {

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

template <bool kSmemWeights>
__global__ void __launch_bounds__(kMaxThreads)
lws_sweeps_kernel(float* xr, float* xi,  // state: written, so not read-only
                  const float* __restrict__ amp,
                  const float* __restrict__ wr_g,
                  const float* __restrict__ wi_g,
                  const float* __restrict__ thr,
                  const int* __restrict__ live,
                  int T, int F, int Q, int L, int iters, int passes,
                  int color_k, int color_rounds, int has_centre) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int Q1 = Q - 1;
  const int R = 2 * Q - 1;
  const int K = 2 * L + 1;
  const size_t plane = (size_t)(T + 2 * Q1) * F;
  float* Xr = xr + b * plane;
  float* Xi = xi + b * plane;
  const float* A = amp + (size_t)b * T * F;

  float* s_tr = smem;          // off-centre tap sums
  float* s_ti = smem + F;
  float* s_row[2][2] = {{smem + 2 * F, smem + 3 * F},   // centre-row ping-pong
                        {smem + 4 * F, smem + 5 * F}};
  const float* Wr = wr_g;
  const float* Wi = wi_g;
  if (kSmemWeights) {
    float* s_wr = smem + 6 * F;
    float* s_wi = s_wr + R * K * F;
    for (int i = tid; i < R * K * F; i += nth) {
      s_wr[i] = __ldg(wr_g + i);
      s_wi[i] = __ldg(wi_g + i);
    }
    __syncthreads();
    Wr = s_wr;
    Wi = s_wi;
  }

  const int n_pass = has_centre ? (color_k > 0 ? color_k * color_rounds : passes) : 0;

  for (int it = 0; it < iters; ++it) {
    if (__ldg(live + b * iters + it) == 0) continue;  // uniform over the CTA
    const float th = __ldg(thr + b * iters + it);
    for (int m = 0; m < T; ++m) {
      const float* amp_m = A + (size_t)m * F;
      float* cen_r = Xr + (size_t)(m + Q1) * F;
      float* cen_i = Xi + (size_t)(m + Q1) * F;

      for (int n = tid; n < F; n += nth) {
        float tr, ti;
        off_centre_taps<kSmemWeights>(Xr, Xi, Wr, Wi, m, n, F, Q1, K, L, tr, ti);
        if (n_pass == 0) {
          // no centre taps (the no-future stencil): no other thread reads
          // the centre row during this frame, so write it at once
          float nr = cen_r[n], ni = cen_i[n];
          phase_update(tr, ti, __ldg(amp_m + n), th, nr, ni);
          cen_r[n] = nr;
          cen_i[n] = ni;
        } else {
          s_tr[n] = tr;
          s_ti[n] = ti;
          s_row[0][0][n] = cen_r[n];
          s_row[0][1][n] = cen_i[n];
        }
      }

      for (int p = 0; p < n_pass; ++p) {
        __syncthreads();  // the row this pass reads is complete
        const float* src_r = s_row[p & 1][0];
        const float* src_i = s_row[p & 1][1];
        const bool last = p + 1 == n_pass;
        float* dst_r = last ? cen_r : s_row[(p + 1) & 1][0];
        float* dst_i = last ? cen_i : s_row[(p + 1) & 1][1];
        const int color = color_k > 0 ? p % color_k : -1;
        for (int n = tid; n < F; n += nth) {
          // jacobi falls back to the original centre row (still in global
          // memory until the last pass writes it: thread n alone reads and
          // writes bin n there); colors fall back to the evolving row
          float nr = color_k > 0 ? src_r[n] : cen_r[n];
          float ni = color_k > 0 ? src_i[n] : cen_i[n];
          if (color < 0 || n % color_k == color) {
            centre_update<kSmemWeights>(src_r, src_i, Wr, Wi, n, F, Q1, K, L, s_tr[n],
                                        s_ti[n], __ldg(amp_m + n), th, nr, ni);
          }
          dst_r[n] = nr;
          dst_i[n] = ni;
        }
      }
      __syncthreads();  // frame m is written before frame m+1 reads it
    }
  }
}

// The grouped sweeps (K5) at micro > 1: the same state layout and
// arguments as lws_sweeps_kernel, frames updated `micro` at a time, jacobi
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
// Returns the cudaError_t of the launch (0 on success).
int lws_sweeps_launch(void* xr, void* xi, const void* amp, const void* wr,
                      const void* wi, const void* thr, const void* live,
                      int B, int T, int F, int Q, int L, int iters,
                      int passes, int color_k, int color_rounds,
                      int has_centre, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || Q > kMaxQ || L < 0 || F < L + 1 ||
      iters < 0 || passes < 1 || color_k < 0 || color_rounds < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (iters == 0) return (int)cudaSuccess;
  const int threads = threads_for(F);
  const bool stage = smem_bytes(F, Q, L, true) <= kSmemLimit;
  if (smem_bytes(F, Q, L, stage) > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int bytes = (int)smem_bytes(F, Q, L, stage);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (stage) {
    err = cudaFuncSetAttribute(lws_sweeps_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    lws_sweeps_kernel<true><<<B, threads, bytes, s>>>(
        (float*)xr, (float*)xi, (const float*)amp, (const float*)wr,
        (const float*)wi, (const float*)thr, (const int*)live, T, F, Q, L,
        iters, passes, color_k, color_rounds, has_centre);
  } else {
    err = cudaFuncSetAttribute(lws_sweeps_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    lws_sweeps_kernel<false><<<B, threads, bytes, s>>>(
        (float*)xr, (float*)xi, (const float*)amp, (const float*)wr,
        (const float*)wi, (const float*)thr, (const int*)live, T, F, Q, L,
        iters, passes, color_k, color_rounds, has_centre);
  }
  return (int)cudaGetLastError();
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
