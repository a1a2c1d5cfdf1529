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
// PyTorch version (lws_torch/core/stencil.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 16;
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // per-block opt-in limit on sm_90

template <bool kSmemWeights>
__device__ __forceinline__ float load_w(const float* w, int idx) {
  if (kSmemWeights) return w[idx];
  return __ldg(w + idx);
}

// One frequency-margin read of row (rr, ri): conjugate reflection outside
// [0, F-1].
__device__ __forceinline__ void read_bin(const float* rr, const float* ri,
                                         int j, int F, float& br, float& bi) {
  if (j < 0) {
    br = rr[-j];
    bi = -ri[-j];
  } else if (j > F - 1) {
    const int jj = 2 * (F - 1) - j;
    br = rr[jj];
    bi = -ri[jj];
  } else {
    br = rr[j];
    bi = ri[j];
  }
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
        float tr = 0.f, ti = 0.f;
        for (int dr = 0; dr < R; ++dr) {
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
        if (n_pass == 0) {
          // no centre taps (the no-future stencil): no other thread reads
          // the centre row during this frame, so write it at once
          const float a = __ldg(amp_m + n);
          const float a2 = tr * tr + ti * ti;
          const float scale = a * rsqrtf(a2 > 0.f ? a2 : 1.f);
          if (a > th && a2 > 0.f) {
            cen_r[n] = tr * scale;
            cen_i[n] = ti * scale;
          }
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
            const float fr = s_tr[n] + cr;
            const float fi = s_ti[n] + ci;
            const float a = __ldg(amp_m + n);
            const float a2 = fr * fr + fi * fi;
            const float scale = a * rsqrtf(a2 > 0.f ? a2 : 1.f);
            if (a > th && a2 > 0.f) {
              nr = fr * scale;
              ni = fi * scale;
            }
          }
          dst_r[n] = nr;
          dst_i[n] = ni;
        }
      }
      __syncthreads();  // frame m is written before frame m+1 reads it
    }
  }
}

int smem_bytes(int F, int Q, int L, bool weights) {
  const int base = 6 * F * (int)sizeof(float);
  return weights ? base + 2 * (2 * Q - 1) * (2 * L + 1) * F * (int)sizeof(float)
                 : base;
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
  const int threads = F >= kMaxThreads ? kMaxThreads : ((F + 31) / 32) * 32;
  const bool stage = smem_bytes(F, Q, L, true) <= kSmemLimit;
  const int bytes = smem_bytes(F, Q, L, stage);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
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

const char* lws_sweeps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
