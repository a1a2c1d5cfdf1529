// Device helpers shared by the LWS kernels (lws_sweeps.cu, lws_online.cu).
//
// Both kernels keep a frame row as F interior bins and read its frequency
// margins by conjugate reflection, and both end a bin update with the same
// magnitude-restoring epilogue as the plain version's phase_update
// (lws_torch/core/stencil.py). Build with -fmad=false so each product and
// sum rounds on its own, as the plain version rounds them.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 16;  // the JAX kernels' MAX_Q: K5 (K1, K3 and K4 have no cap)
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // per-block opt-in limit on sm_90

// One frequency-margin read of row (rr, ri): conjugate reflection outside
// [0, F-1] (j < 0 -> conj x[-j], j > F-1 -> conj x[2(F-1)-j]).
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

// (nr, ni) <- temp * a * rsqrt(|temp|^2) where a > th and |temp|^2 > 0;
// otherwise (nr, ni) keep the fallback the caller put there.
__device__ __forceinline__ void phase_update(float tr, float ti, float a,
                                             float th, float& nr, float& ni) {
  const float a2 = tr * tr + ti * ti;
  const float scale = a * rsqrtf(a2 > 0.f ? a2 : 1.f);
  if (a > th && a2 > 0.f) {
    nr = tr * scale;
    ni = ti * scale;
  }
}

inline int threads_for(int F) {
  return F >= kMaxThreads ? kMaxThreads : ((F + 31) / 32) * 32;
}

}  // namespace
