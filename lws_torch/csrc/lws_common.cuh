// Device helpers shared by the LWS kernels (lws_sweeps.cu, lws_online.cu).
//
// The kernels keep a frame row as F interior bins and read its frequency
// margins by conjugate reflection (in device memory) or keep the reflected
// margins stored beside it (interleaved (re, im) rows in shared memory),
// and all end a bin update with the same magnitude-restoring epilogue as
// the plain version's phase_update (lws_torch/core/stencil.py). Build with
// -fmad=false so each product and sum rounds on its own, as the plain
// version rounds them.

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

// Bin n of an interleaved row (bin j at index j + L) and the margin cells
// that reflect it: index L - n for 1 <= n <= L, and 2(F-1) - n + L for
// F-1-L <= n <= F-2, imaginary part negated (read_bin's reflection, stored
// once instead of branched on per tap).
__device__ __forceinline__ void put_cbin(float2* row, int n, int F, int L, float vr,
                                         float vi) {
  row[n + L] = float2{vr, vi};
  if (n >= 1 && n <= L) row[L - n] = float2{vr, -vi};
  if (n >= F - 1 - L && n <= F - 2) row[2 * (F - 1) - n + L] = float2{vr, -vi};
}

// acc += w * v, complex, in the order every version of the kernels uses.
__device__ __forceinline__ void cmac(float& ar, float& ai, float2 w, float2 v) {
  ar = ar + (w.x * v.x - w.y * v.y);
  ai = ai + (w.x * v.y + w.y * v.x);
}

}  // namespace
