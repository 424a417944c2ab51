// Shared device helpers of the trace kernels (tri_hit.cu, torus_hit.cu).
//
// Every helper reproduces the plain PyTorch twin's arithmetic operation by
// operation: the library is built with --fmad=false, min/max propagate NaN
// like torch.minimum/maximum (fminf/fmaxf would drop a NaN operand), and
// float constants are written as (float)(double expression), the value a
// Python float takes when it meets a float32 tensor.
#pragma once

#include <cuda_runtime.h>

#define TRT_F(x) ((float)(x))
#define TRT_BIG TRT_F(3.0e38)
#define TRT_TMIN TRT_F(1.0e-3)

namespace trt {

__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// kernel_common._inv_dir: |d| <= 1e-30 -> +/-3e38 by sign
__device__ __forceinline__ float inv_dir(float d) {
  const bool ok = fabsf(d) > TRT_F(1e-30);
  const float r = (ok ? 1.0f : 0.0f) / (ok ? d : 1.0f);
  return ok ? r : (d >= 0.0f ? TRT_F(3e38) : TRT_F(-3e38));
}

// kernel_common.slab + the pass rule every walk uses:
// tn <= min(tf, bound) & tf >= TMIN & tmax > TMIN
__device__ __forceinline__ bool slab_pass(const float* lo, const float* hi,
                                          const float o[3],
                                          const float inv[3], float bound,
                                          float tmax) {
  float t0[3], t1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    t0[a] = (lo[a] - o[a]) * inv[a];
    t1[a] = (hi[a] - o[a]) * inv[a];
  }
  const float tn = jmax(jmax(jmin(t0[0], t1[0]), jmin(t0[1], t1[1])),
                        jmin(t0[2], t1[2]));
  const float tf = jmin(jmin(jmax(t0[0], t1[0]), jmax(t0[1], t1[1])),
                        jmax(t0[2], t1[2]));
  return (tn <= jmin(tf, bound)) && (tf >= TRT_TMIN) && (tmax > TRT_TMIN);
}

}  // namespace trt
