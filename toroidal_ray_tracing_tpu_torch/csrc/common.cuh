// Shared device helpers of the trace kernels (tri_hit.cu, torus_hit.cu,
// tri_stream.cu).
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
// tn <= min(tf, bound) & tf >= TMIN & tmax > TMIN. 26 operations as written
// (6 subtractions, 6 products, 10 min/max, 4 compares).
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

// One row of the (T, 24) Woop table (tri_kernel.woop_rows) against one
// ray: the unit-triangle test of geom/triangle.py woop_hit. Returns whether
// the ray hits in [TMIN, tmax]; t, u, v are written either way. About 50
// operations as written (two affine 3-vectors, one division, the compares).
__device__ __forceinline__ bool woop_test(const float* w, const float o[3],
                                          const float d[3], float tmax,
                                          float* t_out, float* u_out,
                                          float* v_out) {
  const float opx = ((w[0] * o[0] + w[1] * o[1]) + w[2] * o[2]) + w[3];
  const float opy = ((w[4] * o[0] + w[5] * o[1]) + w[6] * o[2]) + w[7];
  const float opz = ((w[8] * o[0] + w[9] * o[1]) + w[10] * o[2]) + w[11];
  const float dpx = (w[12] * d[0] + w[13] * d[1]) + w[14] * d[2];
  const float dpy = (w[16] * d[0] + w[17] * d[1]) + w[18] * d[2];
  const float dpz = (w[20] * d[0] + w[21] * d[1]) + w[22] * d[2];
  const bool dz_ok = fabsf(dpz) > TRT_F(1e-12);
  const float inv_dz = (dz_ok ? 1.0f : 0.0f) / (dz_ok ? dpz : 1.0f);
  const float t = -opz * inv_dz;
  const float u = opx + t * dpx;
  const float v = opy + t * dpy;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return dz_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= TRT_TMIN &&
         t <= tmax;
}

// The winner's 21 shading rows, once after a triangle walk: A0 + u*A1 +
// v*A2 for rows 0-7, A0 for rows 8-20, zero on a miss. Tables (21|8, T),
// output (21, n) row-major, so neighbouring rays store to neighbouring words.
__device__ __forceinline__ void write_tri_attrs(
    const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ a2, int n_tris, float* __restrict__ attr_out,
    int n, int i, float best, int bidx, float bu, float bv) {
  const bool hit = best < TRT_BIG;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const size_t k = (size_t)r * n_tris + bidx;
    attr_out[(size_t)r * n + i] =
        hit ? (a0[k] + bu * a1[k]) + bv * a2[k] : 0.0f;
  }
#pragma unroll
  for (int r = 8; r < 21; ++r)
    attr_out[(size_t)r * n + i] = hit ? a0[(size_t)r * n_tris + bidx] : 0.0f;
}

// The folds a query's kernel writes beside its hit, for the kernel after
// it (ops/kernel_common.py fold_outputs): the occlusion byte, t < BIG
// (with occ_or the earlier kernels' byte is kept and only a hit is stored:
// no read); the next kernel's tmax, in occlusion mode 0 where this kernel
// hits and tmax elsewhere (an earlier kernel that occluded the lane left
// its tmax 0), else min(tmax, t). Either output may be absent (NULL).
__device__ __forceinline__ void write_folds(float t, float tm, int occlusion,
                                            float* __restrict__ tmax_out,
                                            bool* __restrict__ occ_out,
                                            int occ_or, int i) {
  const bool hit = t < TRT_BIG;
  if (occ_out != nullptr && (hit || !occ_or)) occ_out[i] = hit;
  if (tmax_out != nullptr)
    tmax_out[i] = occlusion ? (hit ? 0.0f : tm) : jmin(tm, t);
}

}  // namespace trt
