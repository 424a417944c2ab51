// S1: the loose-triangle hoist, one thread per ray.
//
// Replaces what XLA fuses of the JAX package's ops/trace_kernel.py:207
// (_loose_tri_hit) and the hit merge after it (:325-333): no Pallas kernel.
// Plain twin: toroidal_ray_tracing_tpu_torch/ops/loose_kernel.py::
// loose_hit_plain.
//
// Per ray, the Woop unit-triangle test (common.cuh woop_test, the
// arithmetic K1 runs) against the scene's L <= 16 loose tail rows (a ground
// or mirror plane: `Scene.loose_tris`, compacted to the table tail by the
// build), the lowest row winning ties (strict <). Writes the merged form the
// triangle kernels start from: t (BIG on a miss), kind (0 on a hit, -1 on a
// miss), prim (prim_base + row on a hit, 0 on a miss), u, v (0 on a miss),
// and the triangle kernels' tmax: min(tmax, t), or, in occlusion mode, 0 on
// a hit and tmax on a miss; in occlusion mode also the query's occlusion
// byte (t < BIG), which the later kernels of the query OR into. The rays'
// rows lie rs floats apart (n for a (3, n) tensor, the state's lanes for a
// prefix of the bounce loop's state), as every trace kernel reads them.
//
// What bounds it on an H100 SXM (80 GB HBM3, 700 W): bytes. Per ray 28 B in
// (origin, direction, tmax) and 24 B out; the L x 84 B of Woop entries go
// to shared memory once a block (read from the scene's own (3, 4, T) and
// (3, 3, T) tables, so no table is kept for them) and every lane reads the
// same row. L Woop tests of ~50 operations are 800 operations a ray at
// L = 16 (config 3's mirror plane: L = 2), far under the byte time at 67
// TFLOP/s. The JAX formulation's (3, L, N) einsum products and (L, N)
// one-hots never exist here.
#include "common.cuh"

namespace {

constexpr int kMaxLoose = 16;   // scene/build.py LOOSE_TOTAL_MAX
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) loose_hit(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, long long rs,
    const float* __restrict__ woop_o,
    const float* __restrict__ woop_d, int n_tris, int base, int n_rows,
    int prim_base, int occlusion, float* __restrict__ t_out,
    int* __restrict__ kind_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ tmax_out, bool* __restrict__ occ_out) {
  // rows [base, base + n_rows) of the (3, 4, T) / (3, 3, T) Woop tables as
  // 24-float rows (tri_kernel.woop_rows' layout, common.cuh woop_test)
  __shared__ float w[kMaxLoose * 24];
  for (int k = threadIdx.x; k < n_rows * 24; k += blockDim.x) {
    const int l = k / 24, c = k % 24, row = base + l;
    float x = 0.0f;
    if (c < 12)
      x = woop_o[(size_t)c * n_tris + row];
    else if ((c - 12) % 4 < 3)
      x = woop_d[(size_t)((c - 12) / 4 * 3 + (c - 12) % 4) * n_tris + row];
    w[k] = x;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[a * rs + i];
    d[a] = dirs[a * rs + i];
  }
  const float tm = tmax[i];
  float best = TRT_BIG, bu = 0.0f, bv = 0.0f;
  int row = -1;
  for (int l = 0; l < n_rows; ++l) {
    float t, u, v;
    if (trt::woop_test(w + l * 24, o, d, tm, &t, &u, &v) && t < best) {
      best = t;
      bu = u;
      bv = v;
      row = l;
    }
  }
  const bool hit = row >= 0;
  t_out[i] = best;
  kind_out[i] = hit ? 0 : -1;
  prim_out[i] = hit ? prim_base + row : 0;
  u_out[i] = bu;
  v_out[i] = bv;
  trt::write_folds(best, tm, occlusion, tmax_out, occ_out, 0, i);
}

}  // namespace

extern "C" int trt_loose_hit(const float* origins, const float* dirs,
                             const float* tmax, int n, long long rs,
                             const float* woop_o,
                             const float* woop_d, int n_tris, int base,
                             int n_rows, int prim_base, int occlusion,
                             float* t_out, int* kind_out, int* prim_out,
                             float* u_out, float* v_out, float* tmax_out,
                             bool* occ_out, void* stream) {
  if (n_rows < 1 || n_rows > kMaxLoose || base < 0 ||
      base + n_rows > n_tris)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  loose_hit<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, rs, woop_o, woop_d, n_tris, base, n_rows,
      prim_base, occlusion, t_out, kind_out, prim_out, u_out, v_out,
      tmax_out, occ_out);
  return (int)cudaGetLastError();
}
