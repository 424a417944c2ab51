// K1: triangle closest-hit / any-hit over SAH clusters, one thread per ray.
//
// Replaces the JAX package's TPU kernel ops/tri_kernel.py:77
// (_tri_kernel, launched by tri_closest_hit_pallas). Plain twin:
// toroidal_ray_tracing_tpu_torch/ops/tri_kernel.py::tri_closest_hit_plain.
//
// Per ray, clusters are walked in the wrapper's front-to-back order. Each
// cluster's AABB is slab-tested against bound = min(t_best, tmax) (any-hit:
// a ray stops at its first hit); a passing cluster runs the Woop
// unit-triangle test on its `cluster` rows, keeping the minimum with a
// strict `<` so the lowest index wins inside a cluster and the earlier
// visited cluster wins ties across clusters — the TPU kernel's order.
// With attrs, the winner's 21 interpolated shading rows are written once
// after the walk (A0 + u*A1 + v*A2 for rows 0-7, A0 for rows 8-20).
//
// What bounds it: the per-ray dependent ALU/latency chain (about 50
// operations per (ray, triangle) Woop test and 26 per (ray, box) slab test,
// as common.cuh writes them), not bytes: the Woop table is 96 B per
// triangle (2.2 MB for the 23k-tri mesh) and every lane of a warp reads the
// same row, so the loads are broadcasts that stay L1/L2-resident. Rays arrive block-major (compact
// screen patches), so a warp's rays visit nearly the same clusters and
// divergence stays low. No tensor cores, TMA or shared-memory staging in
// this first version.
#include "common.cuh"

namespace {

__global__ void tri_closest_hit(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, const float* __restrict__ wrows,
    const float* __restrict__ clo, const float* __restrict__ chi,
    const int* __restrict__ order, int n_clusters, int cluster, int box_test,
    const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ a2, int n_tris, int occlusion,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ attr_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {origins[i], origins[n + i], origins[2 * n + i]};
  const float d[3] = {dirs[i], dirs[n + i], dirs[2 * n + i]};
  const float tm = tmax[i];
  const float inv[3] = {trt::inv_dir(d[0]), trt::inv_dir(d[1]),
                        trt::inv_dir(d[2])};

  float best = TRT_BIG, bu = 0.0f, bv = 0.0f;
  int bidx = 0;
  bool done = false;
  for (int vi = 0; vi < n_clusters && !done; ++vi) {
    const int c = order[vi];
    const float bound = occlusion ? (best < TRT_BIG ? -1.0f : tm)
                                  : trt::jmin(best, tm);
    if (box_test &&
        !trt::slab_pass(clo + 3 * c, chi + 3 * c, o, inv, bound, tm))
      continue;
    const int base = c * cluster;
    for (int j = 0; j < cluster; ++j) {
      float t, u, v;
      const bool hit = trt::woop_test(wrows + (size_t)(base + j) * 24, o, d,
                                      tm, &t, &u, &v);
      if (hit && t < best) {
        best = t;
        bidx = base + j;
        bu = u;
        bv = v;
        if (occlusion) {
          done = true;
          break;
        }
      }
    }
  }
  t_out[i] = best;
  idx_out[i] = bidx;
  u_out[i] = bu;
  v_out[i] = bv;
  if (attr_out != nullptr)
    trt::write_tri_attrs(a0, a1, a2, n_tris, attr_out, n, i, best, bidx, bu,
                         bv);
}

}  // namespace

extern "C" int trt_tri_closest_hit(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* wrows, const float* clo, const float* chi, const int* order,
    int n_clusters, int cluster, int box_test, const float* a0,
    const float* a1, const float* a2, int n_tris, int occlusion,
    float* t_out, int* idx_out, float* u_out, float* v_out, float* attr_out,
    void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  tri_closest_hit<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, wrows, clo, chi, order, n_clusters, cluster,
      box_test, a0, a1, a2, n_tris, occlusion, t_out, idx_out, u_out, v_out,
      attr_out);
  return (int)cudaGetLastError();
}
