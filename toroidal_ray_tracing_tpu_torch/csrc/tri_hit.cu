// K1: triangle closest-hit / any-hit over SAH clusters, one thread per ray.
//
// Replaces the JAX package's TPU kernel ops/tri_kernel.py:77
// (_tri_kernel, launched by tri_closest_hit_pallas). Plain twin:
// toroidal_ray_tracing_tpu_torch/ops/tri_kernel.py::tri_closest_hit_plain.
//
// Contract (the TPU kernel's): clusters in the wrapper's front-to-back
// order, each skipped when its box misses the ray before min(t_best, tmax)
// (any-hit: the ray stops at its first hit); the Woop unit-triangle test
// keeps the minimum t in [TMIN, tmax], the lowest row winning inside a
// cluster and the earlier-visited cluster winning ties across clusters.
// That winner is the minimum of (t, rank, row), where a cluster's rank is
// its position in the visit order. With attrs, the winner's 21
// interpolated shading rows are written once after the walk (A0 + u*A1 +
// v*A2 for rows 0-7, A0 for rows 8-20). Beside the hit, optionally, the
// query's folds for the kernel after it (common.cuh write_folds): its tmax
// and the occlusion byte.
//
// The walk: K5's (csrc/tree_walk.cuh) with one cluster per leaf. The twin
// tests every one of the mesh's cluster boxes per ray (181 at config 6, 26
// operations each: most of the flat walk's operations); the kernel walks a
// binary tree over the live clusters' boxes (ops/kernel_common.py
// build_tree; the hoisted loose tail's far-boxed clusters are no leaves) as
// warp packets and compares the full (t, rank, row) key, so it returns the
// flat walk's bits. A leaf's box is its cluster's, so the cluster is not
// tested twice; inside it each 32-row group has a box of its own
// (ops/tri_kernel.py group_boxes), and a ray tests a group's rows only
// where it passes that box at its running bound (tree_walk.cuh
// walk_cluster_grouped): an entered cluster's padding and the groups
// beyond a ray's hit are skipped. A single uncullable block (one cluster,
// or a slice not cut on cluster boundaries) is a one-leaf tree walked with
// no box test.
//
// What bounds it: the slab tests of the nodes and groups a warp enters and
// the Woop tests (~50 operations each) of the groups its rays enter, not
// bytes: the Woop table is 96 B per triangle (2.2 MB for config 6's mesh,
// inside the 50 MB L2) and every lane of a warp reads the same row. The
// spread of a warp's rays over clusters is what costs: the tree's packets
// share their nodes' loads, and the cooperative test spreads a cluster
// that few rays enter over all 32 lanes. With counters, the third counts
// the (warp, group) pairs whose rows the warp tested.
#include "tree_walk.cuh"

namespace {

__global__ void __launch_bounds__(128) tri_closest_hit(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, long long rs,
    const float* __restrict__ wrows,
    int n_tris, const float* __restrict__ tree_lo,
    const float* __restrict__ tree_hi, const int* __restrict__ tree_link,
    int n_nodes, const int* __restrict__ rank, int cluster, int box_test,
    const float* __restrict__ glo, const float* __restrict__ ghi,
    const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ a2, int occlusion, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ attr_out,
    long long* __restrict__ counters, float* __restrict__ tmax_out,
    bool* __restrict__ occ_out, int occ_or) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const trt::Ray r = trt::load_ray(origins, dirs, tmax, n, rs, i);
  trt::Best b;
  trt::Work w;
  unsigned groups = 0;  // the same on every lane of the warp
  b.done = !(r.tm > TRT_TMIN);  // pad and dead rays take part in no test
  trt::walk_warp_packet(r, b, w, tree_lo, tree_hi, tree_link, n_nodes,
                        box_test, rank, glo, ghi, 1, cluster, n_tris, wrows,
                        occlusion, nullptr, &groups);
  if (i < n) {
    trt::write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out, v_out,
                   attr_out);
    trt::write_folds(b.t, r.tm, occlusion, tmax_out, occ_out, occ_or, i);
  }
  trt::add_work(counters, w);
  if (counters != nullptr && (threadIdx.x & 31) == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(counters) + 2,
              (unsigned long long)groups);
}

}  // namespace

extern "C" int trt_tri_closest_hit(
    const float* origins, const float* dirs, const float* tmax, int n,
    long long rs, const float* wrows, int n_tris, const float* tree_lo,
    const float* tree_hi, const int* tree_link, int n_nodes, int depth,
    const int* rank, int cluster, int box_test, const float* glo,
    const float* ghi, const float* a0, const float* a1, const float* a2,
    int occlusion, float* t_out,
    int* idx_out, float* u_out, float* v_out, float* attr_out,
    long long* counters, float* tmax_out, bool* occ_out, int occ_or,
    void* stream) {
  if (depth > trt::kStack) return (int)cudaErrorInvalidValue;
  const int blocks = (n + 127) / 128;
  tri_closest_hit<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, rs, wrows, n_tris, tree_lo, tree_hi, tree_link,
      n_nodes, rank, cluster, box_test, glo, ghi, a0, a1, a2, occlusion, t_out,
      idx_out, u_out, v_out, attr_out, counters, tmax_out, occ_out, occ_or);
  return (int)cudaGetLastError();
}
