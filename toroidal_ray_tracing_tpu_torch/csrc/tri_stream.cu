// K5 and K6: triangle closest-hit / any-hit over superblocks, for meshes
// above 65,536 triangles.
//
// K5 `tri_closest_hit_stream` replaces the JAX package's TPU kernel
// ops/tri_stream.py:202 (_tri_stream_kernel); K6
// `tri_closest_hit_stream_grouped` replaces ops/tri_stream.py:303
// (_tri_stream_grouped_kernel). Both are launched by tri_closest_hit_stream
// (tri_stream.py:468). Plain twin of both:
// toroidal_ray_tracing_tpu_torch/ops/tri_stream.py
// ::tri_closest_hit_stream_plain.
//
// Contract (K1's, over superblocks of g 128-triangle clusters): the winner
// is the lexicographic minimum of (t, superblock rank, row) over the hits
// in [TMIN, tmax] (any-hit: the ray stops at its first hit). A box is
// entered when its slab test passes against bound = min(best, tmax); inside
// a passing superblock its clusters are walked in index order, each skipped
// by its own box (an exact shortcut: a skipped cluster holds no hit below
// the bound). The winner's 21 attr rows are written once after the walk;
// u/v are the true barycentrics in every mode. Beside the hit, optionally,
// the query's folds for the kernel after it (common.cuh write_folds).
//
// The walk. The twin visits every superblock in rank order; that O(S) walk
// of 26-operation slab tests (3,340 boxes at config 8, 3,348 slab tests per
// ray against 97 Woop tests) was 95% of the old K5's operations. Both
// kernels walk a binary tree over the superblock boxes instead
// (ops/kernel_common.py build_tree), K5 as warp packets with K1's walk
// (csrc/tree_walk.cuh, which notes the tree, the full (t, rank, row) key
// and the cooperative cluster test), K6 as CTA packets with the same leaf
// walk. With one stack per lane the warp's lanes sat in different leaves,
// each row load touched 32 lines and the warp paid every lane's leaves.
// What bounds them on the card: the latency of the few warps whose rays
// enter many leaves, not the average ray. The Woop table (96 B per
// triangle, 164 MB at config 8) exceeds L2, so K5 takes an entered
// cluster's rows through its warp's ring of two 32-row shared-memory tiles,
// the next tile's copy in flight while the warp tests the current one
// (tree_walk.cuh walk_superblock_tiled). Both kernels take an optional
// pointer to int64 counters: slab tests, Woop tests, and for K5 a third,
// the tiles it copied (K6 leaves it as it was).
//
// K6 is the GPU analog of the TPU's cross-tile DMA reuse: one CTA of 128
// block-major rays walks the tree as a packet (`__syncthreads_or` of the
// rays' tests, one stack in shared memory). At a leaf some thread passes,
// thread 0 copies the superblock's contiguous rows (<= 512 x 96 B) into
// shared memory with one 1-D bulk asynchronous copy (cp.async.bulk
// completing on an mbarrier), and the threads that pass test them with
// walk_superblock. A two-buffer variant that walked on to the next leaf and
// started its copy before testing the current one was slower (the
// look-ahead walks at stale bounds and re-tests each leaf) and is gone.
// The library is built with --fmad=false, so K5 and K6 compute the twin's
// bits wherever the walks meet a box at the same bound.
#include <cstdint>

#include "tree_walk.cuh"

namespace {

constexpr int kStreamRays = 128;  // K5's block
constexpr int kGroupRays = 128;
constexpr int kMaxSbRows = 512;

#define TRT_STREAM_ARGS                                                       \
  const float *__restrict__ origins, const float *__restrict__ dirs,         \
      const float *__restrict__ tmax, int n, long long rs,                    \
      const float *__restrict__ wrows, int n_tris,                            \
      const float *__restrict__ tree_lo,                                      \
      const float *__restrict__ tree_hi, const int *__restrict__ tree_link,   \
      int n_nodes, const int *__restrict__ rank,                              \
      const float *__restrict__ clo, const float *__restrict__ chi, int g,    \
      int cluster, const float *__restrict__ a0, const float *__restrict__ a1, \
      const float *__restrict__ a2, int occlusion, float *__restrict__ t_out, \
      int *__restrict__ idx_out, float *__restrict__ u_out,                   \
      float *__restrict__ v_out, float *__restrict__ attr_out,               \
      long long *__restrict__ counters, float *__restrict__ tmax_out,         \
      bool *__restrict__ occ_out, int occ_or

#define TRT_STREAM_PASS                                                      \
  origins, dirs, tmax, n, rs, wrows, n_tris, tree_lo, tree_hi, tree_link,    \
      n_nodes, rank, clo, chi, g, cluster, a0, a1, a2, occlusion, t_out,     \
      idx_out, u_out, v_out, attr_out, counters, tmax_out, occ_out, occ_or

// K5: one thread a ray, 4 warps a block, each warp with its ring of two
// row tiles (24 KB of static shared memory a block). With counters, the
// third counts the tiles copied.
__global__ void __launch_bounds__(kStreamRays) tri_closest_hit_stream(
    TRT_STREAM_ARGS) {
  __shared__ __align__(16) float tiles[kStreamRays / 32][2 * trt::kTileFloats];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const trt::Ray r = trt::load_ray(origins, dirs, tmax, n, rs, i);
  trt::Best b;
  trt::Work w;
  trt::TileRing ring{tiles[threadIdx.x / 32]};
  b.done = !(r.tm > TRT_TMIN);  // pad and dead rays take part in no test
  trt::walk_warp_packet<true>(r, b, w, tree_lo, tree_hi, tree_link, n_nodes,
                              1, rank, clo, chi, g, cluster, n_tris, wrows,
                              occlusion, &ring);
  if (i < n) {
    trt::write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out, v_out,
                   attr_out);
    trt::write_folds(b.t, r.tm, occlusion, tmax_out, occ_out, occ_or, i);
  }
  trt::add_work(counters, w);
  if (counters != nullptr && (threadIdx.x & 31) == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(counters) + 2,
              (unsigned long long)ring.copied);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Thread 0: copy the rows of superblock s into `dst`, completing on `bar`.
__device__ __forceinline__ void stage_rows(float* dst, uint64_t* bar,
                                           const float* wrows, int s,
                                           int sb_rows, int n_tris) {
  const int row0 = s * sb_rows;
  const uint32_t bytes = (uint32_t)min(sb_rows, n_tris - row0) * 96u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(wrows + (size_t)row0 * 24), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(kGroupRays)
    tri_closest_hit_stream_grouped(TRT_STREAM_ARGS) {
  extern __shared__ __align__(128) float staged[];  // sb_rows x 24
  __shared__ __align__(8) uint64_t bar;
  __shared__ int stack[trt::kStack];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kGroupRays + tid;
  const trt::Ray r = trt::load_ray(origins, dirs, tmax, n, rs, i);
  trt::Best b;
  trt::Work w;
  b.done = !(r.tm > TRT_TMIN);  // pad and dead rays take part in no test
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the packet's near side per axis: where most of its walking rays point
  const int walking = __syncthreads_count(!b.done);
  int neg = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    neg |= (2 * __syncthreads_count(!b.done && r.d[a] < 0.0f) > walking)
           << a;

  const int sb_rows = g * cluster;
  int m = n_nodes > 0 && walking > 0 ? 0 : -1;  // uniform across the CTA
  int sp = 0;
  bool leaf_pass = false;
  // The next leaf node some walking thread passes at its current bound
  // (this thread's own test in leaf_pass), or -1.
  auto next_leaf = [&]() -> int {
    while (m >= 0) {
      const bool pass =
          !b.done && trt::node_pass(tree_lo, tree_hi, m, r, b.t, occlusion, w);
      const int node = m;
      m = -1;
      if (__syncthreads_or(pass)) {
        const int left = tree_link[3 * node], right = tree_link[3 * node + 1];
        if (left < 0) {
          if (sp > 0) m = stack[--sp];
          leaf_pass = pass;
          return node;
        }
        const bool flip = (neg >> tree_link[3 * node + 2]) & 1;
        if (tid == 0) stack[sp] = flip ? left : right;
        ++sp;
        m = flip ? right : left;
      } else if (sp > 0) {
        m = stack[--sp];
      }
    }
    return -1;
  };
  uint32_t phase = 0;
  for (int leaf = next_leaf(); leaf >= 0; leaf = next_leaf()) {
    const int s = -1 - tree_link[3 * leaf];
    if (tid == 0) stage_rows(staged, &bar, wrows, s, sb_rows, n_tris);
    mbar_wait(smem_addr(&bar), phase);
    phase ^= 1u;
    trt::walk_superblock(r, b, w, leaf_pass, s, rank[s], g, cluster, n_tris,
                         clo, chi, staged, s * sb_rows, occlusion);
    __syncthreads();  // every thread is done with the rows before the next copy
  }
  if (i < n) {
    trt::write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out,
                   v_out, attr_out);
    trt::write_folds(b.t, r.tm, occlusion, tmax_out, occ_out, occ_or, i);
  }
  trt::add_work(counters, w);
}

}  // namespace

extern "C" int trt_tri_closest_hit_stream(
    const float* origins, const float* dirs, const float* tmax, int n,
    long long rs, const float* wrows, int n_tris, const float* tree_lo,
    const float* tree_hi, const int* tree_link, int n_nodes, int depth,
    const int* rank,
    const float* clo, const float* chi, int g, int cluster, const float* a0,
    const float* a1, const float* a2, int occlusion, float* t_out,
    int* idx_out, float* u_out, float* v_out, float* attr_out,
    long long* counters, float* tmax_out, bool* occ_out, int occ_or,
    void* stream) {
  // the tiles' 16 B copies need 16 B aligned rows
  if (depth > trt::kStack || reinterpret_cast<uintptr_t>(wrows) % 16)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kStreamRays - 1) / kStreamRays;
  tri_closest_hit_stream<<<blocks, kStreamRays, 0, (cudaStream_t)stream>>>(
      TRT_STREAM_PASS);
  return (int)cudaGetLastError();
}

extern "C" int trt_tri_closest_hit_stream_grouped(
    const float* origins, const float* dirs, const float* tmax, int n,
    long long rs, const float* wrows, int n_tris, const float* tree_lo,
    const float* tree_hi, const int* tree_link, int n_nodes, int depth,
    const int* rank,
    const float* clo, const float* chi, int g, int cluster, const float* a0,
    const float* a1, const float* a2, int occlusion, float* t_out,
    int* idx_out, float* u_out, float* v_out, float* attr_out,
    long long* counters, float* tmax_out, bool* occ_out, int occ_or,
    void* stream) {
  if (depth > trt::kStack || g * cluster > kMaxSbRows)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kGroupRays - 1) / kGroupRays;
  const size_t smem = (size_t)g * cluster * 24 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tri_closest_hit_stream_grouped,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tri_closest_hit_stream_grouped<<<blocks, kGroupRays, smem,
                                   (cudaStream_t)stream>>>(TRT_STREAM_PASS);
  return (int)cudaGetLastError();
}
