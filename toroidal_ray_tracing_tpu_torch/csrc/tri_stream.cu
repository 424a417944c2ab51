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
// Contract (K1's, over superblocks of g 128-triangle clusters): per ray,
// superblocks are walked in the wrapper's front-to-back rank order; a
// superblock box is slab-tested against bound = min(best, tmax) (any-hit:
// the ray stops at its first hit); inside a passing superblock its clusters
// are walked in index order, each skipped by its own box against the running
// bound (an exact shortcut: a skipped cluster holds no hit below the bound),
// and a passing cluster runs the Woop test on its rows with a strict `<`.
// The winner is the lexicographic minimum of (t, superblock rank, row).
// The winner's 21 attr rows are written once after the walk; u/v are the
// true barycentrics in every mode.
//
// What bounds it: operations, not bytes. Every ray slab-tests every
// superblock box (O(S) per ray: 2,305 boxes at config 8's 1.18M triangles,
// 26 operations each, common.cuh), then about 50 operations per (ray,
// triangle) Woop test in the clusters that pass. The Woop table (96 B per
// triangle, 113 MB at config 8) exceeds L2, but a warp's block-major rays
// pass nearly the same superblocks, so each passing row is one broadcast
// load per warp. What the design does about the O(S) walk: nothing yet — a
// BVH over the superblock boxes with the same key is the later redesign.
//
// K6 is the GPU analog of the TPU's cross-tile DMA reuse: one CTA of 128
// block-major rays walks the superblocks together. Each thread slab-tests
// the box; `__syncthreads_or` gives the union, and if any thread passes, the
// CTA stages the superblock's rows (at most 512 x 24 f32 = 48 KB, the static
// shared-memory limit) with coalesced 16-byte loads. The threads that passed
// then test the rows from shared memory with K5's arithmetic, so K6 is
// bit-equal to K5 (the library is built with --fmad=false). Finished rays
// stay in the loop for the barriers; the CTA leaves when all are finished.
// Single-buffered: no cp.async double buffering in this first version.
#include "common.cuh"

namespace {

constexpr int kGroupRays = 128;
constexpr int kMaxSbRows = 512;

struct Ray {
  float o[3], d[3], inv[3], tm;
};

__device__ __forceinline__ Ray load_ray(const float* origins,
                                        const float* dirs,
                                        const float* tmax, int n, int i) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = origins[(size_t)a * n + i];
    r.d[a] = dirs[(size_t)a * n + i];
    r.inv[a] = trt::inv_dir(r.d[a]);
  }
  r.tm = tmax[i];
  return r;
}

struct Best {
  float t = TRT_BIG, u = 0.0f, v = 0.0f;
  int idx = 0;
  bool done = false;
};

__device__ __forceinline__ float walk_bound(const Best& b, float tm,
                                            int occlusion) {
  return occlusion ? (b.t < TRT_BIG ? -1.0f : tm) : trt::jmin(b.t, tm);
}

// The clusters of superblock s in index order, rows read from `rows`
// (global memory for K5, the staged copy for K6; row r of the superblock at
// rows + 24 * (r - row0)).
__device__ __forceinline__ void walk_superblock(
    const Ray& r, Best& b, int s, int g, int cluster, int n_tris,
    const float* __restrict__ clo, const float* __restrict__ chi,
    const float* rows, int row0, int occlusion) {
  for (int j = 0; j < g && !b.done; ++j) {
    const int c = s * g + j;
    const int base = c * cluster;
    if (base >= n_tris) break;
    if (!trt::slab_pass(clo + 3 * c, chi + 3 * c, r.o, r.inv,
                        walk_bound(b, r.tm, occlusion), r.tm))
      continue;
    const int end = min(base + cluster, n_tris);
    for (int k = base; k < end; ++k) {
      float t, u, v;
      const bool hit = trt::woop_test(rows + (size_t)(k - row0) * 24, r.o,
                                      r.d, r.tm, &t, &u, &v);
      if (hit && t < b.t) {
        b.t = t;
        b.idx = k;
        b.u = u;
        b.v = v;
        if (occlusion) {
          b.done = true;
          break;
        }
      }
    }
  }
}

__device__ __forceinline__ void write_out(
    const Best& b, int n, int i, const float* a0, const float* a1,
    const float* a2, int n_tris, float* t_out, int* idx_out, float* u_out,
    float* v_out, float* attr_out) {
  t_out[i] = b.t;
  idx_out[i] = b.idx;
  u_out[i] = b.u;
  v_out[i] = b.v;
  if (attr_out != nullptr)
    trt::write_tri_attrs(a0, a1, a2, n_tris, attr_out, n, i, b.t, b.idx, b.u,
                         b.v);
}

#define TRT_STREAM_ARGS                                                       \
  const float *__restrict__ origins, const float *__restrict__ dirs,         \
      const float *__restrict__ tmax, int n, const float *__restrict__ wrows, \
      int n_tris, const float *__restrict__ sb_lo,                            \
      const float *__restrict__ sb_hi, const int *__restrict__ order,         \
      int n_sb, const float *__restrict__ clo, const float *__restrict__ chi, \
      int g, int cluster, const float *__restrict__ a0,                       \
      const float *__restrict__ a1, const float *__restrict__ a2,             \
      int occlusion, float *__restrict__ t_out, int *__restrict__ idx_out,    \
      float *__restrict__ u_out, float *__restrict__ v_out,                   \
      float *__restrict__ attr_out

__global__ void tri_closest_hit_stream(TRT_STREAM_ARGS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origins, dirs, tmax, n, i);
  Best b;
  for (int vi = 0; vi < n_sb && !b.done; ++vi) {
    const int s = order[vi];
    if (!trt::slab_pass(sb_lo + 3 * s, sb_hi + 3 * s, r.o, r.inv,
                        walk_bound(b, r.tm, occlusion), r.tm))
      continue;
    walk_superblock(r, b, s, g, cluster, n_tris, clo, chi, wrows, 0,
                    occlusion);
  }
  write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out, v_out,
            attr_out);
}

__global__ void __launch_bounds__(kGroupRays)
    tri_closest_hit_stream_grouped(TRT_STREAM_ARGS) {
  __shared__ float4 staged[kMaxSbRows * 24 / 4];
  const int i = blockIdx.x * kGroupRays + threadIdx.x;
  const bool live = i < n;
  Ray r;
  if (live) {
    r = load_ray(origins, dirs, tmax, n, i);
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) r.o[a] = r.d[a] = r.inv[a] = 0.0f;
    r.tm = 0.0f;
  }
  Best b;
  b.done = !live;
  const int sb_rows = g * cluster;
  for (int vi = 0; vi < n_sb; ++vi) {
    if (__syncthreads_and(b.done)) break;
    const int s = order[vi];
    const bool pass =
        !b.done && trt::slab_pass(sb_lo + 3 * s, sb_hi + 3 * s, r.o, r.inv,
                                  walk_bound(b, r.tm, occlusion), r.tm);
    if (!__syncthreads_or(pass)) continue;
    const int row0 = s * sb_rows;
    const int rows = min(sb_rows, n_tris - row0);
    const float4* src =
        reinterpret_cast<const float4*>(wrows + (size_t)row0 * 24);
    for (int k = threadIdx.x; k < rows * 6; k += kGroupRays)
      staged[k] = src[k];
    __syncthreads();
    if (pass)
      walk_superblock(r, b, s, g, cluster, n_tris, clo, chi,
                      reinterpret_cast<const float*>(staged), row0, occlusion);
    __syncthreads();
  }
  if (!live) return;
  write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out, v_out,
            attr_out);
}

}  // namespace

extern "C" int trt_tri_closest_hit_stream(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* wrows, int n_tris, const float* sb_lo, const float* sb_hi,
    const int* order, int n_sb, const float* clo, const float* chi, int g,
    int cluster, const float* a0, const float* a1, const float* a2,
    int occlusion, float* t_out, int* idx_out, float* u_out, float* v_out,
    float* attr_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  tri_closest_hit_stream<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, wrows, n_tris, sb_lo, sb_hi, order, n_sb, clo,
      chi, g, cluster, a0, a1, a2, occlusion, t_out, idx_out, u_out, v_out,
      attr_out);
  return (int)cudaGetLastError();
}

extern "C" int trt_tri_closest_hit_stream_grouped(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* wrows, int n_tris, const float* sb_lo, const float* sb_hi,
    const int* order, int n_sb, const float* clo, const float* chi, int g,
    int cluster, const float* a0, const float* a1, const float* a2,
    int occlusion, float* t_out, int* idx_out, float* u_out, float* v_out,
    float* attr_out, void* stream) {
  if (g * cluster > kMaxSbRows) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kGroupRays - 1) / kGroupRays;
  tri_closest_hit_stream_grouped<<<blocks, kGroupRays, 0,
                                   (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, wrows, n_tris, sb_lo, sb_hi, order, n_sb, clo,
      chi, g, cluster, a0, a1, a2, occlusion, t_out, idx_out, u_out, v_out,
      attr_out);
  return (int)cudaGetLastError();
}
