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
// u/v are the true barycentrics in every mode.
//
// The walk. The twin visits every superblock in rank order; that O(S) walk
// of 26-operation slab tests (3,340 boxes at config 8, 3,348 slab tests per
// ray against 97 Woop tests) was 95% of the old K5's operations. Both
// kernels now walk a binary tree over the superblock boxes
// (ops/tri_stream.py build_tree) as packets of block-major rays: a node is
// entered when any ray of the packet passes its slab test, each ray at its
// own bound; the near child first (the packet's majority direction sign on
// the node's split axis), the far child on a stack of kStack entries (one
// per level: the entry points refuse a tree deeper than kStack). A
// node's box is the exact min/max of its children's and the slab
// arithmetic is monotone in the bounds, so a node culls no ray that one of
// its leaves would pass at the same bound. Leaves are no longer visited in
// rank order, so the update compares the full key with rank[s]; the pass
// rule is non-strict, so a box holding a tie at t == best is still
// entered. A ray with tmax <= TMIN takes part in no test and writes a miss.
//
// What bounds them: operations, not bytes — the slab tests of the nodes and
// clusters the packet enters and ~50 operations per (ray, triangle) Woop
// test. On the card the walk is latency-bound: once the box walk is gone,
// a frame's time sits in the few warps whose rays enter many leaves. K5's
// packet is one warp (32 rays) with a warp-uniform stack, so a leaf's rows
// are read once per warp by broadcast loads and the lanes test them in
// step; with one stack per lane the warp's lanes sat in different leaves,
// each row load touched 32 lines and the warp paid every lane's leaves.
// A cluster that at most kCoopLanes of the warp's rays enter is tested by
// all 32 lanes for one ray at a time (4 rows each, then a warp minimum of
// the key), so the few rays that enter many clusters no longer walk 128
// rows in sequence each; that tail, not the average ray, set K5's time.
// K6 tests its staged rows with the same leaf walk.
// The Woop table (96 B per triangle, 164 MB at config 8) exceeds L2. Both
// kernels take an optional pointer to two int64 counters (slab tests,
// Woop tests), summed per warp and added with one atomic per warp, so a
// caller can compute the bound from the work done.
//
// K6 is the GPU analog of the TPU's cross-tile DMA reuse: one CTA of 128
// block-major rays walks the tree as a packet (`__syncthreads_or` of the
// rays' tests, one stack in shared memory). At a leaf some thread passes,
// thread 0 copies the superblock's contiguous rows (<= 512 x 96 B) into
// shared memory with one 1-D bulk asynchronous copy (cp.async.bulk
// completing on an mbarrier), and the threads that pass test them with
// K5's leaf walk. A two-buffer variant that walked on to the next leaf and
// started its copy before testing the current one was slower (the
// look-ahead walks at stale bounds and re-tests each leaf) and is gone.
// The library is built with --fmad=false, so K5 and K6 compute the twin's
// bits wherever the walks meet a box at the same bound.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kGroupRays = 128;
constexpr int kMaxSbRows = 512;
constexpr int kStack = 64;  // far children a packet holds: tree depth cap
constexpr int kCoopLanes = 12;  // at most this many rays: warp-wide rows

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
  int rank = -1;  // no hit at t == BIG ever replaces the empty best
  bool done = false;
};

struct Work {
  unsigned box = 0, prim = 0;
};

__device__ __forceinline__ float walk_bound(const Best& b, float tm,
                                            int occlusion) {
  return occlusion ? (b.t < TRT_BIG ? -1.0f : tm) : trt::jmin(b.t, tm);
}

__device__ __forceinline__ bool node_pass(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          int m, const Ray& r, const Best& b,
                                          int occlusion, Work& w) {
  ++w.box;
  return trt::slab_pass(lo + 3 * m, hi + 3 * m, r.o, r.inv,
                        walk_bound(b, r.tm, occlusion), r.tm);
}

// (t, rank, row) below the best's key: the winner's full order.
__device__ __forceinline__ bool better(const Best& b, float t, int rs, int k) {
  return t < b.t || (t == b.t && (rs < b.rank || (rs == b.rank && k < b.idx)));
}

__device__ __forceinline__ void take(Best& b, float t, float u, float v,
                                     int rs, int k) {
  b.t = t;
  b.idx = k;
  b.rank = rs;
  b.u = u;
  b.v = v;
}

// The clusters of superblock s (rank rs) in index order, for the lanes
// whose ray passed its box (`pass`); every lane of the warp calls it. Rows
// are read from `rows` (global memory for K5, the staged copy for K6; row
// k at rows + 24 * (k - row0)). Each cluster is skipped by its own box
// against the running bound (exact: it holds no hit below the bound). A
// cluster that at most kCoopLanes lanes enter is tested by the whole warp
// one ray at a time (32 rows at once, then a warp minimum of (t, row); the
// lowest hit row for any-hit), so a lone ray does not walk 128 rows in
// sequence; a cluster that more lanes enter runs each lane's ray over the
// rows in step. Either way each ray keeps the minimum of the same key over
// the same rows.
__device__ __forceinline__ void walk_superblock(
    const Ray& r, Best& b, Work& w, bool pass, int s, int rs, int g,
    int cluster, int n_tris, const float* __restrict__ clo,
    const float* __restrict__ chi, const float* rows, int row0,
    int occlusion) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < g; ++j) {
    const int c = s * g + j;
    const int base = c * cluster;
    if (base >= n_tris) break;
    const bool enter =
        pass && !b.done && node_pass(clo, chi, c, r, b, occlusion, w);
    unsigned todo = __ballot_sync(kAll, enter);
    if (todo == 0) continue;
    const int end = min(base + cluster, n_tris);
    if (__popc(todo) > kCoopLanes) {
      if (enter) {
        for (int k = base; k < end; ++k) {
          float t, u, v;
          ++w.prim;
          const bool hit = trt::woop_test(rows + (size_t)(k - row0) * 24,
                                          r.o, r.d, r.tm, &t, &u, &v);
          if (hit && better(b, t, rs, k)) {
            take(b, t, u, v, rs, k);
            if (occlusion) {
              b.done = true;
              break;
            }
          }
        }
      }
      continue;
    }
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      float o[3], d[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o[a] = __shfl_sync(kAll, r.o[a], src);
        d[a] = __shfl_sync(kAll, r.d[a], src);
      }
      const float tm = __shfl_sync(kAll, r.tm, src);
      float bt = TRT_BIG, bu = 0.0f, bv = 0.0f;
      int bk = INT_MAX;
      for (int k = base + lane; k < end; k += 32) {
        float t, u, v;
        ++w.prim;
        if (trt::woop_test(rows + (size_t)(k - row0) * 24, o, d, tm, &t, &u,
                           &v) &&
            t < bt) {
          bt = t, bu = u, bv = v, bk = k;
          if (occlusion) break;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kAll, bt, off);
        const float ou = __shfl_xor_sync(kAll, bu, off);
        const float ov = __shfl_xor_sync(kAll, bv, off);
        const int ok = __shfl_xor_sync(kAll, bk, off);
        if (occlusion ? ok < bk : (ot < bt || (ot == bt && ok < bk)))
          bt = ot, bu = ou, bv = ov, bk = ok;
      }
      if (lane == src && bk != INT_MAX && better(b, bt, rs, bk)) {
        take(b, bt, bu, bv, rs, bk);
        b.done = occlusion;
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

// One add per warp; every lane of the warp must call it.
__device__ __forceinline__ void add_work(long long* counters, const Work& w) {
  if (counters == nullptr) return;
  const unsigned box = __reduce_add_sync(0xffffffffu, w.box);
  const unsigned prim = __reduce_add_sync(0xffffffffu, w.prim);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(counters), box);
    atomicAdd(reinterpret_cast<unsigned long long*>(counters) + 1, prim);
  }
}

#define TRT_STREAM_ARGS                                                       \
  const float *__restrict__ origins, const float *__restrict__ dirs,         \
      const float *__restrict__ tmax, int n, const float *__restrict__ wrows, \
      int n_tris, const float *__restrict__ tree_lo,                          \
      const float *__restrict__ tree_hi, const int *__restrict__ tree_link,   \
      int n_nodes, const int *__restrict__ rank,                              \
      const float *__restrict__ clo, const float *__restrict__ chi, int g,    \
      int cluster, const float *__restrict__ a0, const float *__restrict__ a1, \
      const float *__restrict__ a2, int occlusion, float *__restrict__ t_out, \
      int *__restrict__ idx_out, float *__restrict__ u_out,                   \
      float *__restrict__ v_out, float *__restrict__ attr_out,               \
      long long *__restrict__ counters

#define TRT_STREAM_PASS                                                      \
  origins, dirs, tmax, n, wrows, n_tris, tree_lo, tree_hi, tree_link,        \
      n_nodes, rank, clo, chi, g, cluster, a0, a1, a2, occlusion, t_out,     \
      idx_out, u_out, v_out, attr_out, counters

__global__ void __launch_bounds__(128) tri_closest_hit_stream(TRT_STREAM_ARGS) {
  constexpr unsigned kAll = 0xffffffffu;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
  Work w;
  b.done = !(r.tm > TRT_TMIN);  // pad and dead rays take part in no test
  // The warp's 32 rays walk together: one warp-uniform stack, a node
  // entered when any lane's ray passes it, near side by the majority's
  // direction signs.
  const int walking = __popc(__ballot_sync(kAll, !b.done));
  int neg = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    neg |= (2 * __popc(__ballot_sync(kAll, !b.done && r.d[a] < 0.0f)) >
            walking)
           << a;
  int stack[kStack];
  int sp = 0;
  int m = (walking > 0 && n_nodes > 0) ? 0 : -1;
  while (m >= 0) {
    const bool pass =
        !b.done && node_pass(tree_lo, tree_hi, m, r, b, occlusion, w);
    if (__any_sync(kAll, pass)) {
      const int left = tree_link[3 * m], right = tree_link[3 * m + 1];
      if (left >= 0) {
        const bool flip = (neg >> tree_link[3 * m + 2]) & 1;
        stack[sp++] = flip ? left : right;
        m = flip ? right : left;
        continue;
      }
      const int s = -1 - left;
      walk_superblock(r, b, w, pass, s, rank[s], g, cluster, n_tris, clo,
                      chi, wrows, 0, occlusion);
    }
    m = sp > 0 ? stack[--sp] : -1;
  }
  if (live)
    write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out, v_out,
              attr_out);
  add_work(counters, w);
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
  __shared__ int stack[kStack];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kGroupRays + tid;
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
  Work w;
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
          !b.done && node_pass(tree_lo, tree_hi, m, r, b, occlusion, w);
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
    walk_superblock(r, b, w, leaf_pass, s, rank[s], g, cluster, n_tris, clo,
                    chi, staged, s * sb_rows, occlusion);
    __syncthreads();  // every thread is done with the rows before the next copy
  }
  if (live)
    write_out(b, n, i, a0, a1, a2, n_tris, t_out, idx_out, u_out, v_out,
              attr_out);
  add_work(counters, w);
}

}  // namespace

extern "C" int trt_tri_closest_hit_stream(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* wrows, int n_tris, const float* tree_lo,
    const float* tree_hi, const int* tree_link, int n_nodes, int depth,
    const int* rank,
    const float* clo, const float* chi, int g, int cluster, const float* a0,
    const float* a1, const float* a2, int occlusion, float* t_out,
    int* idx_out, float* u_out, float* v_out, float* attr_out,
    long long* counters, void* stream) {
  if (depth > kStack) return (int)cudaErrorInvalidValue;
  const int blocks = (n + 127) / 128;
  tri_closest_hit_stream<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      TRT_STREAM_PASS);
  return (int)cudaGetLastError();
}

extern "C" int trt_tri_closest_hit_stream_grouped(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* wrows, int n_tris, const float* tree_lo,
    const float* tree_hi, const int* tree_link, int n_nodes, int depth,
    const int* rank,
    const float* clo, const float* chi, int g, int cluster, const float* a0,
    const float* a1, const float* a2, int occlusion, float* t_out,
    int* idx_out, float* u_out, float* v_out, float* attr_out,
    long long* counters, void* stream) {
  if (depth > kStack || g * cluster > kMaxSbRows)
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
