// The warp-packet tree walk of the triangle kernels K1 (csrc/tri_hit.cu) and
// K5 (csrc/tri_stream.cu), the leaf walk K6 shares, and the packet pieces
// K2 (csrc/torus_hit.cu) walks its own leaves with.
//
// It replaces the flat walks of the TPU kernels ops/tri_kernel.py:77
// (_tri_kernel, K1) and ops/tri_stream.py:202 (_tri_stream_kernel, K5),
// which test every cluster or superblock box per ray in front-to-back
// rank order. Here a binary tree over the boxes (ops/kernel_common.py
// build_tree) is walked by packets of block-major rays: a node is entered
// when any ray of the packet passes its slab test, each ray at its own
// bound; the near child first (the packet's majority direction sign on the
// node's split axis), the far child on a stack of kStack entries (one per
// level: the entry points refuse a tree deeper than kStack). A node's box
// is the exact min/max of its children's and the slab arithmetic is
// monotone in the bounds, so a node culls no ray that one of its leaves
// would pass at the same bound. Leaves are no longer visited in rank
// order, so the update compares the full (t, rank, row) key with the
// leaf's rank; the pass rule is non-strict, so a box holding a tie at
// t == best is still entered. A ray with tmax <= TMIN takes part in no
// test and writes a miss.
//
// What bounds the walk: operations, not bytes — the slab tests of the
// nodes the packet enters and ~50 operations per (ray, triangle) Woop test
// (common.cuh). On the card it is latency-bound: the packet is one warp
// (32 rays) with a warp-uniform stack, so a leaf's rows are read once per
// warp by broadcast loads and the lanes test them in step. A cluster that
// at most kCoopLanes of the warp's rays enter is tested by all 32 lanes for
// one ray at a time (the rows spread over the lanes, then a warp minimum
// of the key), so the few rays that enter many clusters do not walk 128
// rows in sequence each; that tail, not the average ray, sets the time.
// Work counters (slab tests, primitive tests) are summed per warp and
// added with one atomic per warp, so a caller can bound the time by the
// work done.
#pragma once

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace trt {

constexpr int kStack = 64;      // far children a packet holds: tree depth cap
constexpr int kCoopLanes = 12;  // at most this many rays: warp-wide rows
constexpr unsigned kAllLanes = 0xffffffffu;

struct Ray {
  float o[3], d[3], inv[3], tm;
};

// Ray i of the (3, n) rows, row a at origins + a * rs (rs = n for a
// contiguous (3, n) tensor, the state's lanes for a prefix of the bounce
// loop's state); a pad lane (i >= n) gets an all-zero ray, whose tmax of 0
// keeps it out of every test.
__device__ __forceinline__ Ray load_ray(const float* origins,
                                        const float* dirs,
                                        const float* tmax, int n,
                                        long long rs, int i) {
  Ray r;
  const bool live = i < n;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = live ? origins[a * rs + i] : 0.0f;
    r.d[a] = live ? dirs[a * rs + i] : 0.0f;
    r.inv[a] = live ? inv_dir(r.d[a]) : 0.0f;
  }
  r.tm = live ? tmax[i] : 0.0f;
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

__device__ __forceinline__ float walk_bound(float best, float tm,
                                            int occlusion) {
  return occlusion ? (best < TRT_BIG ? -1.0f : tm) : jmin(best, tm);
}

__device__ __forceinline__ bool node_pass(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          int m, const Ray& r, float best,
                                          int occlusion, Work& w) {
  ++w.box;
  return slab_pass(lo + 3 * m, hi + 3 * m, r.o, r.inv,
                   walk_bound(best, r.tm, occlusion), r.tm);
}

// The packet's near side per axis: bit a is set when most of the warp's
// walking rays point toward -a.
__device__ __forceinline__ int majority_negative(const Ray& r, bool walking) {
  const int count = __popc(__ballot_sync(kAllLanes, walking));
  int neg = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    neg |= (2 * __popc(__ballot_sync(kAllLanes, walking && r.d[a] < 0.0f)) >
            count)
           << a;
  return neg;
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

// The clusters of leaf s (rank rs; clusters s*g .. s*g+g-1) in index order,
// for the lanes whose ray passed the leaf's box (`pass`); every lane of the
// warp calls it. Rows are read from `rows` (global memory for K1 and K5,
// the staged copy for K6; row k at rows + 24 * (k - row0)). With cluster
// boxes (clo != nullptr) each cluster is skipped by its own box against
// the running bound (exact: it holds no hit below the bound); without
// them (K1, g = 1) the leaf's box is the cluster's. A cluster that at most
// kCoopLanes lanes enter is tested by the whole warp one ray at a time (32
// rows at once, then a warp minimum of (t, row); the lowest hit row for
// any-hit); a cluster that more lanes enter runs each lane's ray over the
// rows in step. Either way each ray keeps the minimum of the same key over
// the same rows.
__device__ __forceinline__ void walk_superblock(
    const Ray& r, Best& b, Work& w, bool pass, int s, int rs, int g,
    int cluster, int n_tris, const float* __restrict__ clo,
    const float* __restrict__ chi, const float* rows, int row0,
    int occlusion) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < g; ++j) {
    const int c = s * g + j;
    const int base = c * cluster;
    if (base >= n_tris) break;
    const bool enter =
        pass && !b.done &&
        (clo == nullptr || node_pass(clo, chi, c, r, b.t, occlusion, w));
    unsigned todo = __ballot_sync(kAllLanes, enter);
    if (todo == 0) continue;
    const int end = min(base + cluster, n_tris);
    if (__popc(todo) > kCoopLanes) {
      if (enter) {
        for (int k = base; k < end; ++k) {
          float t, u, v;
          ++w.prim;
          const bool hit = woop_test(rows + (size_t)(k - row0) * 24, r.o,
                                     r.d, r.tm, &t, &u, &v);
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
        o[a] = __shfl_sync(kAllLanes, r.o[a], src);
        d[a] = __shfl_sync(kAllLanes, r.d[a], src);
      }
      const float tm = __shfl_sync(kAllLanes, r.tm, src);
      float bt = TRT_BIG, bu = 0.0f, bv = 0.0f;
      int bk = INT_MAX;
      for (int k = base + lane; k < end; k += 32) {
        float t, u, v;
        ++w.prim;
        if (woop_test(rows + (size_t)(k - row0) * 24, o, d, tm, &t, &u, &v) &&
            t < bt) {
          bt = t, bu = u, bv = v, bk = k;
          if (occlusion) break;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kAllLanes, bt, off);
        const float ou = __shfl_xor_sync(kAllLanes, bu, off);
        const float ov = __shfl_xor_sync(kAllLanes, bv, off);
        const int ok = __shfl_xor_sync(kAllLanes, bk, off);
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

// K1's and K5's walk: the warp's 32 rays walk the tree as one packet, a
// node entered when any lane's ray passes it, and at a leaf the lanes that
// passed walk its clusters. Without a box test (box_test == 0: K1's single
// uncullable block) every walking ray enters every node. Every lane of the
// warp calls it.
__device__ __forceinline__ void walk_warp_packet(
    const Ray& r, Best& b, Work& w, const float* __restrict__ tree_lo,
    const float* __restrict__ tree_hi, const int* __restrict__ tree_link,
    int n_nodes, int box_test, const int* __restrict__ rank,
    const float* __restrict__ clo, const float* __restrict__ chi, int g,
    int cluster, int n_tris, const float* __restrict__ wrows,
    int occlusion) {
  const int neg = majority_negative(r, !b.done);
  int stack[kStack];
  int sp = 0;
  int m = (n_nodes > 0 && __any_sync(kAllLanes, !b.done)) ? 0 : -1;
  while (m >= 0) {
    const bool pass =
        !b.done && (!box_test ||
                    node_pass(tree_lo, tree_hi, m, r, b.t, occlusion, w));
    if (__any_sync(kAllLanes, pass)) {
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
    write_tri_attrs(a0, a1, a2, n_tris, attr_out, n, i, b.t, b.idx, b.u,
                    b.v);
}

// One add per warp; every lane of the warp must call it.
__device__ __forceinline__ void add_work(long long* counters, const Work& w) {
  if (counters == nullptr) return;
  const unsigned box = __reduce_add_sync(kAllLanes, w.box);
  const unsigned prim = __reduce_add_sync(kAllLanes, w.prim);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(counters), box);
    atomicAdd(reinterpret_cast<unsigned long long*>(counters) + 1, prim);
  }
}

}  // namespace trt
