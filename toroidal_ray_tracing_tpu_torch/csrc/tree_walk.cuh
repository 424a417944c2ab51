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
//
// K5's rows (96 B a triangle, 164 MB at config 8) do not fit in L2, so a
// warp that reads a cluster's rows one at a time from global memory waits
// out the memory's latency about once a row. K5 therefore walks its
// leaves with walk_superblock_tiled: an entered cluster's rows reach the
// warp through a ring of two shared-memory tiles of kTileRows rows each,
// copied asynchronously (16 B cp.async pieces spread over the lanes), the
// next tile in flight while the warp tests the current one. The copies
// stay inside the cluster: the next cluster's start only once its box has
// passed at the updated bound. Both branches (the lanes each on its own
// ray, the warp on one ray at a time) then read the rows from the tile
// and make walk_superblock's tests, so every output and counter is the
// same. K6 (rows already staged in shared memory) keeps walk_superblock.
//
// K1's rows sit in L2 (2.2 MB at config 6), so its leaf cuts the rows it
// tests rather than their latency: walk_cluster_grouped tests an entered
// cluster in groups of kGroupRows rows, each behind its own box (the
// min/max of its live rows' vertices, ops/tri_kernel.py group_boxes), so a
// ray tests only the groups whose box it passes at its running bound and
// no ray tests a group of padding rows.
#pragma once

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace trt {

constexpr int kStack = 64;      // far children a packet holds: tree depth cap
constexpr int kCoopLanes = 12;  // at most this many rays: warp-wide rows
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kTileRows = 32;   // rows a tile of the tiled leaf holds
constexpr int kTileFloats = kTileRows * 24;  // 3 KB; a warp's ring is two
static_assert(kTileRows == 32,
              "the tiled leaf's cooperative branch tests row l of a tile on "
              "lane l");
constexpr int kGroupRows = 32;  // rows behind one of K1's group boxes
static_assert(kGroupRows == 32,
              "K1's cooperative branch tests row l of a group on lane l");

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
// warp calls it: K6's leaf. Rows are read from `rows` (K6's staged copy;
// row k at rows + 24 * (k - row0)). With cluster boxes (clo != nullptr)
// each cluster is skipped by its own box against the running bound
// (exact: it holds no hit below the bound); without them (g = 1; unused
// since K1 took walk_cluster_grouped) the leaf's box is the cluster's. A
// cluster that at most kCoopLanes lanes enter is tested by the whole warp
// one ray at a time (32 rows at once, then a warp minimum of (t, row); the
// lowest hit row for any-hit); a cluster that more lanes enter runs each
// lane's ray over the rows in step. Either way each ray keeps the minimum
// of the same key over the same rows.
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

// The tiled leaf's copies: 16 B pieces from global to shared memory that
// skip L1, one commit group a tile and lane, and the wait for all but the
// newest N groups of this lane.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, min(k0 + kTileRows, end)) into the tile at `dst`: the rows are
// contiguous 96 B (six 16 B pieces each), lane l copies pieces l, l + 32,
// ...; nothing past `end` is read. Every lane of the warp calls it.
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ rows,
                                          int k0, int end, int lane) {
  const int pieces = min(kTileRows, end - k0) * 6;
  const float* src = rows + (size_t)k0 * 24;
  for (int p = lane; p < pieces; p += 32) copy16(dst + 4 * p, src + 4 * p);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One row of a tile into registers, as six 16 B loads.
__device__ __forceinline__ void tile_row(const float* s, float w[24]) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float4 x = s4[q];
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
}

// A warp's two tiles (2 x kTileFloats floats of shared memory, 16 B
// aligned) and the tiles it has copied.
struct TileRing {
  float* buf;
  unsigned copied = 0;
};

// walk_superblock for K5 (cluster boxes, row0 = 0), its rows through the
// warp's ring of tiles. When some lane enters cluster c, the warp copies
// the cluster's first tile into one buffer and its second into the other,
// then waits for the first and tests it; after each tile it copies the
// tile after next into the buffer it has just tested, so one tile is in
// flight while the warp tests another. The many-lane branch runs each
// entering lane's ray over the tile's rows in order (the same row for
// every lane: broadcast reads); the cooperative branch tests, for each
// cooperating ray, row l of the tile on lane l, then takes the warp
// minimum of (t, row) (the lowest hit row for any-hit) into the ray's
// best. A lane of the cooperative branch stops testing a ray at its first
// hit, as walk_superblock's lane does over its rows l, l + 32, ..., so the
// Woop tests are the same. Once no lane has a row left to test (any-hit),
// the warp copies no further tile and leaves the cluster. Every lane of
// the warp calls it.
__device__ __forceinline__ void walk_superblock_tiled(
    const Ray& r, Best& b, Work& w, TileRing& ring, bool pass, int s, int rs,
    int g, int cluster, int n_tris, const float* __restrict__ clo,
    const float* __restrict__ chi, const float* __restrict__ rows,
    int occlusion) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < g; ++j) {
    const int c = s * g + j;
    const int base = c * cluster;
    if (base >= n_tris) break;
    const bool enter =
        pass && !b.done && node_pass(clo, chi, c, r, b.t, occlusion, w);
    const unsigned todo = __ballot_sync(kAllLanes, enter);
    if (todo == 0) continue;
    const int end = min(base + cluster, n_tris);
    const int n_tiles = (end - base + kTileRows - 1) / kTileRows;
    const bool coop = __popc(todo) <= kCoopLanes;
    unsigned stopped = 0;  // cooperative: bit src, this lane hit src's ray
    __syncwarp();          // the last cluster's tiles are read
    copy_tile(ring.buf, rows, base, end, lane);
    if (n_tiles > 1)
      copy_tile(ring.buf + kTileFloats, rows, base + kTileRows, end, lane);
    ring.copied += min(n_tiles, 2);
    for (int q = 0;; ++q) {
      if (q + 1 < n_tiles)
        copy_wait<1>();
      else
        copy_wait<0>();
      __syncwarp();  // every lane's pieces of tile q have landed
      const float* tile = ring.buf + (q & 1) * kTileFloats;
      const int k0 = base + q * kTileRows;
      const int nr = min(kTileRows, end - k0);
      bool more;  // this lane has rows left to test after tile q
      if (!coop) {
        if (enter && !b.done) {
          for (int i = 0; i < nr; ++i) {
            float wr[24], t, u, v;
            tile_row(tile + 24 * i, wr);
            ++w.prim;
            const bool hit = woop_test(wr, r.o, r.d, r.tm, &t, &u, &v);
            if (hit && better(b, t, rs, k0 + i)) {
              take(b, t, u, v, rs, k0 + i);
              if (occlusion) {
                b.done = true;
                break;
              }
            }
          }
        }
        more = enter && !b.done;
      } else {
        unsigned rays = todo;
        while (rays) {
          const int src = __ffs(rays) - 1;
          rays &= rays - 1;
          float o[3], d[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            o[a] = __shfl_sync(kAllLanes, r.o[a], src);
            d[a] = __shfl_sync(kAllLanes, r.d[a], src);
          }
          const float tm = __shfl_sync(kAllLanes, r.tm, src);
          float bt = TRT_BIG, bu = 0.0f, bv = 0.0f;
          int bk = INT_MAX;
          if (lane < nr && !((stopped >> src) & 1u)) {
            float wr[24], t, u, v;
            tile_row(tile + 24 * lane, wr);
            ++w.prim;
            if (woop_test(wr, o, d, tm, &t, &u, &v) && t < TRT_BIG) {
              bt = t, bu = u, bv = v, bk = k0 + lane;
              if (occlusion) stopped |= 1u << src;
            }
          }
          if (!__any_sync(kAllLanes, bk != INT_MAX)) continue;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(kAllLanes, bt, off);
            const float ou = __shfl_xor_sync(kAllLanes, bu, off);
            const float ov = __shfl_xor_sync(kAllLanes, bv, off);
            const int ok = __shfl_xor_sync(kAllLanes, bk, off);
            if (occlusion ? ok < bk : (ot < bt || (ot == bt && ok < bk)))
              bt = ot, bu = ou, bv = ov, bk = ok;
          }
          if (lane == src && bk != INT_MAX && !b.done &&
              better(b, bt, rs, bk)) {
            take(b, bt, bu, bv, rs, bk);
            b.done = occlusion;
          }
        }
        more = (stopped & todo) != todo;
      }
      if (q + 1 == n_tiles) break;
      if (!__any_sync(kAllLanes, more)) {
        copy_wait<0>();  // tile q + 1 lands before its buffer is reused
        break;
      }
      __syncwarp();  // every lane is done with tile q's buffer
      if (q + 2 < n_tiles) {
        copy_tile(ring.buf + (q & 1) * kTileFloats, rows,
                  base + (q + 2) * kTileRows, end, lane);
        ++ring.copied;
      }
    }
  }
}

// K1's leaf: cluster s (rank rs; rows s * cluster .. min(s * cluster +
// cluster, n_tris)) in groups of kGroupRows rows, for the lanes whose ray
// passed the cluster's box (`pass`); every lane of the warp calls it. With
// group boxes (glo != nullptr; group q of the cluster at s * cluster /
// kGroupRows + q, at most 32 a cluster) a ray tests a group's rows only
// where it passes the group's box at its running bound; without them (the
// single uncullable block) every group is entered. A cluster that more
// than kCoopLanes lanes enter: the warp steps through each group some lane
// enters, each such lane testing its ray over the group's rows in order,
// so a hit in an earlier group culls the later ones. Else each cooperating
// ray's groups (its lane's box tests, at the ray's bound on entering) go
// to the warp, lane l tests row l of each of them (stopping at its first
// hit for any-hit), and one warp minimum of (t, row) (the lowest hit row
// for any-hit) per ray is offered to its best, skipped where no lane hit.
// A group box holds every hit of its rows, so each ray keeps the minimum
// of the same key over the same rows as walk_superblock. `groups` (the
// same on every lane) counts the (warp, group) pairs whose rows the warp
// tested: a cooperating ray's groups each count once.
__device__ __forceinline__ void walk_cluster_grouped(
    const Ray& r, Best& b, Work& w, unsigned& groups, bool pass, int s,
    int rs, int cluster, int n_tris, const float* __restrict__ glo,
    const float* __restrict__ ghi, const float* __restrict__ rows,
    int occlusion) {
  const int lane = threadIdx.x & 31;
  const bool enter = pass && !b.done;
  const unsigned todo = __ballot_sync(kAllLanes, enter);
  if (todo == 0) return;
  const int base = s * cluster;
  const int end = min(base + cluster, n_tris);
  const int n_groups = (end - base + kGroupRows - 1) / kGroupRows;
  const int g0 = s * (cluster / kGroupRows);
  if (__popc(todo) > kCoopLanes) {
    for (int q = 0; q < n_groups; ++q) {
      const bool in = enter && !b.done &&
                      (glo == nullptr ||
                       node_pass(glo, ghi, g0 + q, r, b.t, occlusion, w));
      if (!__any_sync(kAllLanes, in)) continue;
      ++groups;
      if (!in) continue;
      const int k0 = base + q * kGroupRows;
      const int k1 = min(k0 + kGroupRows, end);
      for (int k = k0; k < k1; ++k) {
        float t, u, v;
        ++w.prim;
        const bool hit =
            woop_test(rows + (size_t)k * 24, r.o, r.d, r.tm, &t, &u, &v);
        if (hit && better(b, t, rs, k)) {
          take(b, t, u, v, rs, k);
          if (occlusion) {
            b.done = true;
            break;
          }
        }
      }
    }
    return;
  }
  unsigned mine = 0;  // the groups this lane's ray enters (with group boxes)
  if (enter && glo != nullptr)
    for (int q = 0; q < n_groups; ++q)
      mine |= (unsigned)node_pass(glo, ghi, g0 + q, r, b.t, occlusion, w)
              << q;
  unsigned rays = todo;
  while (rays) {
    const int src = __ffs(rays) - 1;
    rays &= rays - 1;
    float o[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = __shfl_sync(kAllLanes, r.o[a], src);
      d[a] = __shfl_sync(kAllLanes, r.d[a], src);
    }
    const float tm = __shfl_sync(kAllLanes, r.tm, src);
    const unsigned mask = __shfl_sync(kAllLanes, mine, src);
    groups += glo == nullptr ? n_groups : __popc(mask);
    float bt = TRT_BIG, bu = 0.0f, bv = 0.0f;
    int bk = INT_MAX;
    for (int q = 0; q < n_groups; ++q) {
      if (glo != nullptr && !((mask >> q) & 1u)) continue;
      const int k = base + q * kGroupRows + lane;
      if (k >= end) break;  // only the last group is short
      float t, u, v;
      ++w.prim;
      if (woop_test(rows + (size_t)k * 24, o, d, tm, &t, &u, &v) && t < bt) {
        bt = t, bu = u, bv = v, bk = k;
        if (occlusion) break;
      }
    }
    if (!__any_sync(kAllLanes, bk != INT_MAX)) continue;
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

// K1's and K5's walk: the warp's 32 rays walk the tree as one packet, a
// node entered when any lane's ray passes it, and at a leaf the lanes that
// passed walk it: K1 its one cluster of `cluster` rows with
// walk_cluster_grouped (clo / chi: its group boxes, nullptr for the single
// uncullable block; `groups` its counter), K5 (kTiled) its g clusters of
// `cluster` rows (clo / chi: their boxes) with walk_superblock_tiled
// through the warp's `ring`. Without a box test (box_test == 0: K1's
// single uncullable block) every walking ray enters every node. Every lane
// of the warp calls it.
template <bool kTiled = false>
__device__ __forceinline__ void walk_warp_packet(
    const Ray& r, Best& b, Work& w, const float* __restrict__ tree_lo,
    const float* __restrict__ tree_hi, const int* __restrict__ tree_link,
    int n_nodes, int box_test, const int* __restrict__ rank,
    const float* __restrict__ clo, const float* __restrict__ chi, int g,
    int cluster, int n_tris, const float* __restrict__ wrows,
    int occlusion, TileRing* ring = nullptr, unsigned* groups = nullptr) {
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
      if constexpr (kTiled)
        walk_superblock_tiled(r, b, w, *ring, pass, s, rank[s], g, cluster,
                              n_tris, clo, chi, wrows, occlusion);
      else
        walk_cluster_grouped(r, b, w, *groups, pass, s, rank[s], cluster,
                             n_tris, clo, chi, wrows, occlusion);
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
