// V1: a segment's visit ranks, one launch: the anchor (the wavefront's mean
// origin) and, for up to two box sets, each box's position in the
// front-to-back visit order.
//
// Replaces what XLA fuses of the JAX package's visit orders beside its
// Pallas calls: ops/tri_kernel.py:398-409 (K1), ops/torus_kernel.py:438-450
// (K2) and ops/tri_stream.py:534-538 (K5/K6), each `mean_o`, the norm of
// the clamped box gap, and `argsort(argsort(cdist))`; no Pallas kernel.
// Plain twin: toroidal_ray_tracing_tpu_torch/ops/visit_kernel.py::
// visit_ranks_plain (kernel_common.batch_anchor, visit_order, tree_rank).
//
// Contract: anchor = (float)(sum over the lanes of the (3, lanes) origin
// rows, in float64, / n_batch); per set, cdist[s] = sqrt((gx*gx + gy*gy) +
// gz*gz) with g = max(max(lo[s] - anchor, anchor - hi[s]), 0) (NaN
// propagating, each operation rounded on its own: no FMA), and rank[s] =
// the position of box s in a stable ascending sort of cdist, NaN after
// every number (torch.argsort(stable=True)'s order), then
// rank[order[p]] = p.
//
// Design.
//  1. Every CTA sums a grid-stride share of the lanes in float64 and
//     reduces it by warp butterflies, then the warps in order, to one
//     partial.
//  2. One thread a CTA writes the partial and takes a ticket of a counter
//     (the last resets it to 0, so no host memset runs between calls). The
//     CTA that takes the last one knows every partial is written; in a
//     cluster launch it tells its peers through their shared memory, and
//     every other CTA exits.
//  3. Each ranking CTA adds the partials in the same fixed order, so all
//     hold the same anchor bits, and two launches on the same origins give
//     the same bits.
//  4. Keys are 64 bits: ordered cdist bits << 32 | box index (unique, so an
//     ascending order of them is the stable order). Sets of at most
//     kOneCtaBoxes boxes rank in the last CTA alone: it sorts the set and a
//     box's rank is its position. A larger set ranks in the last cluster of
//     kCluster = 8 CTAs (the grid is then launched in clusters): each CTA
//     sorts its share, ceil(m / 8) boxes, gathers its peers' sorted shares
//     from their shared memory (cluster.map_shared_rank), and a box's rank
//     is the number of keys below its own in all eight, eight binary
//     searches interleaved. A slab of shares above kSlabKeys keys sits in
//     a global scratch instead, read in place.
//  5. Sorts are bitonic over a power of two of keys (at least 32):
//     distances below 32 in registers by warp shuffles, only the larger
//     ones through memory with a barrier each (10 barriers for config 6's
//     256 keys in one CTA, 15 for config 8's 512-key shares).
// The cluster launch costs every CTA a cluster barrier and the last
// cluster's CTAs an exchange, so small sets stay in one CTA (config 6's
// 181 boxes: 0.0127 ms in one CTA, 0.0200 in a cluster).
//
// What bounds it on an H100 SXM (80 GB HBM3, 700 W): bytes, 12 B a lane of
// origins plus 28 B a box (24 in, 4 out): 0.0074 ms at 2,073,600 lanes,
// 0.030 ms at 8,294,400. Measured there (20 launches in a CUDA graph):
// 0.0128 ms at 2,073,600 lanes and 181 boxes (1.7x), 0.0402 at 8,294,400
// lanes and 1 box (1.35x), 0.0244 at 2,073,600 lanes and config 8's 3,340
// superblocks (3.3x). The reduction alone takes 0.0064-0.0081 ms at
// 2,073,600 lanes; config 8's tail: the ticket and anchor 0.006, the sort
// 0.004, the gather 0.003, the searches 0.003
// (experiments/v1_cluster_sweep.py).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;          // the CTAs that rank a larger set (the
                                     // portable cluster size)
constexpr int kOneCtaBoxes = 512;    // sets up to this rank in one CTA
constexpr int kSlabKeys = 8192;      // a set's slab (its shares, one after
                                     // another) in shared memory up to this;
                                     // above, in a global scratch
constexpr int kMaxCtas = kThreads;   // the anchor adds one partial a thread
constexpr int kMaxDevices = 64;
constexpr u64 kPad = ~0ull;          // sorts after every box's key

// The CTAs that rank the sets: one while both fit kOneCtaBoxes boxes.
__host__ __device__ __forceinline__ int cluster_for(int m0, int m1) {
  return (m0 > kOneCtaBoxes || m1 > kOneCtaBoxes) ? kCluster : 1;
}

// Keys each of c CTAs sorts for an m-box set: its share ceil(m / c) padded
// to a power of two of at least a warp (0 for no set).
__host__ __device__ __forceinline__ int share_keys(int m, int c) {
  if (m <= 0) return 0;
  const int share = (m + c - 1) / c;
  int p = 32;
  while (p < share) p <<= 1;
  return p;
}

// cdist's float bits as an unsigned integer in ascending order of the
// floats, NaN (any payload) above +inf, -0 equal to +0.
__device__ __forceinline__ unsigned ordered_bits(float c) {
  if (c != c) return 0xffffffffu;
  const unsigned u = __float_as_uint(__fadd_rn(c, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float gap(float lo, float hi, float a) {
  return trt::jmax(trt::jmax(__fsub_rn(lo, a), __fsub_rn(a, hi)), 0.0f);
}

// Box j's key: its distance's ordered bits above its index (unique, so an
// ascending sort of the keys is the stable order).
__device__ __forceinline__ u64 box_key(const float* __restrict__ lo,
                                       const float* __restrict__ hi, int j,
                                       const float a[3]) {
  const float gx = gap(lo[3 * j], hi[3 * j], a[0]);
  const float gy = gap(lo[3 * j + 1], hi[3 * j + 1], a[1]);
  const float gz = gap(lo[3 * j + 2], hi[3 * j + 2], a[2]);
  const float c = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz)));
  return (u64)ordered_bits(c) << 32 | (unsigned)j;
}

// s summed over the CTA in a fixed order (butterflies within each warp,
// then the warps in turn) into total[3]; every thread calls it.
__device__ __forceinline__ void cta_sum(double s[3],
                                        double (*warp_sums)[3],
                                        double* total) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[a] += __shfl_xor_sync(0xffffffffu, s[a], off);
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < 3; ++a) warp_sums[warp][a] = s[a];
  __syncthreads();
  if (tid < 3) {
    double v = warp_sums[0][tid];
    for (int w = 1; w < kWarps; ++w) v += warp_sums[w][tid];
    total[tid] = v;
  }
  __syncthreads();
}

// Bitonic compare-exchange (stage k, distance j < 32) of position i with
// its partner in the same warp.
__device__ __forceinline__ u64 warp_cx(u64 u, int i, int j, int k) {
  const u64 v = __shfl_xor_sync(0xffffffffu, u, j);
  const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
  return keep_min ? (u < v ? u : v) : (u < v ? v : u);
}

// Writes and sorts (ascending) a CTA's P keys: position i < share holds box
// first + i's key (while first + i < m), the rest kPad. Position i belongs
// to thread i % kThreads in every pass, and warps are whole (P >= 32), so
// the distances below 32 run in registers by shuffles; only the distances
// of 32 and more go through memory, with a barrier each. Ends on a barrier.
__device__ void sort_share(const float* __restrict__ lo,
                           const float* __restrict__ hi, int m, int first,
                           int share, const float a[3], u64* keys, int P) {
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int j = first + i;
    u64 u = (i < share && j < m) ? box_key(lo, hi, j, a) : kPad;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
      for (int d = k >> 1; d > 0; d >>= 1) u = warp_cx(u, i, d, k);
    keys[i] = u;
  }
  __syncthreads();
  for (int k = 64; k <= P; k <<= 1) {
    for (int d = k >> 1; d >= 32; d >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += kThreads) {
        const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
        const u64 u = keys[i], v = keys[i + d];
        if ((u > v) == ((i & k) == 0)) {
          keys[i] = v;
          keys[i + d] = u;
        }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < P; i += kThreads) {
      u64 u = keys[i];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) u = warp_cx(u, i, d, k);
      keys[i] = u;
    }
    __syncthreads();
  }
}

// The number of keys below `key` in all kCluster sorted shares of a slab
// (P keys each, P a power of two): one binary search a share, the eight
// searches interleaved level by level (eight independent loads in flight);
// kGlobal reads past L1 the scratch that other SMs wrote.
template <bool kGlobal>
__device__ __forceinline__ int keys_below(const u64* slab, int P, u64 key) {
  int pos[kCluster] = {};
  for (int s = P >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      const u64* e = slab + (size_t)c * P + pos[c] + s - 1;
      if ((kGlobal ? __ldcg(e) : *e) < key) pos[c] += s;
    }
  }
  int r = 0;
#pragma unroll
  for (int c = 0; c < kCluster; ++c) {
    const u64* e = slab + (size_t)c * P + pos[c];
    r += pos[c] + ((kGlobal ? __ldcg(e) : *e) < key ? 1 : 0);
  }
  return r;
}

// One set's ranks; every thread of the ranking CTA, or of the ranking
// cluster's kCluster CTAs (C), calls it. One CTA sorts the whole set, and a
// box's rank is its sorted position. A cluster's slab holds the C sorted
// shares one after another: in shared memory, where each CTA gathers its
// peers' shares into its own slab, or (global) in the scratch, which every
// CTA reads in place; a box's rank is the number of keys below its own in
// all C shares.
__device__ void rank_set(cg::cluster_group& cluster, int C, int me,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi, int m,
                         int* __restrict__ rank, const float a[3], u64* slab,
                         bool global) {
  const int P = share_keys(m, C);
  if (P == 0) return;
  const int share = (m + C - 1) / C;
  u64* mine = slab + (size_t)me * P;
  sort_share(lo, hi, m, me * share, share, a, mine, P);
  if (C > 1) {
    cluster.sync();                  // every share sorted
    if (!global) {
      for (int q = threadIdx.x; q < C * P; q += kThreads)
        if (q / P != me) slab[q] = cluster.map_shared_rank(slab, q / P)[q];
      cluster.sync();                // no peer reads this CTA's share again
    }
  }
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const u64 key = mine[p];
    if (key == kPad) break;          // the pads sort last
    rank[(unsigned)(key & 0xffffffffu)] =
        C == 1 ? p
               : (global ? keys_below<true>(slab, P, key)
                         : keys_below<false>(slab, P, key));
  }
}

__global__ void __launch_bounds__(kThreads) visit_rank(
    const float* __restrict__ origins, long long row_stride, int lanes,
    int n_batch, const float* __restrict__ lo0, const float* __restrict__ hi0,
    int m0, int* __restrict__ rank0, const float* __restrict__ lo1,
    const float* __restrict__ hi1, int m1, int* __restrict__ rank1,
    float* __restrict__ anchor_out, double* __restrict__ partial,
    unsigned* __restrict__ ticket, u64* __restrict__ scratch, int C) {
  extern __shared__ u64 smem_keys[];
  __shared__ double warp_sums[kWarps][3];
  __shared__ double total[3];
  __shared__ unsigned flags[kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int me = C > 1 ? (int)cluster.block_rank() : 0;   // C: its size

  // 1. this CTA's partial: a grid-stride share of the lanes, in float64
  double s[3] = {0.0, 0.0, 0.0};
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + tid;
  for (; i + 3 * stride < lanes; i += 4 * stride) {
    float v[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        v[k][a] = origins[a * row_stride + i + k * stride];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int a = 0; a < 3; ++a) s[a] += (double)v[k][a];
  }
  for (; i < lanes; i += stride)
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] += (double)origins[a * row_stride + i];
  cta_sum(s, warp_sums, total);

  // 2. a ticket a CTA (the last resets the counter, so no host memset runs
  // between calls): the CTA that takes the last one knows every partial is
  // written, and tells its cluster through each peer's shared memory
  if (tid == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) partial[3 * blockIdx.x + a] = total[a];
    __threadfence();
    const unsigned is_last =
        atomicAdd(ticket, 1u) == gridDim.x - 1 ? 1u : 0u;
    if (is_last) *ticket = 0u;
    if (C == 1)
      flags[0] = is_last;
    else
      for (int c = 0; c < C; ++c) *cluster.map_shared_rank(&flags[me], c) =
          is_last;
  }
  if (C == 1)
    __syncthreads();
  else
    cluster.sync();
  bool last = false;
  for (int c = 0; c < C; ++c) last = last || flags[c] != 0u;
  if (!last) return;

  // 3. the anchor: every CTA of the last cluster adds the partials in the
  // same order, so all hold the same bits
  __threadfence();
#pragma unroll
  for (int a = 0; a < 3; ++a)
    s[a] = tid < (int)gridDim.x ? __ldcg(partial + 3 * tid + a) : 0.0;
  cta_sum(s, warp_sums, total);
  const float a[3] = {__double2float_rn(total[0] / (double)n_batch),
                      __double2float_rn(total[1] / (double)n_batch),
                      __double2float_rn(total[2] / (double)n_batch)};
  if (me == 0 && tid < 3) anchor_out[tid] = a[tid];

  // 4. the ranks, set by set
  const size_t slab0 = (size_t)C * share_keys(m0, C);
  const bool global0 = slab0 > kSlabKeys;
  const bool global1 = (size_t)C * share_keys(m1, C) > kSlabKeys;
  rank_set(cluster, C, me, lo0, hi0, m0, rank0, a,
           global0 ? scratch : smem_keys, global0);
  rank_set(cluster, C, me, lo1, hi1, m1, rank1, a,
           global1 ? scratch + (global0 ? slab0 : 0)
                   : smem_keys + (global0 ? 0 : slab0),
           global1);
}

}  // namespace

// partial: kMaxCtas x 3 doubles; ticket: one unsigned, 0 before the first
// call (each call leaves it 0); scratch: the slab (C x share_keys(m, C)
// keys, C = cluster_for(m0, m1)) of each set whose slab exceeds kSlabKeys,
// set 0's first, else NULL.
extern "C" int trt_visit_rank(const float* origins, long long row_stride,
                              int lanes, int n_batch, const float* lo0,
                              const float* hi0, int m0, int* rank0,
                              const float* lo1, const float* hi1, int m1,
                              int* rank1, float* anchor_out, double* partial,
                              unsigned* ticket, unsigned long long* scratch,
                              void* stream) {
  if (lanes < 0 || n_batch < 1 || m0 < 0 || m1 < 0 ||
      (m0 > 0 && (!lo0 || !hi0 || !rank0)) ||
      (m1 > 0 && (!lo1 || !hi1 || !rank1)))
    return (int)cudaErrorInvalidValue;
  const int C = cluster_for(m0, m1);
  const size_t slab0 = (size_t)C * share_keys(m0, C);
  const size_t slab1 = (size_t)C * share_keys(m1, C);
  const bool global0 = slab0 > kSlabKeys, global1 = slab1 > kSlabKeys;
  if ((global0 || global1) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in, once a device (and so never inside a CUDA
  // graph's capture, which follows a first call)
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(visit_rank,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * kSlabKeys * (int)sizeof(u64));
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  // about 4 lanes a thread, whole clusters
  const long long want = ((long long)lanes + 4 * kThreads - 1) /
                         (4 * kThreads);
  int ctas = (int)(want < 1 ? 1 : (want > kMaxCtas ? kMaxCtas : want));
  ctas = (ctas + C - 1) / C * C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ((global0 ? 0 : slab0) + (global1 ? 0 : slab1)) *
                         sizeof(u64);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, visit_rank, origins, row_stride, lanes,
                           n_batch, lo0, hi0, m0, rank0, lo1, hi1, m1, rank1,
                           anchor_out, partial, ticket, scratch, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
