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
// Design. Every CTA sums a grid-stride share of the lanes in float64 and
// reduces it in a fixed tree in shared memory to one partial per CTA; the
// CTA that takes the last ticket of a counter (which it resets to 0, so no
// host memset runs between calls) adds the partials in a fixed tree, so two
// launches on the same origins give the same bits. That CTA alone then
// ranks each set: a bitonic sort of the 64-bit keys (ordered cdist bits <<
// 32 | box index; unique, so the sort's result is the stable order) in
// shared memory (in a global scratch above kSmemKeys boxes), then a
// scatter of the positions.
//
// What bounds it on an H100 SXM (80 GB HBM3, 700 W): bytes, 12 B a lane of
// origins plus 28 B a box (24 in, 4 out): 0.0074 ms at 2,073,600 lanes,
// 0.030 ms at 8,294,400. Measured there (20 launches in a CUDA graph):
// 0.0175 ms at 2,073,600 lanes and 181 boxes (2.4x), 0.0449 ms at
// 8,294,400 lanes and 1 box (1.5x). The one-CTA sort is a serial tail: 78
// bitonic steps at 3,340 boxes (config 8's superblocks; ~0.08 ms in a
// profiled frame), 36 at <= 256.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCtas = kThreads;  // the last CTA adds one partial a thread
constexpr int kSmemKeys = 8192;     // boxes a set sorts in shared memory
constexpr int kMaxDevices = 64;

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

// One set's ranks; every thread of the CTA calls it.
__device__ void rank_set(const float* __restrict__ lo,
                         const float* __restrict__ hi, int m,
                         int* __restrict__ rank, const float a[3],
                         unsigned long long* keys) {
  if (m <= 0) return;
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  for (int j = threadIdx.x; j < p2; j += blockDim.x) {
    unsigned long long key = ~0ull;  // pads sort after every box
    if (j < m) {
      const float gx = gap(lo[3 * j], hi[3 * j], a[0]);
      const float gy = gap(lo[3 * j + 1], hi[3 * j + 1], a[1]);
      const float gz = gap(lo[3 * j + 2], hi[3 * j + 2], a[2]);
      const float c = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
          __fmul_rn(gz, gz)));
      key = (unsigned long long)ordered_bits(c) << 32 | (unsigned)j;
    }
    keys[j] = key;
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int x = i ^ j;
        if (x > i) {
          const unsigned long long u = keys[i], v = keys[x];
          if ((u > v) == ((i & k) == 0)) {
            keys[i] = v;
            keys[x] = u;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int p = threadIdx.x; p < m; p += blockDim.x)
    rank[(unsigned)(keys[p] & 0xffffffffu)] = p;
  __syncthreads();  // the keys are free for the next set
}

__global__ void __launch_bounds__(kThreads) visit_rank(
    const float* __restrict__ origins, long long row_stride, int lanes,
    int n_batch, const float* __restrict__ lo0,
    const float* __restrict__ hi0, int m0, int* __restrict__ rank0,
    const float* __restrict__ lo1, const float* __restrict__ hi1, int m1,
    int* __restrict__ rank1, float* __restrict__ anchor_out,
    double* __restrict__ partial, unsigned* __restrict__ ticket,
    unsigned long long* __restrict__ scratch, int sort_in_smem) {
  extern __shared__ unsigned long long smem_keys[];
  __shared__ double red[3][kThreads];
  __shared__ float anchor[3];
  __shared__ bool last;
  const int tid = threadIdx.x;

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

  auto reduce = [&]() {
#pragma unroll
    for (int a = 0; a < 3; ++a) red[a][tid] = s[a];
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w)
#pragma unroll
        for (int a = 0; a < 3; ++a) red[a][tid] += red[a][tid + w];
      __syncthreads();
    }
  };
  reduce();
  if (tid < 3) partial[3 * blockIdx.x + tid] = red[tid][0];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last CTA: every partial is written; the counter is free again
  if (tid == 0) *ticket = 0u;
  __threadfence();
#pragma unroll
  for (int a = 0; a < 3; ++a)
    s[a] = tid < (int)gridDim.x ? __ldcg(partial + 3 * tid + a) : 0.0;
  reduce();
  if (tid < 3) {
    anchor[tid] = __double2float_rn(red[tid][0] / (double)n_batch);
    anchor_out[tid] = anchor[tid];
  }
  __syncthreads();
  const float a[3] = {anchor[0], anchor[1], anchor[2]};
  unsigned long long* keys = sort_in_smem ? smem_keys : scratch;
  rank_set(lo0, hi0, m0, rank0, a, keys);
  rank_set(lo1, hi1, m1, rank1, a, keys);
}

}  // namespace

// partial: kThreads x 3 doubles; ticket: one unsigned, 0 before the first
// call (each call leaves it 0); scratch: next_pow2(max(m0, m1)) keys, read
// only when that exceeds kSmemKeys (else NULL).
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
  int p2 = 1;
  while (p2 < m0 || p2 < m1) p2 <<= 1;
  const bool in_smem = p2 <= kSmemKeys;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
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
                               kSmemKeys * (int)sizeof(unsigned long long));
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  const long long want = ((long long)lanes + 4 * kThreads - 1) /
                         (4 * kThreads);
  const int ctas = (int)(want < 1 ? 1 : (want > kMaxCtas ? kMaxCtas : want));
  const size_t smem = in_smem ? (size_t)p2 * sizeof(unsigned long long) : 0;
  visit_rank<<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
      origins, row_stride, lanes, n_batch, lo0, hi0, m0, rank0, lo1, hi1, m1,
      rank1, anchor_out, partial, ticket, scratch, in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}
