// The jitter draw of every spp > 1 sample: jax.random.uniform(key, shape,
// float32) of JAX 0.9.0 (jax_threefry_partitionable on), bit for bit.
//
// Replaces the JAX package's draws at toroidal_ray_tracing_tpu/render/
// renderer.py:53 (render), :243 (render_sequence / render_frames) and :459
// (the banded split chain), which XLA compiles into one fused threefry
// pass; no Pallas kernel. Plain twin: toroidal_ray_tracing_tpu_torch/
// utils/prng.py:72 (uniform), about 160 eager int64 passes over the
// counter array.
//
// Element i of the row-major output hashes the 64-bit counter
// (hi, lo) = (i >> 32, (uint32)i) under the key (k1, k2) with
// threefry-2x32, 20 rounds (utils/prng.py:threefry2x32): key schedule
// (k1, k2, k1 ^ k2 ^ 0x1BD11BDA), rotations ((13, 15, 26, 6),
// (17, 29, 16, 24)), after each 4 rounds word 0 takes ks[(j + 1) % 3] and
// word 1 ks[(j + 2) % 3] + j + 1. The output word is
// ((y0 ^ y1) >> 9) | 0x3F800000, a float in [1, 2), less 1.0f (exact).
// uint32 arithmetic wraps, so nothing is masked.
//
// What bounds it on an H100 SXM (80 GB HBM3, 700 W): operations. Per
// element 75 int32 operations (2 key adds, 20 rounds of add + rotate + xor,
// 5 injections of 2 adds, the xor, shift and or of the float bits) and one
// f32 subtract; 4 bytes out, nothing in. At config 5's (8,294,400, 2):
// 66.4 MB over 3.35 TB/s is 0.020 ms; 1.24e9 int32 operations over
// 132 SMs x 128 lanes issued a clock x 1.98 GHz (33.5 Tops/s; integer
// adds also issue to the f32 lanes as IMAD, so the 64 int32 lanes alone,
// 0.074 ms, are no bound) is 0.037 ms. The design keeps to the
// operations: each thread makes its counters from the index in registers,
// hashes 4 consecutive elements and writes them with one 16-byte store
// (grid-stride loop, the ragged tail of n % 4 element by element), and
// there are no intermediate arrays.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds with rotations (r0, r1, r2, r3).
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// jax.random.uniform's float of element i.
__device__ __forceinline__ float draw(unsigned long long i, uint32_t ks0,
                                      uint32_t ks1, uint32_t ks2) {
  uint32_t x0 = (uint32_t)(i >> 32) + ks0;
  uint32_t x1 = (uint32_t)i + ks1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += ks1; x1 += ks2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += ks2; x1 += ks0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += ks0; x1 += ks1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += ks1; x1 += ks2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += ks2; x1 += ks0 + 5u;
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __uint_as_float(bits) - 1.0f;
}

__global__ void threefry_uniform(float* __restrict__ out, long long n,
                                 uint32_t ks0, uint32_t ks1) {
  const uint32_t ks2 = ks0 ^ ks1 ^ kParity;
  const long long n4 = n / 4;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long q = start; q < n4; q += stride) {
    const unsigned long long i = (unsigned long long)q * 4;
    float4 v;
    v.x = draw(i, ks0, ks1, ks2);
    v.y = draw(i + 1, ks0, ks1, ks2);
    v.z = draw(i + 2, ks0, ks1, ks2);
    v.w = draw(i + 3, ks0, ks1, ks2);
    out4[q] = v;
  }
  const long long t = n4 * 4 + start;
  if (t < n) out[t] = draw((unsigned long long)t, ks0, ks1, ks2);
}

}  // namespace

// out: n float32 (16-byte aligned; the wrapper allocates it), key words
// (k1, k2). Launches on `stream`, allocates nothing, does not synchronize.
extern "C" int trt_threefry_uniform(float* out, long long n, uint32_t k1,
                                    uint32_t k2, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int threads = 256;
  const long long quads = n / 4 > 0 ? n / 4 : 1;
  const long long want = (quads + threads - 1) / threads;
  // 132 SMs x 8 resident blocks of 256 threads fill the card once; more
  // blocks only add scheduling, the grid-stride loop covers the rest
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  threefry_uniform<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, n, k1,
                                                                 k2);
  return (int)cudaGetLastError();
}
