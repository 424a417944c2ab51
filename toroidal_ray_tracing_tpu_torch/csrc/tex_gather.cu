// K4: texture quad gather, one thread per ray.
//
// Replaces the JAX package's TPU kernel ops/tex_kernel.py:57 (_tex_kernel,
// launched by quad_gather_pallas). Plain twin:
// toroidal_ray_tracing_tpu_torch/ops/tex_kernel.py::quad_gather_plain.
//
// Per ray: the quad-packed words (TextureAtlas.data4q, (T, 3) 32-bit) at
// the two trilinear texel indices f0 and f1 — one 12-byte row each, the four
// sRGB taps of a 2x2 neighbourhood packed per channel. A ray that is not
// valid, or whose index lies outside the atlas, gets zero words. Outputs
// are (3, N) rows: q[ch * N + i].
//
// What bounds it: bytes. Per ray 9 B in (two indices, one flag) and 24 B
// out, plus the atlas (12 B per texel) read once; there is no arithmetic to
// speak of. Neighbouring threads take neighbouring rays, so the index loads
// and the six row stores are coalesced; the atlas rows are scattered 12-byte
// loads, and block-major ray order keeps a warp's texels close together, so
// they mostly hit the same cache lines. The TPU kernel's span-range prepass
// and per-vreg gathers exist for the TPU and have no counterpart here.
#include "common.cuh"

namespace {

__global__ void quad_gather(const int* __restrict__ data4q, int n_texels,
                            const int* __restrict__ f0,
                            const int* __restrict__ f1,
                            const unsigned char* __restrict__ valid, int n,
                            int* __restrict__ q0, int* __restrict__ q1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool ok = valid[i] != 0;
  const int a = f0[i], b = f1[i];
  const bool ok_a = ok && a >= 0 && a < n_texels;
  const bool ok_b = ok && b >= 0 && b < n_texels;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    q0[(size_t)ch * n + i] = ok_a ? data4q[(size_t)a * 3 + ch] : 0;
    q1[(size_t)ch * n + i] = ok_b ? data4q[(size_t)b * 3 + ch] : 0;
  }
}

}  // namespace

extern "C" int trt_quad_gather(const int* data4q, int n_texels, const int* f0,
                               const int* f1, const unsigned char* valid,
                               int n, int* q0, int* q1, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  quad_gather<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      data4q, n_texels, f0, f1, valid, n, q0, q1);
  return (int)cudaGetLastError();
}
