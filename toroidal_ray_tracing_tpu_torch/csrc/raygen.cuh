// R1's per-pixel ray: the device function of raygen.cu, also called by
// frame.cu's F1 to write sample 0's ray dumps again (bit-equal by
// construction, and it reads nothing).
//
// Every operation follows the plain twins' PyTorch call order on the card
// (cameras/pinhole.py, cameras/toroidal.py device_rays; the library builds
// with --fmad=false):
//   - a float tensor over a Python float multiplies by the reciprocal
//     (PyTorch's CUDA true division by a CPU scalar): px * (1 / W);
//   - torch.deg2rad multiplies by (float)(pi / 180);
//   - torch.cos / torch.sin are cosf / sinf, sqrt is sqrtf, a tensor over a
//     tensor is the IEEE quotient;
//   - sums run left to right, as written in the twins.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace trt {

constexpr int kPinhole = 0;
constexpr int kToroidal = 1;
constexpr int kCamFloats = 24;

// A camera's host parameters, passed to the kernels by value.
//   pinhole:  p[0..11] rows 0-2 of proj_inv, p[12..23] rows 0-2 of
//             view_inv (row j: 4 floats; the eye is column 3)
//   toroidal: p[0..2] eye, p[3] omega, p[4] theta, p[5] rho (degrees and
//             world units), p[6] d_alfa = 360 / W, p[7] d_beta = 360 / H
//             (float32 quotients, as the twin takes them)
struct Cam {
  int kind;
  int width, height, block;
  float p[kCamFloats];
};

// cameras/pinhole.py pixel_coords: lane i's integer pixel (block-major when
// block > 1: b x b tiles, row-major within and across tiles).
__device__ __forceinline__ void pixel_of(const Cam& c, int i, int* px,
                                         int* py) {
  if (c.block <= 1) {
    *px = i % c.width;
    *py = i / c.width;
    return;
  }
  const int b = c.block, wb = c.width / b;
  const int blk = i / (b * b), off = i % (b * b);
  *px = (blk % wb) * b + off % b;
  *py = (blk / wb) * b + off / b;
}

// The ray through the (offset) pixel position (px, py).
__device__ __forceinline__ void ray_of(const Cam& c, float px, float py,
                                       float o[3], float d[3]) {
  const float* p = c.p;
  if (c.kind == kPinhole) {
    const float inv_w = 1.0f / (float)c.width;
    const float inv_h = 1.0f / (float)c.height;
    const float dx = px * inv_w * 2.0f - 1.0f;
    const float dy = py * inv_h * 2.0f - 1.0f;
    float tc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      tc[j] = ((p[4 * j] * dx + p[4 * j + 1] * dy) + p[4 * j + 2]) +
              p[4 * j + 3];
    const float tn = sqrtf((tc[0] * tc[0] + tc[1] * tc[1]) + tc[2] * tc[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) tc[j] = tc[j] / tn;
    const float* v = p + 12;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      d[j] = (v[4 * j] * tc[0] + v[4 * j + 1] * tc[1]) + v[4 * j + 2] * tc[2];
      o[j] = v[4 * j + 3];
    }
    return;
  }
  // toroidal: torch.deg2rad(alfa + omega), torch.deg2rad(beta + theta)
  const float deg = TRT_F(0.017453292519943295769236907684886);
  const float a = (p[6] * px + p[3]) * deg;
  const float b = (p[7] * py + p[4]) * deg;
  const float ca = cosf(a), sa = sinf(a), cb = cosf(b), sb = sinf(b);
  o[0] = p[0] + p[5] * ca;
  o[1] = p[1];
  o[2] = p[2] + p[5] * sa;
  d[0] = ca * cb;
  d[1] = sb;
  d[2] = sa * cb;
}

// Lane i's ray: its pixel, plus jitter (N, 2) when given, else the centered
// offset (0.5 on the pinhole, none on the toroidal camera).
__device__ __forceinline__ void lane_ray(const Cam& c, int i,
                                         const float* __restrict__ jitter,
                                         float o[3], float d[3]) {
  int ix, iy;
  pixel_of(c, i, &ix, &iy);
  float px = (float)ix, py = (float)iy;
  if (jitter != nullptr) {
    px = px + jitter[2 * (size_t)i];
    py = py + jitter[2 * (size_t)i + 1];
  } else if (c.kind == kPinhole) {
    px = px + 0.5f;
    py = py + 0.5f;
  }
  ray_of(c, px, py, o, d);
}

}  // namespace trt
