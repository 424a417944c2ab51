// R1: raygen of one frame, for both cameras (pinhole and toroidal), one
// thread a ray.
//
// Replaces the XLA fusion of the JAX package's raygen inside the front
// door's jit (toroidal_ray_tracing_tpu/render/renderer.py:56 `_frame_jit`,
// calling cameras/pinhole.py:107-146 and cameras/toroidal.py:79-112
// device_rays); no Pallas kernel. Plain twin: toroidal_ray_tracing_tpu_torch/
// ops/front_kernel.py::raygen_plain, the cameras' device_rays arithmetic
// (about 67 eager launches a pinhole sample, 35 a toroidal one, and two
// host-to-device copies of the camera's parameters, which here go in by
// value).
//
// Lane i's ray (raygen.cuh lane_ray): the block-major pixel, the jitter or
// the centered offset, then the camera's ray. Writes it in one of three
// layouts, each row r of origins at o + r * row_stride + i * elem_stride
// (and d likewise): (3, N) rows (row_stride N, elem 1), (N, 3) (row_stride
// 1, elem 3), or straight into the bounce loop's (15, lanes) state at the
// frame's column (row_stride lanes). In the state layout it also writes the
// loop's initial rows (color 0, attenuation 1, active) and, past the
// frame's last ray, `tail` dead lanes (origin 0, direction 1/sqrt(3),
// inactive): the loop's first fill. The first-hit rows are left alone:
// segment 0 writes them on every active lane, hit or miss (S3, and the
// torch backend's update), and only the frame's rays' are read.
//
// What bounds it on an H100 SXM (80 GB HBM3, 700 W): bytes. Per ray 24 B
// written (origin and direction) and, with a jitter, 8 B read; in the state
// layout 48 B and the active byte written. At config 5's jittered sample
// (8,294,400 rays into the state) 472.8 MB, 0.141 ms at 3.35 TB/s. A pinhole
// ray is ~45 float operations, a toroidal one four libm calls (~100
// operations): 0.8 GFLOP at 8.3M rays, 0.012 ms at 67 TFLOP/s. The design keeps
// to the bytes: nothing is read but the jitter, every store is coalesced
// across the warp (row layouts) and no intermediate array exists.
#include <cuda_runtime.h>

#include <cstring>

#include "raygen.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) raygen(
    trt::Cam cam, const float* __restrict__ jitter, int n, int tail,
    float* __restrict__ o, float* __restrict__ d, long long row_stride,
    int elem_stride, float* __restrict__ rest, long long lanes,
    bool* __restrict__ active) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n + tail) return;
  const size_t e = (size_t)i * elem_stride;
  const bool ray = i < n;
  float ro[3], rd[3];
  if (ray) {
    trt::lane_ray(cam, i, jitter, ro, rd);
  } else {
    // trace/wavefront.py's dead tail lanes
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ro[j] = 0.0f;
      rd[j] = TRT_F(0.5773502691896258);   // 1 / sqrt(3)
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[j * row_stride + e] = ro[j];
    d[j * row_stride + e] = rd[j];
  }
  if (rest != nullptr) {
    // the rows past direction: color 0-2, attenuation 3-5
#pragma unroll
    for (int r = 0; r < 6; ++r) rest[r * lanes + i] = r >= 3 ? 1.0f : 0.0f;
    active[i] = ray;
  }
}

}  // namespace

// cam: 24 host floats (raygen.cuh Cam.p) of a camera of `kind`; jitter:
// (n, 2) float32 or NULL; o / d and their strides as above; rest: the
// state's row 6 at the frame's column, lanes: the state's row stride,
// active: the active mask at the frame's column (all NULL / 0 outside the
// state layout); tail: dead lanes to fill after the n rays (state layout
// only). Launches on `stream`, allocates nothing, does not synchronize.
extern "C" int trt_raygen(const float* cam, int kind, int width, int height,
                          int block, const float* jitter, int n, int tail,
                          float* o, float* d, long long row_stride,
                          int elem_stride, float* rest, long long lanes,
                          bool* active, void* stream) {
  if (n + tail <= 0) return 0;
  if ((kind != trt::kPinhole && kind != trt::kToroidal) || width <= 0 ||
      height <= 0 || (tail > 0 && rest == nullptr))
    return (int)cudaErrorInvalidValue;
  trt::Cam c;
  c.kind = kind;
  c.width = width;
  c.height = height;
  c.block = block;
  std::memcpy(c.p, cam, sizeof(c.p));
  const int blocks = (n + tail + kThreads - 1) / kThreads;
  raygen<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      c, jitter, n, tail, o, d, row_stride, elem_stride, rest, lanes, active);
  return (int)cudaGetLastError();
}
