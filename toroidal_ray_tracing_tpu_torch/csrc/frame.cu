// G1 (span_gather) and F1 (frame_finish): the front door's work around the
// bounce loop that the JAX package runs inside its one jit.
//
// G1 replaces the XLA fusion of the compaction gather in the JAX package's
// bounce loop (toroidal_ray_tracing_tpu/trace/wavefront.py:218-231: the
// stable live-first span order `jnp.argsort(~live, stable=True)` and the
// `prow` gather of every state row), F1 the fusion of its unpermute
// (wavefront.py:250-255), the block unswizzle (render/renderer.py:62-64,
// cameras/pinhole.py:54) and the spp accumulation (renderer.py:94-100);
// no Pallas kernel. Plain twins: toroidal_ray_tracing_tpu_torch/ops/
// front_kernel.py::span_gather_plain (argsort, index_select of the prefix's
// rows, ~15 launches a shrink) and frame_finish_plain (index_select, the
// permuted copies, add and divide).
//
// G1, on a bucket shrink: the prefix's s_old spans [0, s_old) move to the
// spare state buffer in the stable live-first order, span k to
//   pos(k) = live(k) ? L(k) : count + k - L(k),  L(k) = live spans before k
// (the position of k in argsort(~live, stable=True); count = all live spans
// of the prefix, S3's count). A span that lands in the new prefix (pos <
// s_fit, the next segments' lanes) moves origin, direction, color,
// attenuation (12 rows) and its active flags; a span that lands past it is
// dead, and only its origin and color rows are read again (the visit
// orders' anchor reads every origin, F1 every color): those 6 rows move.
// The first-hit rows stay in the first buffer in original lane order (only
// segment 0 writes them, before any shrink). The spans past the old prefix
// keep their slots.
// Each span's original index travels with it (orig_out[pos] = orig_in[k])
// and its slot is recorded (slot[orig] = pos), F1's gather index. With a
// segment plan's tmax row, the new prefix's lanes get the next segment's
// tmax from their active flags (seg_tmax where active, else 0). One CTA
// owns a contiguous chunk of spans: it counts the live flags before the
// chunk from L2 (at most 64,800 bytes at config 5; a popc of 4 flags a
// word), scans its chunk 256 spans at a time in shared memory, then moves
// those spans as float4s (a span's row is 512 B).
//
// F1, once a frame and sample: thread p is row-major pixel (x, y); its lane
// i in the frame's block-major order, gl = the frame's column offset + i,
// and its slot lane slot[gl / 128] * 128 + gl % 128 (gl when nothing
// moved). Writes the color to the image, HWC or CHW (render_frames' stacked
// layout): sample 0 stores it, later samples add it, and the last sample
// multiplies by 1 / spp, as PyTorch's CUDA division of a tensor by a Python
// float does. With dumps (sample 0) it also writes the first hit (read in
// original lane order) and the pixel's ray, recomputed by R1's own device
// function (raygen.cuh), so nothing stored is read for it.
// Row-major with the dumps is a kernel of its own, frame_finish<true>:
// storing each output's value a pixel at a 12-B stride made every warp
// store touch three times the sectors it filled, 12 such stores a pixel
// (0.091 ms at config 6's 1080p frame, 2.05x the bound; 0.060 with the
// dump stores alone made contiguous, 0.086 with no ray recomputed). A CTA's
// 256 pixels now meet in 12 KB of shared memory and leave as 192 float4s
// an output. Channel-major stores are contiguous, and the image alone
// stores as fast unstaged (staged it took 0.025 against 0.023 ms at 1080p,
// 0.114 against 0.102 with its add at 4K): both keep frame_finish.
//
// What bounds them on an H100 SXM (80 GB HBM3, 700 W): bytes. G1 moves 12
// rows and the active byte of a lane that lands in the new prefix (98 B a
// lane: read and written once) and 6 rows of every other lane (48 B); at
// config 5's first shrink (8,294,400 lanes into a 1,036,800-lane prefix)
// 450.6 MB, 0.134 ms. F1 reads 12 B a pixel of
// color (24 B when it adds) and writes 12 B; with dumps it also reads the
// 12 B first hit and writes 36 B: at config 6's 1080p frame with dumps
// 149.3 MB, 0.045 ms; config 5's sample 2 without dumps 298.6 MB, 0.089 ms.
// Measured there (20 launches in a CUDA graph): row-major with dumps
// 0.056 ms at config 6 (1.25x), 0.213 at config 5's sample 0 (1.20x);
// channel-major 0.058 (1.30x); config 5's sample 2 0.102 (1.14x).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "raygen.cuh"

namespace {

constexpr int kSpan = 128;         // wavefront.COMPACT_SPAN
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowQuads = kSpan / 4;          // float4s in a span's row
constexpr int kMoved = 12;                    // origin, direction, color,
                                              // attenuation
constexpr int kSpanQuads = kMoved * kRowQuads;

// The sum of v over the block (every thread gets it).
__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  return total;
}

// Exclusive scan of f over the block; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int f, int* scratch, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = f;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += up;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? scratch[w] : 0;
    sum += scratch[w];
  }
  *total = sum;
  return before + incl - f;
}

__global__ void __launch_bounds__(kThreads) span_gather(
    const float* __restrict__ cur, float* __restrict__ spare,
    const bool* __restrict__ act_in, bool* __restrict__ act_out,
    const bool* __restrict__ live, const int* __restrict__ count,
    const int* __restrict__ orig_in, int* __restrict__ orig_out,
    int* __restrict__ slot, int s_old, int s_fit, int s_total,
    long long lanes, int per, float* __restrict__ tmax_out, float seg_tmax) {
  __shared__ int scratch[kWarps];
  __shared__ int pos[kThreads];
  const int c0 = blockIdx.x * per;
  const int c1 = min(c0 + per, s_total);
  if (c0 >= c1) return;
  const int n_live = *count;

  // live spans of the prefix before this chunk: 4 flags (0/1 bytes) a word
  const int lim = min(c0, s_old);
  int before = 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(live);
  for (int w = threadIdx.x; w < lim / 4; w += kThreads)
    before += __popc(words[w]);
  for (int k = (lim / 4) * 4 + threadIdx.x; k < lim; k += kThreads)
    before += live[k];
  before = block_sum(before, scratch);

  for (int t0 = c0; t0 < c1; t0 += kThreads) {
    const int k = t0 + threadIdx.x;
    const int f = (k < c1 && k < s_old) ? (int)live[k] : 0;
    int tile;
    const int excl = block_scan(f, scratch, &tile);
    if (k < c1) {
      const int rank = before + excl;         // live spans before k
      const int p = k >= s_old ? k : (f ? rank : n_live + (k - rank));
      pos[threadIdx.x] = p;
      const int o = orig_in != nullptr ? orig_in[k] : k;
      orig_out[p] = o;
      slot[o] = p;
    }
    before += tile;
    __syncthreads();
    const int nt = min(kThreads, c1 - t0);
    // the tile's spans: 12 rows of 32 float4s each, a warp a row (past
    // the new prefix: origin and color only)
#pragma unroll 4
    for (int w = threadIdx.x; w < nt * kSpanQuads; w += kThreads) {
      const int sp = w / kSpanQuads, rem = w % kSpanQuads;
      const int row = rem / kRowQuads, q = rem % kRowQuads;
      const int src = t0 + sp;
      if (pos[sp] >= s_fit && ((row >= 3 && row < 6) || row >= 9)) continue;
      const float4 v = reinterpret_cast<const float4*>(
          cur + row * lanes + (size_t)src * kSpan)[q];
      reinterpret_cast<float4*>(
          spare + row * lanes + (size_t)pos[sp] * kSpan)[q] = v;
    }
    // the new prefix's active flags: 8 uint4s a span
    for (int w = threadIdx.x; w < nt * (kSpan / 16); w += kThreads) {
      const int sp = w / (kSpan / 16), q = w % (kSpan / 16);
      const int src = t0 + sp;
      if (pos[sp] >= s_fit) continue;
      reinterpret_cast<uint4*>(act_out + (size_t)pos[sp] * kSpan)[q] =
          reinterpret_cast<const uint4*>(act_in + (size_t)src * kSpan)[q];
    }
    // the next segment's tmax row on the new prefix, from the same flags
    // (seg_tmax where active, else 0): 32 float4s a span
    if (tmax_out != nullptr) {
      for (int w = threadIdx.x; w < nt * kRowQuads; w += kThreads) {
        const int sp = w / kRowQuads, q = w % kRowQuads;
        if (pos[sp] >= s_fit) continue;
        const uchar4 a = reinterpret_cast<const uchar4*>(
            act_in + (size_t)(t0 + sp) * kSpan)[q];
        reinterpret_cast<float4*>(tmax_out + (size_t)pos[sp] * kSpan)[q] =
            make_float4(a.x ? seg_tmax : 0.0f, a.y ? seg_tmax : 0.0f,
                        a.z ? seg_tmax : 0.0f, a.w ? seg_tmax : 0.0f);
      }
    }
    __syncthreads();
  }
}

// F1's HWC outputs with the dumps meet in shared memory: a CTA's 256
// row-major pixels are one contiguous run of 768 floats in each of the four
// outputs.
constexpr int kOuts = 4;                 // image, hit position, origin,
                                         // direction
constexpr int kRun = kThreads * 3;       // floats of one output a CTA owns
constexpr int kRunQuads = kRun / 4;

// F1. kStaged = false, channel-major or the image alone: thread p is
// row-major pixel p, its stores contiguous (CHW) or three scalars a pixel
// (for the image alone this measured faster than staging). kStaged = true,
// row-major with the dumps (sample 0, so nothing to add): each thread
// writes its pixel's 12 values into shared memory; after one barrier the
// CTA stores each output's run as 192 float4s (as scalars in a short last
// CTA, or when an output is not 16-B aligned: vec = 0).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) frame_finish(
    trt::Cam cam, const float* __restrict__ hv, const int* __restrict__ slot,
    long long lanes, long long off, const float* __restrict__ hp,
    float* __restrict__ img, int add, int last, float inv_spp,
    float* __restrict__ hp_out, float* __restrict__ o_out,
    float* __restrict__ d_out, int chw, int vec) {
  const int W = cam.width, H = cam.height, n = W * H;
  if constexpr (!kStaged) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= n) return;
    const int x = p % W, y = p / W;
    int i = p;
    if (cam.block > 1) {
      const int b = cam.block;
      i = ((y / b) * (W / b) + x / b) * (b * b) + (y % b) * b + x % b;
    }
    const long long gl = off + i;
    const long long sl = slot != nullptr
                             ? (long long)slot[gl / kSpan] * kSpan + gl % kSpan
                             : gl;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t at = chw ? (size_t)c * n + p : (size_t)p * 3 + c;
      float v = hv[c * lanes + sl];
      if (add) v = img[at] + v;
      if (last) v = v * inv_spp;
      img[at] = v;
    }
    if (hp_out == nullptr) return;
    float o[3], d[3];
    trt::lane_ray(cam, i, nullptr, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t at = chw ? (size_t)c * n + p : (size_t)p * 3 + c;
      hp_out[at] = hp[c * lanes + gl];
      o_out[at] = o[c];
      d_out[at] = d[c];
    }
  } else {
    __shared__ float4 stage4[kOuts * kRunQuads];   // 12 KB
    float* stage = reinterpret_cast<float*>(stage4);
    const int t = threadIdx.x;
    const int p0 = blockIdx.x * kThreads;
    const int p = p0 + t;
    if (p < n) {
      const int x = p % W, y = p / W;
      int i = p;
      if (cam.block > 1) {
        const int b = cam.block;
        i = ((y / b) * (W / b) + x / b) * (b * b) + (y % b) * b + x % b;
      }
      const long long gl = off + i;
      const long long sl =
          slot != nullptr ? (long long)slot[gl / kSpan] * kSpan + gl % kSpan
                          : gl;
      // the loads first, then the ray, whose arithmetic overlaps them
      float v[3], h[3], o[3], d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = hv[c * lanes + sl];
        h[c] = hp[c * lanes + gl];
      }
      trt::lane_ray(cam, i, nullptr, o, d);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        stage[3 * t + c] = last ? v[c] * inv_spp : v[c];
        stage[kRun + 3 * t + c] = h[c];
        stage[2 * kRun + 3 * t + c] = o[c];
        stage[3 * kRun + 3 * t + c] = d[c];
      }
    }
    __syncthreads();
    const int run = min(kThreads, n - p0);       // the CTA's pixels
    const size_t base = (size_t)p0 * 3;          // the run's first float
    if (vec && run == kThreads) {
      for (int q = t; q < kOuts * kRunQuads; q += kThreads) {
        const int k = q / kRunQuads, r = q - k * kRunQuads;
        float* dst = k == 0 ? img : k == 1 ? hp_out : k == 2 ? o_out : d_out;
        reinterpret_cast<float4*>(dst + base)[r] = stage4[q];
      }
    } else {
      for (int k = 0; k < kOuts; ++k) {
        float* dst = k == 0 ? img : k == 1 ? hp_out : k == 2 ? o_out : d_out;
        for (int q = t; q < 3 * run; q += kThreads)
          dst[base + q] = stage[k * kRun + q];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// cur / spare: (15, lanes) float32 state buffers, act_in / act_out their
// (lanes,) active masks, live: >= s_old span flags (S3's), count: S3's
// int32 live-span count of the prefix, orig_in: (s_total,) each slot's
// original span or NULL (nothing moved yet), orig_out: (s_total,) written,
// slot: (s_total,) written (original span -> slot); s_old: the prefix's
// spans, s_fit: the new prefix's (>= count; spare's rows 3-5 and 9-11 and
// act_out are written only there), s_total = lanes / 128. Launches on
// `stream`, allocates nothing, does not synchronize.
extern "C" int trt_span_gather(const float* cur, float* spare,
                               const bool* act_in, bool* act_out,
                               const bool* live, const int* count,
                               const int* orig_in, int* orig_out, int* slot,
                               int s_old, int s_fit, int s_total,
                               long long lanes, float* tmax_out,
                               float seg_tmax, void* stream) {
  if (s_total <= 0) return 0;
  if (lanes != (long long)s_total * kSpan || s_old > s_total || s_old < 0 ||
      s_fit > s_old || s_fit < 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(cur) || !aligned16(spare) || !aligned16(act_in) ||
      !aligned16(act_out) || !aligned16(live) ||
      (tmax_out != nullptr && !aligned16(tmax_out)))
    return (int)cudaErrorMisalignedAddress;
  // 4 CTAs an SM fill the card; each walks a chunk of spans
  const int grid = s_total < 132 * 4 ? s_total : 132 * 4;
  const int per = (s_total + grid - 1) / grid;
  span_gather<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      cur, spare, act_in, act_out, live, count, orig_in, orig_out, slot,
      s_old, s_fit, s_total, lanes, per, tmax_out, seg_tmax);
  return (int)cudaGetLastError();
}

// cam / kind / width / height / block: the frame's camera (trt_raygen's);
// hv: the current state's row 6 (color), hp: the first state's row 12
// (first hit), both of row stride `lanes`; slot: (lanes / 128,) original
// span -> slot, or NULL; off: the frame's first lane; img: the image
// (H, W, 3), or (3, H, W) with chw; sample s of spp; hp_out / o_out /
// d_out: the dumps in img's layout (sample 0 only), or all NULL. Launches
// on `stream`, allocates nothing, does not synchronize.
extern "C" int trt_frame_finish(const float* cam, int kind, int width,
                                int height, int block, const float* hv,
                                const int* slot, long long lanes,
                                long long off, const float* hp, float* img,
                                int s, int spp, float* hp_out, float* o_out,
                                float* d_out, int chw, void* stream) {
  const long long n = (long long)width * height;
  if (n <= 0) return 0;
  if ((kind != trt::kPinhole && kind != trt::kToroidal) || spp < 1 ||
      s < 0 || s >= spp || off + n > lanes ||
      (hp_out != nullptr && (s != 0 || hp == nullptr || o_out == nullptr ||
                             d_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  trt::Cam c;
  c.kind = kind;
  c.width = width;
  c.height = height;
  c.block = block;
  std::memcpy(c.p, cam, sizeof(c.p));
  // PyTorch's CUDA division by a Python float: a multiply by 1 / spp
  const float inv_spp = 1.0f / (float)spp;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  // row-major with the dumps: staged; a run starts at a multiple of 3,072
  // B, so float4 stores where all four outputs are 16-B aligned
  const bool staged = !chw && hp_out != nullptr;
  const bool vec = staged && aligned16(img) && aligned16(hp_out) &&
                   aligned16(o_out) && aligned16(d_out);
  if (staged)
    frame_finish<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        c, hv, slot, lanes, off, hp, img, 0, s == spp - 1, inv_spp, hp_out,
        o_out, d_out, 0, vec ? 1 : 0);
  else
    frame_finish<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        c, hv, slot, lanes, off, hp, img, s > 0, s == spp - 1, inv_spp,
        hp_out, o_out, d_out, chw, 0);
  return (int)cudaGetLastError();
}
