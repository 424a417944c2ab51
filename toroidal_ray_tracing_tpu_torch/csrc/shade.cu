// S2 (shade_hit) and S3 (shade_finish): a bounce segment's shading and the
// bounce loop's state update, one thread per ray.
//
// Replaces what XLA fuses of the JAX package's jitted bounce-loop body:
// the ShadeAttrs assembly (ops/trace_kernel.py:439-461), shading
// (trace/shade.py:226-414) and the loop's update (trace/wavefront.py:
// 167-195); no Pallas kernel. Plain twins: toroidal_ray_tracing_tpu_torch/
// ops/shade_kernel.py::shade_hit_plain and shade_finish_plain, which are
// trace/shade.py's shade() arithmetic and the loop update split where these
// two kernels split (S2 before the shadow query, S3 after it).
//
// Every expression restates the twin's tensor ops one by one, in their
// order (the library is built with --fmad=false). Where PyTorch's CUDA op
// rounds otherwise than the expression reads, the kernel follows the op:
// a tensor divided by a Python scalar multiplies by the scalar's float
// reciprocal ((2 + k) / 2pi), and a Python scalar divided by a tensor is
// the tensor's reciprocal times the scalar (intensity / d^2). powf, log2f
// and the norms' sqrtf are CUDA's; they may part from the twin's op in the
// last bit on some lanes.
//
// S2 takes the closest-hit query's parts unmerged (the hoist's base hit,
// the triangle kernel's and the torus kernel's) and merges them in
// registers with ops/trace_kernel.py merge_parts' strict comparisons. It
// writes each output only where a reader reads it (the masks over its
// flag bits in shade_kernel.py's docstring): a miss or a dead lane gets its
// flag and shadow_tmax = 0, and reads nothing but the parts' t and the
// base's kind; S3 reads nothing else of such a lane. S2 reads the ray's
// rows at a row stride (rs: a prefix of the bounce loop's state, where
// the rows lie).
//
// S3 can also write the next segment's tmax row (a segment plan's,
// ops/segment_plan.py): seg_tmax where the ray goes on, 0 where it ends,
// on the lanes it updates; a lane dead before keeps its 0.
//
// What bounds them on an H100 SXM (80 GB HBM3, 700 W): bytes. S2 reads the
// parts' t (4-8 B a part), and for a hit the ray (24 B) and the rows its
// outputs need of its winner (a torus up to 44 B, a triangle up to 72 B,
// a loose row its u, v and prim and the loose tail's tables, L columns in
// L2), and writes a hit's first-hit point, colors and light (40 B), the
// shadow direction where lit, the normal, position and shininess where
// Phong or a reflection needs them, and the texel rows and K4's indices
// where textured; S3 reads the state, the block, the shadow ray and mask
// (and K4's words) and writes the state back, ~0.25 KB a ray. Each is one
// pass with no intermediate array; the operations (two to three norms, a
// powf, a log2f, a few dozen products) are far under the byte time.
#include "common.cuh"

namespace {

constexpr int kSpan = 128;     // S3's block: one compaction span
constexpr int kThreads = 256;  // S2's block
// rows of the (19, n) block S2 writes and S3 reads (shade_kernel.py)
constexpr int kNrm = 0, kPos = 3, kDiff = 6, kSpec = 9, kShin = 12,
              kLint = 13, kFx0 = 14, kFy0 = 15, kFx1 = 16, kFy1 = 17,
              kFlod = 18;
// bits of S2's flag byte
constexpr unsigned kMissed = 1, kNeedShadow = 2, kFacing = 4, kSpecOn = 8,
                   kReflect = 16, kTextured = 32;

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}

// torch.remainder(a, 1.0) on floats: fmod, moved into [0, 1)
__device__ __forceinline__ float rem1(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// torch.remainder on int32: the sign of the divisor
__device__ __forceinline__ int pymod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// trace/shade.py _quad_index: the flat data4q row of the top-left tap and
// the bilinear fractions, repeat addressing, at mip level lv
__device__ __forceinline__ int quad_index(const int* __restrict__ offsets,
                                          const int* __restrict__ sizes,
                                          int n_lv, int tid, int lv, float u,
                                          float v, float* fx, float* fy) {
  const int k = tid * n_lv + lv;
  const int hs = sizes[2 * k], ws = sizes[2 * k + 1];
  const float x = rem1(u) * (float)ws - 0.5f;
  const float y = rem1(v) * (float)hs - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  *fx = x - x0;
  *fy = y - y0;
  const int xi = pymod((int)x0, ws), yi = pymod((int)y0, hs);
  return (offsets[k] + yi * ws) + xi;
}

// trace/shade.py _blend_quad on one channel word: taps decoded by the sRGB
// table, then the bilinear blend
__device__ __forceinline__ float blend(int w, float fx, float fy,
                                       const float* __restrict__ srgb) {
  const float t00 = srgb[w & 0xFF], t10 = srgb[(w >> 8) & 0xFF];
  const float t01 = srgb[(w >> 16) & 0xFF], t11 = srgb[(w >> 24) & 0xFF];
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return (((t00 * gx) * gy + (t10 * fx) * gy) + (t01 * gx) * fy) +
         (t11 * fx) * fy;
}

__global__ void __launch_bounds__(kThreads) shade_hit(
    const float* __restrict__ origins, const float* __restrict__ dirs, int n,
    long long rs, const float* __restrict__ b_t,
    const int* __restrict__ b_kind,
    const int* __restrict__ b_prim, const float* __restrict__ b_u,
    const float* __restrict__ b_v, const float* __restrict__ k_t,
    const int* __restrict__ k_idx, const float* __restrict__ k_u,
    const float* __restrict__ k_v, int tri_off,
    const float* __restrict__ q_t, const float* __restrict__ tri,
    const float* __restrict__ tor, const float* __restrict__ la0,
    const float* __restrict__ la1, const float* __restrict__ la2,
    int n_cols, int loose_base, int n_loose, const float* __restrict__ consts,
    int light_point, float intensity, float pixel_spread,
    const int* __restrict__ tex_off, const int* __restrict__ tex_sizes,
    const int* __restrict__ tex_levels, int n_lv,
    float* __restrict__ shadow_o, float* __restrict__ shadow_d,
    float* __restrict__ shadow_tmax, float* __restrict__ block,
    unsigned char* __restrict__ flags, int* __restrict__ tex_i0,
    int* __restrict__ tex_i1, bool* __restrict__ tex_valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = n;

  // the merges (ops/trace_kernel.py merge_parts): the base, then the
  // triangle kernel's hit where its t is strictly below, then the torus
  // kernel's; each part's t is read on every lane, the rest on a winner
  float t = TRT_BIG;
  int kind = -1;
  bool from_k1 = false;
  if (b_t != nullptr) {
    t = b_t[i];
    kind = b_kind[i];
  }
  if (k_t != nullptr) {
    const float x = k_t[i];
    if (x < t) {
      t = x;
      kind = 0;
      from_k1 = true;
    }
  }
  if (q_t != nullptr) {
    const float x = q_t[i];
    if (x < t) {
      t = x;
      kind = 1;
    }
  }
  if (kind < 0) {  // a miss (or a dead lane): its flag and no shadow ray
    shadow_tmax[i] = 0.0f;
    flags[i] = (unsigned char)kMissed;
    if (tex_valid != nullptr) tex_valid[i] = false;
    return;
  }
  const bool is_tor = kind == 1;
  const float tc = trt::jmin(t, TRT_F(1.0e8));
  float hp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    hp[a] = origins[a * rs + i] + tc * dirs[a * rs + i];

  // the winner's rows (shade_kernel.shade_attrs): a triangle's from the
  // loose tail's tables where it is a loose row (at its u, v), else from
  // the triangle kernels' block; a torus's from the torus kernels'
  int col = -1;
  float u = 0.0f, v = 0.0f;
  if (!is_tor && la0 != nullptr) {
    const int c = from_k1 ? k_idx[i] + tri_off : b_prim[i];
    if (c >= loose_base && c < loose_base + n_loose) {
      col = c;
      u = from_k1 ? k_u[i] : b_u[i];
      v = from_k1 ? k_v[i] : b_v[i];
    }
  }
  auto tri_row = [&](int r) -> float {
    if (col >= 0) {
      const size_t k = (size_t)r * n_cols + col;
      return r < 8 ? (la0[k] + u * la1[k]) + v * la2[k] : la0[k];
    }
    return tri != nullptr ? tri[r * N + i] : 0.0f;
  };
  auto tor_row = [&](int r) -> float {
    return tor != nullptr ? tor[r * N + i] : 0.0f;
  };
  // material value k of 12 (ambient 0-2, diffuse 3-5, specular 6-8,
  // shininess 9, illum 10, texture id 11)
  auto mat = [&](int k) -> float {
    return is_tor ? tor_row(3 + k) : tri_row(8 + k);
  };
  const int illum = __float2int_rn(mat(10));
  const int tex_id = is_tor ? -1 : __float2int_rn(mat(11));
  const bool reflect = illum == 3;
  float nraw[3], wp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    nraw[a] = is_tor ? tor_row(a) : tri_row(3 + a);
    // a triangle's barycentric position: the point light's origin and
    // the reflection's (a torus's is the hit point)
    wp[a] = is_tor || !(light_point || reflect) ? hp[a] : tri_row(a);
  }
  const float nn = trt::jmax(norm3(nraw[0], nraw[1], nraw[2]),
                             TRT_F(1e-30));
  float nrm[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) nrm[a] = nraw[a] / nn;

  // the light (rchit:57-71)
  float L[3], ldist, lint;
  if (light_point) {
    float ld[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) ld[a] = consts[a] - wp[a];
    const float dist = norm3(ld[0], ld[1], ld[2]);
    const float dc = trt::jmax(dist, TRT_F(1e-20));
#pragma unroll
    for (int a = 0; a < 3; ++a) L[a] = ld[a] / dc;
    ldist = dist;
    lint = (1.0f / trt::jmax(dist * dist, TRT_F(1e-20))) * intensity;
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) L[a] = consts[3 + a];
    ldist = TRT_F(100000.0);
    lint = intensity;
  }

  // computeDiffuse (wavefront.glsl:23-31)
  const float ndotl = (nrm[0] * L[0] + nrm[1] * L[1]) + nrm[2] * L[2];
  const float lam = trt::jmax(ndotl, 0.0f);
  const bool facing = ndotl > 0.0f;    // a hit: the shadow ray's condition
  const bool spec_on = illum >= 2 && facing;
  const bool textured = tex_id >= 0;

  // the mip LOD and K4's quad indices (rchit:79-84), where textured
  if (tex_off != nullptr) {
    tex_valid[i] = textured;
    if (textured) {
      const int tid = tex_id;
      const float dim0 = (float)max(tex_sizes[2 * tid * n_lv],
                                    tex_sizes[2 * tid * n_lv + 1]);
      const float lod = log2f(trt::jmax(
          ((tc * pixel_spread) * tri_row(20)) * dim0, TRT_F(1e-20)));
      const int nl = tex_levels[tid];
      const float lvl = trt::jmin(trt::jmax(lod, 0.0f), (float)(nl - 1));
      const int l0 = (int)floorf(lvl);
      const int l1 = min(l0 + 1, nl - 1);
      const float uv0 = tri_row(6), uv1 = tri_row(7);
      float fx0, fy0, fx1, fy1;
      tex_i0[i] = quad_index(tex_off, tex_sizes, n_lv, tid, l0, uv0, uv1,
                             &fx0, &fy0);
      tex_i1[i] = quad_index(tex_off, tex_sizes, n_lv, tid, l1, uv0, uv1,
                             &fx1, &fy1);
      block[kFx0 * N + i] = fx0;
      block[kFy0 * N + i] = fy0;
      block[kFx1 * N + i] = fx1;
      block[kFy1 * N + i] = fy1;
      block[kFlod * N + i] = lvl - (float)l0;
    }
  }

  // the shadow ray (rchit:89-120): only where dot(N, L) > 0
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float diff = mat(3 + a) * lam;
    if (illum >= 1) diff = diff + mat(a);
    shadow_o[a * N + i] = hp[a];
    block[(kDiff + a) * N + i] = diff;
    block[(kSpec + a) * N + i] = mat(6 + a);
    if (facing) shadow_d[a * N + i] = L[a];
    if (spec_on || reflect) block[(kNrm + a) * N + i] = nrm[a];
    if (reflect) block[(kPos + a) * N + i] = wp[a];
  }
  shadow_tmax[i] = facing ? ldist : 0.0f;
  if (spec_on) block[kShin * N + i] = mat(9);
  block[kLint * N + i] = lint;
  flags[i] = (unsigned char)((facing ? kNeedShadow | kFacing : 0u) |
                             (illum >= 2 ? kSpecOn : 0u) |
                             (reflect ? kReflect : 0u) |
                             (textured ? kTextured : 0u));
}

__global__ void __launch_bounds__(kSpan) shade_finish(
    float* __restrict__ state, int lanes, bool* __restrict__ active, int nb,
    const float* __restrict__ block, const unsigned char* __restrict__ flags,
    const float* __restrict__ shadow_o, const float* __restrict__ shadow_d,
    const bool* __restrict__ occluded, const int* __restrict__ q0,
    const int* __restrict__ q1, const float* __restrict__ srgb,
    const float* __restrict__ consts, int first, int more,
    unsigned long long* __restrict__ rays, bool* __restrict__ spans,
    int* __restrict__ count, float* __restrict__ tmax_next, float seg_tmax) {
  const int i = blockIdx.x * kSpan + threadIdx.x;
  const bool act = i < nb && active[i];
  bool next = false, shadow_ray = false;
  if (act) {  // dead lanes keep their state
    const size_t N = nb, S = lanes;
    const unsigned fl = flags[i];
    shadow_ray = fl & kNeedShadow;
    if (fl & kMissed) {  // the miss color; S2 defined nothing else here
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float at = state[(9 + c) * S + i] * 1.0f;
        state[(9 + c) * S + i] = at;
        state[(6 + c) * S + i] = state[(6 + c) * S + i] + consts[6 + c] * at;
        if (first) state[(12 + c) * S + i] = 0.0f;
      }
    } else {
      // each block row is read only where S2 defined it (shade_kernel.py)
      auto row = [&](int r) { return block[r * N + i]; };
      const bool facing = fl & kFacing, reflective = fl & kReflect;
      next = reflective && more;
      float diff[3], specc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        diff[a] = row(kDiff + a);
        specc[a] = row(kSpec + a);
      }
      if (q0 != nullptr && (fl & kTextured)) {  // the texel (rchit:83)
        const float fx0 = row(kFx0), fy0 = row(kFy0), fx1 = row(kFx1),
                    fy1 = row(kFy1), f = row(kFlod);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float c0 = blend(q0[c * N + i], fx0, fy0, srgb);
          const float c1 = blend(q1[c * N + i], fx1, fy1, srgb);
          const float texel = c0 * (1.0f - f) + c1 * f;
          diff[c] = diff[c] * texel;
        }
      }
      // computeSpecular (wavefront.glsl:34-50)
      const bool shadowed = shadow_ray && occluded[i];
      const float att_local = shadowed ? TRT_F(0.3) : 1.0f;
      const bool lit = (fl & kSpecOn) && facing && !shadowed;
      float nrm[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
      if (lit || next) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          nrm[a] = row(kNrm + a);
          d[a] = state[(3 + a) * S + i];
        }
      }
      float spec = 0.0f;
      if (lit) {
        float L[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) L[a] = shadow_d[a * N + i];
        const float kshine = trt::jmax(row(kShin), 4.0f);
        const float energy =
            (2.0f + kshine) * (1.0f / TRT_F(6.283185307179586));
        const float dn = trt::jmax(norm3(d[0], d[1], d[2]), TRT_F(1e-30));
        float V[3], Rv[3];
        const float sl = 2.0f * ((-L[0] * nrm[0] + -L[1] * nrm[1]) +
                                 -L[2] * nrm[2]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          V[a] = -d[a] / dn;
          Rv[a] = -L[a] - sl * nrm[a];
        }
        const float vr = (V[0] * Rv[0] + V[1] * Rv[1]) + V[2] * Rv[2];
        spec = energy * powf(trt::jmax(vr, 0.0f), kshine);
      }
      const float scale = att_local * row(kLint);
      // the loop's update (rgen:75-108): attenuation before the color
      const float sd =
          2.0f * ((d[0] * nrm[0] + d[1] * nrm[1]) + d[2] * nrm[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float hv = scale * (diff[c] + specc[c] * spec);
        const float at =
            state[(9 + c) * S + i] * (reflective ? specc[c] : 1.0f);
        state[(9 + c) * S + i] = at;
        state[(6 + c) * S + i] = state[(6 + c) * S + i] + hv * at;
        if (first) state[(12 + c) * S + i] = shadow_o[c * N + i];
        if (next) {
          state[c * S + i] = row(kPos + c);
          state[(3 + c) * S + i] = d[c] - sd * nrm[c];
        }
      }
    }
    active[i] = next;
    // the next segment's tmax row: a dead lane's stays 0
    if (tmax_next != nullptr) tmax_next[i] = next ? seg_tmax : 0.0f;
  }
  const int traced = __syncthreads_count(act) +
                     __syncthreads_count(act && shadow_ray);
  const int live = __syncthreads_or(next);
  if (threadIdx.x == 0) {
    if (traced) atomicAdd(rays, (unsigned long long)traced);
    spans[blockIdx.x] = live != 0;
    if (live) atomicAdd(count, 1);
  }
}

}  // namespace

extern "C" int trt_shade_hit(
    const float* origins, const float* dirs, int n, long long rs,
    const float* b_t,
    const int* b_kind, const int* b_prim, const float* b_u, const float* b_v,
    const float* k_t, const int* k_idx, const float* k_u, const float* k_v,
    int tri_off, const float* q_t, const float* tri, const float* tor,
    const float* la0, const float* la1, const float* la2, int n_cols,
    int loose_base, int n_loose, const float* consts, int light_point,
    float intensity, float pixel_spread, const int* tex_off,
    const int* tex_sizes, const int* tex_levels, int n_lv, float* shadow_o,
    float* shadow_d, float* shadow_tmax, float* block, unsigned char* flags,
    int* tex_i0, int* tex_i1, bool* tex_valid, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  shade_hit<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origins, dirs, n, rs, b_t, b_kind, b_prim, b_u, b_v, k_t, k_idx, k_u,
      k_v, tri_off, q_t, tri, tor, la0, la1, la2, n_cols, loose_base, n_loose,
      consts, light_point, intensity, pixel_spread, tex_off, tex_sizes,
      tex_levels, n_lv, shadow_o, shadow_d, shadow_tmax, block, flags,
      tex_i0, tex_i1, tex_valid);
  return (int)cudaGetLastError();
}

extern "C" int trt_shade_finish(
    float* state, int lanes, bool* active, int nb, const float* block,
    const unsigned char* flags, const float* shadow_o, const float* shadow_d,
    const bool* occluded, const int* q0, const int* q1, const float* srgb,
    const float* consts, int first, int more, unsigned long long* rays,
    bool* spans, int* count, float* tmax_next, float seg_tmax,
    void* stream) {
  const int blocks = (nb + kSpan - 1) / kSpan;
  shade_finish<<<blocks, kSpan, 0, (cudaStream_t)stream>>>(
      state, lanes, active, nb, block, flags, shadow_o, shadow_d, occluded,
      q0, q1, srgb, consts, first, more, rays, spans, count, tmax_next,
      seg_tmax);
  return (int)cudaGetLastError();
}
