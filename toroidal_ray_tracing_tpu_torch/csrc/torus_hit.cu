// K2 and K3: analytic torus closest-hit / any-hit, one thread per ray.
//
// K2 `torus_closest_hit` replaces the JAX package's ops/
// torus_kernel.py:136 (_torus_kernel, launched by torus_closest_hit_pallas).
// K3 `torus_closest_hit_small` replaces torus_kernel.py:530
// (_torus_small_kernel, launched by torus_closest_hit_small). Plain twins:
// toroidal_ray_tracing_tpu_torch/ops/torus_kernel.py.
//
// K2 walks the wrapper's front-to-back chunk order (8 tori per chunk, 16
// above 64 tori). The chunk box is slab-tested first (exact shortcut: every
// live torus box lies inside its chunk box), then each torus box against
// the bound taken at the chunk's start, then the quartic: world->object
// transform, monic coefficients in the closest-approach frame, Ferrari with
// the Newton resolvent solver (exp/log cube root, polynomial acos) and 3
// Newton polish steps, smallest root in [TMIN, tmax]. The chunk minimum
// (lowest index on ties) replaces the ray's best only if strictly smaller.
// K3 takes K <= 8 tori's 32-float parameter blocks into shared memory;
// every ray gates on the union box, then walks all K tori with the per-torus
// slab against its running best. With attrs, the winner's world normal and
// 12 material values are written once after the walk.
//
// What bounds it: the per-ray quartic — a long dependent float chain per
// candidate torus, about 600 operations as written (transform and
// coefficients ~85, the resolvent cubic with an exp, a log, a cos and 3
// polish steps ~110, four root candidates with 3 polish steps and a residual
// check ~100 each) — and the slab tests (26 operations each, common.cuh),
// not memory: the tables are 32 floats per
// torus (128 KB at 1,024 tori), read as warp-wide broadcasts that stay in
// L1/L2. Culling (chunk box, torus box, running best) is what cuts the
// work; block-major ray order keeps a warp's rays on the same candidates.
#include "common.cuh"

namespace {

using trt::clampf;
using trt::jmax;
using trt::jmin;

__device__ __forceinline__ float cbrt_exp(float x) {
  const float ax = fabsf(x);
  const float r = expf(logf(jmax(ax, TRT_F(1e-38))) / 3.0f);
  const float sgn = (float)((x > 0.0f) - (x < 0.0f));
  return ax < TRT_F(1e-38) ? 0.0f : sgn * r;
}

__device__ __forceinline__ float acos_approx(float x) {
  const float ax = jmin(fabsf(x), TRT_F(1.0 - 1e-7));
  const float r =
      sqrtf(jmax(1.0f - ax, TRT_F(1e-12))) *
      (TRT_F(1.5707288) +
       ax * (TRT_F(-0.2121144) +
             ax * (TRT_F(0.0742610) + ax * TRT_F(-0.0187293))));
  return x < 0.0f ? TRT_F(3.141592653589793) - r : r;
}

// geom/torus.py::_largest_cubic_root_kernel (3 polish steps)
__device__ float largest_cubic_root(float A, float B, float C) {
  const float P = B - A * A / 3.0f;
  const float Q = 2.0f * A * A * A / 27.0f - A * B / 3.0f + C;
  const float half_q = Q / 2.0f;
  const float third_p = P / 3.0f;
  const float D = half_q * half_q + third_p * third_p * third_p;

  const float sqrtD = sqrtf(jmax(D, TRT_F(1e-30)));
  const float w_single = cbrt_exp(-half_q + sqrtD) + cbrt_exp(-half_q - sqrtD);

  const bool three_real = D <= 0.0f;
  const float hq_safe = three_real ? half_q : 0.0f;
  const float tp_safe = three_real ? third_p : -1.0f;
  const float s = sqrtf(jmax(-tp_safe, TRT_F(1e-30)));
  const float cos_phi = clampf(-hq_safe / jmax(s * s * s, TRT_F(1e-30)),
                               TRT_F(-1.0 + 1e-6), TRT_F(1.0 - 1e-6));
  const float w_triple = 2.0f * s * cosf(acos_approx(cos_phi) / 3.0f);

  float m = (D > 0.0f ? w_single : w_triple) - A / 3.0f;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const float f = ((m + A) * m + B) * m + C;
    const float df = (3.0f * m + 2.0f * A) * m + B;
    m = m - f / (fabsf(df) > TRT_F(1e-30) ? df : TRT_F(1e-30));
  }
  return m;
}

__device__ __forceinline__ float polish_candidate(float y, bool ok, float shift,
                                                  float b3, float b2, float b1,
                                                  float b0, float lo,
                                                  float hi) {
  float t = y - shift;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const float f = (((t + b3) * t + b2) * t + b1) * t + b0;
    const float df = ((4.0f * t + 3.0f * b3) * t + 2.0f * b2) * t + b1;
    float step = f / (fabsf(df) > TRT_F(1e-20) ? df : TRT_F(1e-20));
    step = clampf(step, -1000.0f, 1000.0f);
    t = ok ? t - step : t;
  }
  bool good = ok && (t >= lo) && (t <= hi);
  const float at = fabsf(t);
  const float f = (((t + b3) * t + b2) * t + b1) * t + b0;
  const float scale =
      (((at + fabsf(b3)) * at + fabsf(b2)) * at + fabsf(b1)) * at + fabsf(b0);
  good = good && (fabsf(f) <= TRT_F(1e-3) * scale + TRT_F(1e-30));
  return good ? t : TRT_BIG;
}

// geom/torus.py::quartic_min_positive(cubic="newton", newton_iters=3)
__device__ float quartic_min_positive(float b3, float b2, float b1, float b0,
                                      float lo, float hi) {
  const float shift = b3 / 4.0f;
  const float p = b2 - TRT_F(3.0 / 8.0) * b3 * b3;
  const float q = b1 - b3 * b2 / 2.0f + b3 * b3 * b3 / 8.0f;
  const float r0 = b0 - b3 * b1 / 4.0f + b3 * b3 * b2 / 16.0f -
                   TRT_F(3.0 / 256.0) * b3 * b3 * b3 * b3;

  const float m =
      jmax(largest_cubic_root(p, p * p / 4.0f - r0, -q * q / 8.0f), 0.0f);
  const float two_m = 2.0f * m;
  const float sq2m = sqrtf(jmax(two_m, TRT_F(1e-30)));
  const bool biquad = sq2m < TRT_F(1e-10);
  const float q_term = q / jmax(2.0f * sq2m, TRT_F(1e-30));

  const float B_a = -sq2m, C_a = p / 2.0f + m + q_term;
  const float B_b = sq2m, C_b = p / 2.0f + m - q_term;

  const float disc_bi = p * p / 4.0f - r0;
  const float sq_bi = sqrtf(jmax(disc_bi, TRT_F(1e-30)));
  const float z_a = -p / 2.0f + sq_bi, z_b = -p / 2.0f - sq_bi;
  const bool bi_ok_a = biquad && (disc_bi >= 0.0f) && (z_a >= 0.0f);
  const bool bi_ok_b = biquad && (disc_bi >= 0.0f) && (z_b >= 0.0f);
  const float sz_a = sqrtf(jmax(z_a, TRT_F(1e-30)));
  const float sz_b = sqrtf(jmax(z_b, TRT_F(1e-30)));

  const float disc_a = B_a * B_a - 4.0f * C_a;
  const float sq_a = sqrtf(jmax(disc_a, TRT_F(1e-30)));
  const float ra1 = (-B_a + sq_a) / 2.0f, ra2 = (-B_a - sq_a) / 2.0f;
  const bool ok_a = disc_a >= 0.0f;
  const float disc_b = B_b * B_b - 4.0f * C_b;
  const float sq_b = sqrtf(jmax(disc_b, TRT_F(1e-30)));
  const float rb1 = (-B_b + sq_b) / 2.0f, rb2 = (-B_b - sq_b) / 2.0f;
  const bool ok_b = disc_b >= 0.0f;

  const bool ok_first = (biquad && bi_ok_a) || (!biquad && ok_a);
  const bool ok_second = (biquad && bi_ok_b) || (!biquad && ok_b);

  float best = polish_candidate(biquad ? sz_a : ra1, ok_first, shift, b3, b2,
                                b1, b0, lo, hi);
  best = jmin(best, polish_candidate(biquad ? -sz_a : ra2, ok_first, shift,
                                     b3, b2, b1, b0, lo, hi));
  best = jmin(best, polish_candidate(biquad ? sz_b : rb1, ok_second, shift,
                                     b3, b2, b1, b0, lo, hi));
  best = jmin(best, polish_candidate(biquad ? -sz_b : rb2, ok_second, shift,
                                     b3, b2, b1, b0, lo, hi));
  return best;
}

// Ray in one torus's object frame + closest-approach quartic
// (ops/torus_kernel.py _w2o_rays + _torus_quartic_coeffs).
struct TorusRay {
  float dxo, dyo, dzo, tshift, px, py, pz, b3, b2, b1, b0;
};

__device__ __forceinline__ TorusRay torus_ray(const float* w, float Rmaj,
                                              float rmin, const float o[3],
                                              const float d[3]) {
  TorusRay s;
  const float oxo = ((w[0] * o[0] + w[1] * o[1]) + w[2] * o[2]) + w[3];
  const float oyo = ((w[4] * o[0] + w[5] * o[1]) + w[6] * o[2]) + w[7];
  const float ozo = ((w[8] * o[0] + w[9] * o[1]) + w[10] * o[2]) + w[11];
  s.dxo = (w[0] * d[0] + w[1] * d[1]) + w[2] * d[2];
  s.dyo = (w[4] * d[0] + w[5] * d[1]) + w[6] * d[2];
  s.dzo = (w[8] * d[0] + w[9] * d[1]) + w[10] * d[2];
  const float m =
      jmax(s.dxo * s.dxo + s.dyo * s.dyo + s.dzo * s.dzo, TRT_F(1e-30));
  s.tshift = -(oxo * s.dxo + oyo * s.dyo + ozo * s.dzo) / m;
  s.px = oxo + s.tshift * s.dxo;
  s.py = oyo + s.tshift * s.dyo;
  s.pz = ozo + s.tshift * s.dzo;
  const float od = s.px * s.dxo + s.py * s.dyo + s.pz * s.dzo;
  const float oo = s.px * s.px + s.py * s.py + s.pz * s.pz;
  const float R2 = Rmaj * Rmaj;
  const float k = oo + R2 - rmin * rmin;
  const float dxz2 = s.dxo * s.dxo + s.dzo * s.dzo;
  const float oxz_dxz = s.px * s.dxo + s.pz * s.dzo;
  const float oxz2 = s.px * s.px + s.pz * s.pz;
  const float inv4 = 1.0f / (m * m);
  s.b3 = 4.0f * m * od * inv4;
  s.b2 = (2.0f * m * k + 4.0f * od * od - 4.0f * R2 * dxz2) * inv4;
  s.b1 = (4.0f * od * k - 8.0f * R2 * oxz_dxz) * inv4;
  s.b0 = (k * k - 4.0f * R2 * oxz2) * inv4;
  return s;
}

// Closest root of one torus (BIG if none); *troot gets the shifted-frame
// root the normal needs.
__device__ __forceinline__ float torus_t(const TorusRay& s, float tm,
                                         float* troot) {
  const float r = quartic_min_positive(s.b3, s.b2, s.b1, s.b0,
                                       TRT_TMIN - s.tshift, tm - s.tshift);
  *troot = r;
  return r < TRT_BIG ? r + s.tshift : TRT_BIG;
}

// World-space (unnormalized) normal of a hit: _torus_obj_normal +
// _obj_normal_to_world.
__device__ __forceinline__ void torus_world_normal(const float* w,
                                                   const TorusRay& s,
                                                   float troot, float Rmaj,
                                                   float n[3]) {
  const float pxh = s.px + troot * s.dxo;
  const float pyh = s.py + troot * s.dyo;
  const float pzh = s.pz + troot * s.dzo;
  const float xz = sqrtf(jmax(pxh * pxh + pzh * pzh, TRT_F(1e-30)));
  const float scale = 1.0f - Rmaj / xz;
  const float nx = pxh * scale, ny = pyh, nz = pzh * scale;
  n[0] = nx * w[0] + ny * w[4] + nz * w[8];
  n[1] = nx * w[1] + ny * w[5] + nz * w[9];
  n[2] = nx * w[2] + ny * w[6] + nz * w[10];
}

__device__ __forceinline__ void load_ray(const float* origins,
                                         const float* dirs, int n, int i,
                                         float o[3], float d[3],
                                         float inv[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[(size_t)a * n + i];
    d[a] = dirs[(size_t)a * n + i];
    inv[a] = trt::inv_dir(d[a]);
  }
}

__device__ __forceinline__ void write_attrs(float* attr_out, int n, int i,
                                            bool hit, const float nrm[3],
                                            const float* mat) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    attr_out[(size_t)a * n + i] = hit ? nrm[a] : 0.0f;
#pragma unroll
  for (int c = 0; c < 12; ++c)
    attr_out[(size_t)(3 + c) * n + i] = hit ? mat[c] : 0.0f;
}

__global__ void torus_closest_hit(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, const float* __restrict__ w2o,
    const float* __restrict__ rad, const float* __restrict__ tor_lo,
    const float* __restrict__ tor_hi, const float* __restrict__ clo,
    const float* __restrict__ chi, const int* __restrict__ order,
    int n_chunks, int chunk, const float* __restrict__ mat, int occlusion,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ attr_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], inv[3];
  load_ray(origins, dirs, n, i, o, d, inv);
  const float tm = tmax[i];

  float best = TRT_BIG, broot = 0.0f;
  int bidx = 0;
  for (int vi = 0; vi < n_chunks; ++vi) {
    const int c = order[vi];
    const float bound = occlusion ? (best < TRT_BIG ? -1.0f : tm)
                                  : jmin(tm, best);
    if (!trt::slab_pass(clo + 3 * c, chi + 3 * c, o, inv, bound, tm))
      continue;
    float cbest = TRT_BIG, croot = 0.0f;
    int carg = 0;
    for (int j = 0; j < chunk; ++j) {
      const int k = c * chunk + j;
      const float rmin = rad[2 * k + 1];
      if (!(rmin > 0.0f) ||
          !trt::slab_pass(tor_lo + 3 * k, tor_hi + 3 * k, o, inv, bound, tm))
        continue;
      const float Rmaj = rad[2 * k];
      const TorusRay s = torus_ray(w2o + 12 * k, Rmaj, rmin, o, d);
      float troot;
      const float t = torus_t(s, tm, &troot);
      if (t < cbest) {
        cbest = t;
        carg = j;
        croot = troot;
      }
    }
    if (cbest < best) {
      best = cbest;
      bidx = c * chunk + carg;
      broot = croot;
      if (occlusion) break;
    }
  }
  t_out[i] = best;
  idx_out[i] = bidx;
  if (attr_out != nullptr) {
    const bool hit = best < TRT_BIG;
    float nrm[3] = {0.0f, 0.0f, 0.0f};
    if (hit) {
      const float* w = w2o + 12 * bidx;
      const float Rmaj = rad[2 * bidx];
      const TorusRay s = torus_ray(w, Rmaj, rad[2 * bidx + 1], o, d);
      torus_world_normal(w, s, broot, Rmaj, nrm);
    }
    write_attrs(attr_out, n, i, hit, nrm, mat + 12 * bidx);
  }
}

constexpr int kSmallMaxK = 8;
constexpr int kParams = 32;  // [w2o (12), Rmaj, rmin, lo (3), hi (3), mat (12)]

__global__ void torus_closest_hit_small(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, const float* __restrict__ par,
    int K, int emit_attrs, int occlusion, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ attr_out) {
  __shared__ float sp[kSmallMaxK * kParams];
  for (int j = threadIdx.x; j < K * kParams; j += blockDim.x) sp[j] = par[j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], inv[3];
  load_ray(origins, dirs, n, i, o, d, inv);
  const float tm = tmax[i];

  // union-box gate over the K boxes
  float ulo[3], uhi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ulo[a] = sp[14 + a];
    uhi[a] = sp[17 + a];
  }
  for (int k = 1; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ulo[a] = jmin(ulo[a], sp[kParams * k + 14 + a]);
      uhi[a] = jmax(uhi[a], sp[kParams * k + 17 + a]);
    }
  }
  float best = TRT_BIG, broot = 0.0f;
  int barg = 0;
  if (trt::slab_pass(ulo, uhi, o, inv, tm, tm)) {
    for (int k = 0; k < K; ++k) {
      const float* p = sp + kParams * k;
      const float bound = occlusion ? (best < TRT_BIG ? -1.0f : tm)
                                    : jmin(tm, best);
      if (!trt::slab_pass(p + 14, p + 17, o, inv, bound, tm) ||
          !(p[13] > 0.0f))
        continue;
      const TorusRay s = torus_ray(p, p[12], p[13], o, d);
      float troot;
      const float t = torus_t(s, tm, &troot);
      if (t < best) {
        best = t;
        barg = k;
        broot = troot;
        if (occlusion) break;
      }
    }
  }
  t_out[i] = best;
  idx_out[i] = barg;
  if (emit_attrs) {
    const bool hit = best < TRT_BIG;
    const float* p = sp + kParams * barg;
    float nrm[3] = {0.0f, 0.0f, 0.0f};
    if (hit) {
      const TorusRay s = torus_ray(p, p[12], p[13], o, d);
      torus_world_normal(p, s, broot, p[12], nrm);
    }
    write_attrs(attr_out, n, i, hit, nrm, p + 20);
  }
}

}  // namespace

extern "C" int trt_torus_closest_hit(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* w2o, const float* rad, const float* tor_lo,
    const float* tor_hi, const float* clo, const float* chi, const int* order,
    int n_chunks, int chunk, const float* mat, int occlusion, float* t_out,
    int* idx_out, float* attr_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  torus_closest_hit<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, w2o, rad, tor_lo, tor_hi, clo, chi, order,
      n_chunks, chunk, mat, occlusion, t_out, idx_out, attr_out);
  return (int)cudaGetLastError();
}

extern "C" int trt_torus_closest_hit_small(
    const float* origins, const float* dirs, const float* tmax, int n,
    const float* par, int K, int emit_attrs, int occlusion, float* t_out,
    int* idx_out, float* attr_out, void* stream) {
  if (K < 1 || K > kSmallMaxK) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  torus_closest_hit_small<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, par, K, emit_attrs, occlusion, t_out, idx_out,
      attr_out);
  return (int)cudaGetLastError();
}
