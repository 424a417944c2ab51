// K2 and K3: analytic torus closest-hit / any-hit, one thread per ray.
//
// K2 `torus_closest_hit` replaces the JAX package's ops/
// torus_kernel.py:136 (_torus_kernel, launched by torus_closest_hit_pallas).
// K3 `torus_closest_hit_small` replaces torus_kernel.py:530
// (_torus_small_kernel, launched by torus_closest_hit_small). Plain twins:
// toroidal_ray_tracing_tpu_torch/ops/torus_kernel.py.
//
// The quartic, per (ray, torus): world->object transform, monic
// coefficients in the closest-approach frame, Ferrari with the Newton
// resolvent solver (exp/log cube root, polynomial acos) and 3 Newton polish
// steps, smallest root in [TMIN, tmax]: a long dependent float chain of
// about 600 operations as written (transform and coefficients ~85, the
// resolvent cubic with an exp, a log, a cos and 3 polish steps ~110, four
// root candidates with 3 polish steps and a residual check ~100 each).
//
// K2's contract (the TPU kernel's): tori in chunks of 8 (16 above 64),
// chunks walked front to back, each torus culled by its world box; the
// winner is the minimum of (t, chunk rank, torus index). The twin tests
// every chunk box per ray (64 at config 4's 1,024 tori, 26 operations each:
// most of its operations), then the quartic of every torus of a chunk that
// any ray of a warp enters ran on the whole warp. Now K2 walks a binary tree
// over the live tori's world boxes (ops/kernel_common.py build_tree, one
// torus per leaf; padded and dead rows are no leaves) as warp packets
// (csrc/tree_walk.cuh), each torus box tested at the ray's running bound
// (exact: a culled torus holds no hit below it; the pass rule stays
// non-strict) and the full key compared with the torus's chunk rank. The
// quartics are spread over the lanes: a leaf's passing (torus, lane) pairs
// go into a per-warp ring in shared memory (slots by ballot and popc), and
// whenever kFlushPairs are queued, and at the end, each lane takes one pair,
// runs its quartic for the owner's ray and folds the key into the owner's
// entry with a 64-bit atomicMin (the t bits mapped to an order-preserving
// unsigned integer above (rank * chunk + torus % chunk)); the pair that
// holds the minimum then writes its torus and root. A ray walks on at the
// bound of the last round, so a pair queued at a stale bound costs an extra
// quartic, never a wrong result. The winner's normal is recomputed once
// after the walk from its root. What bounds K2 then: the quartics of the
// pairs and the slab tests of the nodes the packets enter (operations), or
// the rays' 7 floats in and 17 rows out (bytes); the tables are 32 floats
// per torus (128 KB at 1,024 tori), read as warp-wide broadcasts that stay
// in L1/L2.
//
// K3 takes K <= 8 tori's 32-float parameter blocks into shared memory;
// every ray gates on the union box, then walks all K tori with the per-torus
// slab against its running best. With attrs, the winner's world normal and
// 12 material values are written once after the walk; any-hit writes idx 0,
// as the reference kernel does. Both kernels, optionally, also write the
// query's occlusion byte (t < BIG), ORed into the earlier kernels' where
// asked (common.cuh write_folds). What bounds it on this card is bytes (7
// floats in; t, idx and 15 attr rows out per ray), not its serial
// quartics: they are few (0.16 per ray at config 3's 512x512 frame, K = 4;
// 0.02 at config 7's 1080p frame, K = 1, by its counters). Its device time
// is 0.015 ms at config 3's frame, 2.0x its 0.0075 ms bytes bound, and
// 0.075 ms at config 7's, 1.3x its 0.059 ms (NVIDIA H100 80GB HBM3, 700 W;
// experiments/k3_turns.py). Spreading the quartics over the warp's lanes
// (K2's ring and rounds), or over one thread per (ray, torus) pair, was
// slower at both shapes on the same card, by 4% up to 2.4x.
#include "tree_walk.cuh"

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
                                         const float* dirs, long long rs,
                                         int i, float o[3], float d[3],
                                         float inv[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[a * rs + i];
    d[a] = dirs[a * rs + i];
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

constexpr int kQueue = 64;       // (torus, lane) pairs a warp's ring holds
constexpr int kFlushPairs = 32;  // a round of quartics starts at this many
static_assert(kFlushPairs >= 1 && kFlushPairs <= 32 &&
                  kFlushPairs + 31 <= kQueue && (kQueue & (kQueue - 1)) == 0,
              "a leaf adds at most 32 pairs to fewer than kFlushPairs");

struct PairQueue {
  int pair[kQueue];             // (torus << 5) | owner lane
  unsigned long long key[32];   // per lane: its best (t, rank, torus) key
  int idx[32];                  // per lane: the torus and root of that key
  float root[32];
};

// t's float bits as an unsigned integer in the order of the floats.
__device__ __forceinline__ unsigned ordered_bits(float t) {
  const unsigned u = __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// One round of the warp's queue: lane j < cnt runs the quartic of pair
// head + j for its owner's ray and folds the key into the owner's entry.
// Every lane of the warp calls it.
__device__ __forceinline__ void quartic_round(
    PairQueue& q, int head, int cnt, const trt::Ray& r,
    const float* __restrict__ w2o, const float* __restrict__ rad,
    const int* __restrict__ rank, int chunk, trt::Work& w) {
  constexpr unsigned kAll = trt::kAllLanes;
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the pairs and the initial keys are in shared memory
  const bool has = lane < cnt;
  const int p = has ? q.pair[(head + lane) & (kQueue - 1)] : lane;
  const int owner = p & 31, k = p >> 5;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __shfl_sync(kAll, r.o[a], owner);
    d[a] = __shfl_sync(kAll, r.d[a], owner);
  }
  const float tm = __shfl_sync(kAll, r.tm, owner);
  float t = TRT_BIG, troot = 0.0f;
  if (has) {
    ++w.prim;
    const float Rmaj = rad[2 * k];
    const TorusRay s = torus_ray(w2o + 12 * k, Rmaj, rad[2 * k + 1], o, d);
    t = torus_t(s, tm, &troot);
  }
  const bool hit = t < TRT_BIG;
  const unsigned long long key =
      (unsigned long long)ordered_bits(t) << 32 |
      (unsigned)(rank[k / chunk] * chunk + k % chunk);
  if (hit) atomicMin(&q.key[owner], key);
  __syncwarp();
  if (hit && q.key[owner] == key) {  // one pair per (ray, torus): unique
    q.idx[owner] = k;
    q.root[owner] = troot;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(128) torus_closest_hit(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, long long rs,
    const float* __restrict__ w2o,
    const float* __restrict__ rad, const float* __restrict__ tree_lo,
    const float* __restrict__ tree_hi, const int* __restrict__ tree_link,
    int n_nodes, const int* __restrict__ rank, int chunk,
    const float* __restrict__ mat, int occlusion, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ attr_out,
    long long* __restrict__ counters, bool* __restrict__ occ_out,
    int occ_or) {
  constexpr unsigned kAll = trt::kAllLanes;
  __shared__ PairQueue queues[4];
  const int lane = threadIdx.x & 31;
  PairQueue& q = queues[threadIdx.x >> 5];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const trt::Ray r = trt::load_ray(origins, dirs, tmax, n, rs, i);
  trt::Work w;
  bool done = !(r.tm > TRT_TMIN);  // pad and dead rays take part in no test
  float best = TRT_BIG;            // the ray's t as of the last round
  q.key[lane] = (unsigned long long)ordered_bits(TRT_BIG) << 32 | 0xffffffffu;

  const int neg = trt::majority_negative(r, !done);
  int stack[trt::kStack];
  int sp = 0;
  int head = 0, tail = 0;  // the ring's pairs [head, tail), warp-uniform
  auto run_round = [&]() {
    const int cnt = min(tail - head, 32);
    quartic_round(q, head, cnt, r, w2o, rad, rank, chunk, w);
    head += cnt;
    best = key_t(q.key[lane]);
    done = done || (occlusion && best < TRT_BIG);
  };
  int m = (n_nodes > 0 && __any_sync(kAll, !done)) ? 0 : -1;
  while (m >= 0) {
    const bool pass =
        !done && trt::node_pass(tree_lo, tree_hi, m, r, best, occlusion, w);
    const unsigned passed = __ballot_sync(kAll, pass);
    if (passed) {
      const int left = tree_link[3 * m], right = tree_link[3 * m + 1];
      if (left >= 0) {
        const bool flip = (neg >> tree_link[3 * m + 2]) & 1;
        stack[sp++] = flip ? left : right;
        m = flip ? right : left;
        continue;
      }
      if (pass)
        q.pair[(tail + __popc(passed & ((1u << lane) - 1u))) & (kQueue - 1)] =
            (-1 - left) << 5 | lane;
      tail += __popc(passed);
      if (tail - head >= kFlushPairs) run_round();
    }
    m = sp > 0 ? stack[--sp] : -1;
  }
  while (tail != head) run_round();

  if (i < n) {
    const bool hit = best < TRT_BIG;
    const int bidx = hit ? q.idx[lane] : 0;
    t_out[i] = best;
    idx_out[i] = bidx;
    trt::write_folds(best, r.tm, occlusion, nullptr, occ_out, occ_or, i);
    if (attr_out != nullptr) {
      float nrm[3] = {0.0f, 0.0f, 0.0f};
      if (hit) {
        const float* wk = w2o + 12 * bidx;
        const float Rmaj = rad[2 * bidx];
        const TorusRay s = torus_ray(wk, Rmaj, rad[2 * bidx + 1], r.o, r.d);
        torus_world_normal(wk, s, q.root[lane], Rmaj, nrm);
      }
      write_attrs(attr_out, n, i, hit, nrm, mat + 12 * bidx);
    }
  }
  trt::add_work(counters, w);
}

constexpr int kSmallMaxK = 8;
constexpr int kParams = 32;  // [w2o (12), Rmaj, rmin, lo (3), hi (3), mat (12)]

// kCount: the build that adds its work to counters. The main path launches
// the other one, which carries no counting code: in the one build, the
// counting cost config 7's bytes-bound 1080p calls 5-15% of device time.
// kOcc: the build that writes the occlusion byte (an any-hit query's), so
// the closest-hit build carries none of it.
template <bool kCount, bool kOcc>
__global__ void torus_closest_hit_small(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, int n, long long rs,
    const float* __restrict__ par,
    int K, int occlusion, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ attr_out,
    long long* __restrict__ counters, bool* __restrict__ occ_out,
    int occ_or) {
  __shared__ float sp[kSmallMaxK * kParams];
  for (int j = threadIdx.x; j < K * kParams; j += blockDim.x) sp[j] = par[j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], inv[3];
  load_ray(origins, dirs, rs, i, o, d, inv);
  const float tm = tmax[i];
  unsigned box = 1, prim = 0;  // the twin's counts: the union box, then
                               // the walk's slab tests and quartics

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
      ++box;
      if (!trt::slab_pass(p + 14, p + 17, o, inv, bound, tm) ||
          !(p[13] > 0.0f))
        continue;
      ++prim;
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
  idx_out[i] = occlusion ? 0 : barg;
  if constexpr (kOcc)
    trt::write_folds(best, tm, occlusion, nullptr, occ_out, occ_or, i);
  if (attr_out != nullptr) {
    const bool hit = best < TRT_BIG;
    const float* p = sp + kParams * barg;
    float nrm[3] = {0.0f, 0.0f, 0.0f};
    if (hit) {
      const TorusRay s = torus_ray(p, p[12], p[13], o, d);
      torus_world_normal(p, s, broot, p[12], nrm);
    }
    write_attrs(attr_out, n, i, hit, nrm, p + 20);
  }
  if constexpr (kCount) {  // each group of lanes here adds with one atomic
    const unsigned live = __activemask();
    box = __reduce_add_sync(live, box);
    prim = __reduce_add_sync(live, prim);
    if ((threadIdx.x & 31) == __ffs(live) - 1) {
      atomicAdd(reinterpret_cast<unsigned long long*>(counters), box);
      atomicAdd(reinterpret_cast<unsigned long long*>(counters) + 1, prim);
    }
  }
}

}  // namespace

extern "C" int trt_torus_closest_hit(
    const float* origins, const float* dirs, const float* tmax, int n,
    long long rs, const float* w2o, const float* rad, const float* tree_lo,
    const float* tree_hi, const int* tree_link, int n_nodes, int depth,
    const int* rank, int chunk, const float* mat, int occlusion,
    float* t_out, int* idx_out, float* attr_out, long long* counters,
    bool* occ_out, int occ_or, void* stream) {
  if (depth > trt::kStack) return (int)cudaErrorInvalidValue;
  const int blocks = (n + 127) / 128;
  torus_closest_hit<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, rs, w2o, rad, tree_lo, tree_hi, tree_link,
      n_nodes, rank, chunk, mat, occlusion, t_out, idx_out, attr_out,
      counters, occ_out, occ_or);
  return (int)cudaGetLastError();
}

extern "C" int trt_torus_closest_hit_small(
    const float* origins, const float* dirs, const float* tmax, int n,
    long long rs, const float* par, int K, int occlusion, float* t_out,
    int* idx_out, float* attr_out, long long* counters, bool* occ_out,
    int occ_or, void* stream) {
  if (K < 1 || K > kSmallMaxK) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const bool occ = occ_out != nullptr;
  const auto kernel =
      counters != nullptr
          ? (occ ? torus_closest_hit_small<true, true>
                 : torus_closest_hit_small<true, false>)
          : (occ ? torus_closest_hit_small<false, true>
                 : torus_closest_hit_small<false, false>);
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origins, dirs, tmax, n, rs, par, K, occlusion, t_out, idx_out,
      attr_out, counters, occ_out, occ_or);
  return (int)cudaGetLastError();
}
