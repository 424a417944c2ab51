"""The bounce loop, closest hit and shading of the reference shader, dense
and plain (a frozen copy of the repository oracle's arithmetic).

Semantics, line by line from the reference:
  VKT/ray_tracing__before/shaders/raytrace.rgen:59-116 (bounce loop, miss mix)
  VKT/ray_tracing__before/shaders/raytrace.rchit:26-135 (closest hit)
  VKT/ray_tracing__before/shaders/raytrace.rmiss:16-22  (miss)
  VKT/ray_tracing__before/shaders/wavefront.glsl:23-50  (diffuse/specular)

Every ray is tested against every triangle (Möller–Trumbore) and every
torus (Ferrari's quartic with Newton polish, in float64 when the trace runs
in float32), in blocks of at most `PAIRS` (ray, primitive) pairs. Ties go
to the first primitive with the smallest t, triangles before tori. In a
lower `dtype` (the control) everything runs in that type.
"""

from __future__ import annotations

import math

import torch

BIG = 1.0e30
TMIN = 0.001          # raytrace.rgen:61
TMAX = 10000.0        # raytrace.rgen:62
PAIRS = {"cuda": 1 << 25, "cpu": 1 << 18}


def dot3(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _sqrt(x):
    """Square root rounded once to x's type (float32: the correctly rounded
    root on every device)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _norm(x):
    return _sqrt(dot3(x, x))


def moller_trumbore(o, d, v0, e1, e2, tmax, eps=1e-8):
    """(t, u, v), each (N, T): t BIG where the ray misses."""
    o, d = o[:, None, :], d[:, None, :]
    v0, e1, e2 = v0[None], e1[None], e2[None]
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    det_ok = det.abs() > eps
    inv_det = torch.where(det_ok, 1.0, 0.0) / torch.where(det_ok, det, 1.0)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= TMIN) & (t <= tmax)
    return torch.where(hit, t, BIG), u, v


# --- the torus quartic (Ferrari, trig resolvent, Newton polish) --------------

def _cbrt(x):
    ax = x.abs()
    r = torch.exp(torch.log(torch.clamp(ax, min=1e-38)) / 3.0)
    return torch.where(ax < 1e-38, 0.0, torch.sign(x) * r)


def _largest_cubic_root(A, B, C):
    P = B - A * A / 3.0
    Q = 2.0 * A * A * A / 27.0 - A * B / 3.0 + C
    half_q, third_p = Q / 2.0, P / 3.0
    D = half_q * half_q + third_p * third_p * third_p
    sqrtD = torch.sqrt(torch.clamp(D, min=1e-30))
    w_single = _cbrt(-half_q + sqrtD) + _cbrt(-half_q - sqrtD)
    three_real = D <= 0.0
    hq = torch.where(three_real, half_q, 0.0)
    tp = torch.where(three_real, third_p, -1.0)
    s = torch.sqrt(torch.clamp(-tp, min=1e-30))
    cos_phi = torch.clamp(-hq / torch.clamp(s * s * s, min=1e-30),
                          -1.0 + 1e-6, 1.0 - 1e-6)
    w_triple = 2.0 * s * torch.cos(torch.acos(cos_phi) / 3.0)
    return torch.where(D > 0.0, w_single, w_triple) - A / 3.0


def _quad_roots(B, C):
    disc = B * B - 4.0 * C
    sq = torch.sqrt(torch.clamp(disc, min=1e-30))
    return (-B + sq) / 2.0, (-B - sq) / 2.0, disc >= 0.0


def _quartic_min(b3, b2, b1, b0, lo, hi, valid, newton_iters=3):
    """Smallest real root of t^4 + b3 t^3 + b2 t^2 + b1 t + b0 in [lo, hi],
    BIG where none."""
    shift = b3 / 4.0
    p = b2 - 3.0 / 8.0 * b3 * b3
    q = b1 - b3 * b2 / 2.0 + b3 * b3 * b3 / 8.0
    r0 = (b0 - b3 * b1 / 4.0 + b3 * b3 * b2 / 16.0
          - 3.0 / 256.0 * b3 * b3 * b3 * b3)
    m = torch.clamp(_largest_cubic_root(p, p * p / 4.0 - r0, -q * q / 8.0),
                    min=0.0)
    sq2m = torch.sqrt(torch.clamp(2.0 * m, min=1e-30))
    biquad = sq2m < 1e-10
    q_term = q / torch.clamp(2.0 * sq2m, min=1e-30)
    disc_bi = p * p / 4.0 - r0
    sq_bi = torch.sqrt(torch.clamp(disc_bi, min=1e-30))
    z_a, z_b = -p / 2.0 + sq_bi, -p / 2.0 - sq_bi
    bi_a = biquad & (disc_bi >= 0.0) & (z_a >= 0.0)
    bi_b = biquad & (disc_bi >= 0.0) & (z_b >= 0.0)
    sz_a = torch.sqrt(torch.clamp(z_a, min=1e-30))
    sz_b = torch.sqrt(torch.clamp(z_b, min=1e-30))
    ra1, ra2, ok_a = _quad_roots(-sq2m, p / 2.0 + m + q_term)
    rb1, rb2, ok_b = _quad_roots(sq2m, p / 2.0 + m - q_term)
    ok1 = (biquad & bi_a) | (~biquad & ok_a)
    ok2 = (biquad & bi_b) | (~biquad & ok_b)
    best = None
    for y, ok in ((torch.where(biquad, sz_a, ra1), ok1),
                  (torch.where(biquad, -sz_a, ra2), ok1),
                  (torch.where(biquad, sz_b, rb1), ok2),
                  (torch.where(biquad, -sz_b, rb2), ok2)):
        t = y - shift
        for _ in range(newton_iters):
            f = (((t + b3) * t + b2) * t + b1) * t + b0
            df = ((4.0 * t + 3.0 * b3) * t + 2.0 * b2) * t + b1
            step = f / torch.where(df.abs() > 1e-20, df, 1e-20)
            t = torch.where(ok, t - torch.clamp(step, -1e3, 1e3), t)
        at = t.abs()
        f = (((t + b3) * t + b2) * t + b1) * t + b0
        scale = (((at + b3.abs()) * at + b2.abs()) * at
                 + b1.abs()) * at + b0.abs()
        good = (ok & (t >= lo) & (t <= hi) & (f.abs() <= 1e-3 * scale + 1e-30)
                & valid)
        t = torch.where(good, t, BIG)
        best = t if best is None else torch.minimum(best, t)
    return best


def torus_t(o, d, R, r, tmax):
    """Nearest hit t of rays o, d (..., 3) in the torus's object frame
    (axis +y, radii R, r), BIG where none."""
    m = torch.clamp((d * d).sum(-1), min=1e-30)
    tshift = -(o * d).sum(-1) / m
    oc = o + tshift[..., None] * d
    od, oo = (oc * d).sum(-1), (oc * oc).sum(-1)
    R2, r2 = R * R, r * r
    k = oo + R2 - r2
    dxz2 = d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2]
    oxz_dxz = oc[..., 0] * d[..., 0] + oc[..., 2] * d[..., 2]
    oxz2 = oc[..., 0] * oc[..., 0] + oc[..., 2] * oc[..., 2]
    c3 = 4.0 * m * od
    c2 = 2.0 * m * k + 4.0 * od * od - 4.0 * R2 * dxz2
    c1 = 4.0 * od * k - 8.0 * R2 * oxz_dxz
    c0 = k * k - 4.0 * R2 * oxz2
    inv = 1.0 / (m * m)
    valid = torch.broadcast_to(r > 0.0, c3.shape)
    t = _quartic_min(c3 * inv, c2 * inv, c1 * inv, c0 * inv,
                     TMIN - tshift, tmax - tshift, valid)
    return torch.where(t < BIG, t + tshift, t)


# --- closest hit ------------------------------------------------------------

def _blocks(n: int, count: int, pairs: int):
    per = max(1, min(count, pairs // max(n, 1)))
    rows = max(1, pairs // per)
    return [slice(s, min(s + rows, n)) for s in range(0, n, rows)], per


def closest_hit(tb, o, d, tmax, any_hit=False):
    """{t, kind (0 triangle, 1 torus, -1 miss), prim, u, v} of each ray,
    or with any_hit the occlusion mask."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=dt, device=dev),
                              (n,))
    best_t = torch.full((n,), BIG, dtype=dt, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=dt, device=dev)
    best_v = torch.zeros((n,), dtype=dt, device=dev)
    pairs = PAIRS[dev.type]
    nt = tb["v0"].shape[0]
    if nt:
        slices, per = _blocks(n, nt, pairs)
        for rs in slices:
            oo, dd, tm = o[rs], d[rs], tmax[rs, None]
            bt, bp, bk = best_t[rs], best_prim[rs], best_kind[rs]
            bu, bv = best_u[rs], best_v[rs]
            for s in range(0, nt, per):
                e = min(s + per, nt)
                t, u, v = moller_trumbore(oo, dd, tb["v0"][s:e],
                                          tb["e1"][s:e], tb["e2"][s:e], tm)
                arg = torch.argmin(t, dim=1, keepdim=True)
                tb_ = t.gather(1, arg)[:, 0]
                better = tb_ < bt
                bt = torch.where(better, tb_, bt)
                bp = torch.where(better, arg[:, 0] + s, bp)
                bk = torch.where(better, 0, bk)
                bu = torch.where(better, u.gather(1, arg)[:, 0], bu)
                bv = torch.where(better, v.gather(1, arg)[:, 0], bv)
            best_t[rs], best_prim[rs], best_kind[rs] = bt, bp, bk
            best_u[rs], best_v[rs] = bu, bv
    nk = tb["major"].shape[0]
    if nk:
        wide = torch.float64 if dt == torch.float32 else dt
        slices, per = _blocks(n, nk, pairs // 4)
        for rs in slices:
            ow, dw = o[rs].to(wide), d[rs].to(wide)
            tm = tmax[rs, None].to(wide)
            bt, bp, bk = best_t[rs], best_prim[rs], best_kind[rs]
            for s in range(0, nk, per):
                e = min(s + per, nk)
                M = tb["w2o"][s:e].to(wide)
                oo = torch.stack([((ow[:, None, 0] * M[None, :, i, 0]
                                    + ow[:, None, 1] * M[None, :, i, 1])
                                   + ow[:, None, 2] * M[None, :, i, 2])
                                  + M[None, :, i, 3] for i in range(3)], -1)
                dd = torch.stack([(dw[:, None, 0] * M[None, :, i, 0]
                                   + dw[:, None, 1] * M[None, :, i, 1])
                                  + dw[:, None, 2] * M[None, :, i, 2]
                                  for i in range(3)], -1)
                t = torus_t(oo, dd, tb["major"][s:e].to(wide)[None],
                            tb["minor"][s:e].to(wide)[None], tm).to(dt)
                arg = torch.argmin(t, dim=1, keepdim=True)
                tb_ = t.gather(1, arg)[:, 0]
                better = tb_ < bt
                bt = torch.where(better, tb_, bt)
                bp = torch.where(better, arg[:, 0] + s, bp)
                bk = torch.where(better, 1, bk)
            best_t[rs], best_prim[rs], best_kind[rs] = bt, bp, bk
    if any_hit:
        return best_t < BIG
    return {"t": best_t, "prim": best_prim, "kind": best_kind, "u": best_u,
            "v": best_v}


# --- shading ----------------------------------------------------------------

def _reflect(d, n):
    return d - (2.0 * dot3(d, n))[:, None] * n


def _torus_normal(p, R):
    xz = _sqrt(torch.clamp(p[:, 0] * p[:, 0] + p[:, 2] * p[:, 2],
                           min=1e-30))
    scale = R / xz
    n = p - torch.stack([p[:, 0] * scale, torch.zeros_like(scale),
                         p[:, 2] * scale], dim=-1)
    return n / _sqrt(torch.clamp(dot3(n, n), min=1e-30))[:, None]


def shade(tb, settings, o, d, hit):
    """raytrace.rchit:26-135 and rmiss on one segment's rays."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    t, kind = hit["t"], hit["kind"]
    prim = torch.clamp(hit["prim"], min=0)
    missed = kind < 0
    ray_hit_pos = o + torch.clamp(t, max=1.0e8)[:, None] * d

    nt, nk = tb["v0"].shape[0], tb["major"].shape[0]
    if nt:
        tp = torch.clamp(prim, max=nt - 1)
        u, v = hit["u"][:, None], hit["v"][:, None]
        w = (1.0 - hit["u"] - hit["v"])[:, None]
        v0 = tb["v0"][tp]
        tri_pos = (v0 * w + (v0 + tb["e1"][tp]) * u) + (v0 + tb["e2"][tp]) * v
        tri_nrm = (tb["n0"][tp] * w + tb["n1"][tp] * u) + tb["n2"][tp] * v
        tri_mat = tb["tri_mat"][tp]
    else:
        tri_pos = tri_nrm = ray_hit_pos
        tri_mat = torch.zeros((n,), dtype=torch.int64, device=dev)
    is_tor = kind == 1
    if nk:
        k = torch.clamp(prim, max=nk - 1)
        M = tb["w2o"][k]
        p = ray_hit_pos
        p_obj = torch.stack([((M[:, i, 0] * p[:, 0] + M[:, i, 1] * p[:, 1])
                              + M[:, i, 2] * p[:, 2]) + M[:, i, 3]
                             for i in range(3)], dim=-1)
        n_obj = _torus_normal(p_obj, tb["major"][k])
        n_w = torch.stack([(n_obj[:, 0] * M[:, 0, j]
                            + n_obj[:, 1] * M[:, 1, j])
                           + n_obj[:, 2] * M[:, 2, j] for j in range(3)],
                          dim=-1)
        n_w = n_w / torch.clamp(_norm(n_w), min=1e-30)[:, None]
        world_pos = torch.where(is_tor[:, None], ray_hit_pos, tri_pos)
        nrm = torch.where(is_tor[:, None], n_w, tri_nrm)
        mat = torch.where(is_tor, tb["tor_mat"][k], tri_mat)
    else:
        world_pos, nrm, mat = tri_pos, tri_nrm, tri_mat
    nrm = nrm / torch.clamp(_norm(nrm), min=1e-30)[:, None]

    ambient, diffuse_c = tb["ambient"][mat], tb["diffuse"][mat]
    specular_c, shininess = tb["specular"][mat], tb["shininess"][mat]
    illum = tb["illum"][mat]

    lpos = torch.as_tensor(settings["light_position"], dtype=torch.float32,
                           device=dev).to(dt)
    if settings["light_type"] == "point":
        ldir = lpos[None, :] - world_pos
        ldist = _norm(ldir)
        lint = settings["light_intensity"] / torch.clamp(ldist * ldist,
                                                         min=1e-20)
        L = ldir / torch.clamp(ldist, min=1e-20)[:, None]
    else:
        L = torch.broadcast_to(lpos / _norm(lpos), world_pos.shape)
        ldist = torch.full((n,), 100000.0, dtype=dt, device=dev)
        lint = torch.full((n,), settings["light_intensity"], dtype=dt,
                          device=dev)

    ndotl = dot3(nrm, L)
    diffuse = diffuse_c * torch.clamp(ndotl, min=0.0)[:, None]
    diffuse = torch.where((illum >= 1)[:, None], diffuse + ambient, diffuse)

    facing = ndotl > 0.0
    shadowed = torch.zeros((n,), dtype=torch.bool, device=dev)
    idx = torch.nonzero(facing & ~missed).flatten()
    if len(idx):
        shadowed[idx] = closest_hit(tb, ray_hit_pos[idx], L[idx],
                                    ldist[idx], any_hit=True)
    attenuation = torch.where(facing & shadowed, 0.3, 1.0).to(dt)

    kshine = torch.clamp(shininess, min=4.0)
    energy = (2.0 + kshine) / (2.0 * math.pi)
    V = -d / torch.clamp(_norm(d), min=1e-30)[:, None]
    spec = energy * torch.clamp(dot3(V, _reflect(-L, nrm)), min=0.0) ** kshine
    spec = torch.where((illum >= 2) & facing & ~shadowed, spec, 0.0)
    hit_value = (attenuation * lint)[:, None] * (diffuse + specular_c
                                                 * spec[:, None])
    clear = torch.as_tensor(settings["clear_color"][:3], dtype=torch.float32,
                            device=dev).to(dt) * 0.8
    hit_value = torch.where(missed[:, None], clear[None, :], hit_value)
    reflective = (illum == 3) & ~missed
    return {
        "hit_value": hit_value,
        "hit_position": torch.where(missed[:, None], 0.0, ray_hit_pos),
        "atten_factor": torch.where(reflective[:, None], specular_c, 1.0),
        "done": ~reflective,
        "next_origin": world_pos,
        "next_dir": _reflect(d, nrm),
    }


def trace(tb, settings, origins, dirs, dtype=torch.float32):
    """The bounce loop (raytrace.rgen:75-108) on rays (P, 3). Returns
    (color, first-hit position), each (P, 3) float32."""
    o, d = origins.to(dtype).clone(), dirs.to(dtype).clone()
    n, dev = o.shape[0], o.device
    color = torch.zeros((n, 3), dtype=dtype, device=dev)
    att = torch.ones((n, 3), dtype=dtype, device=dev)
    first = torch.zeros((n, 3), dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev)
    for depth in range(max(int(settings["max_depth"]), 1)):
        if len(idx) == 0:
            break
        hit = closest_hit(tb, o[idx], d[idx], TMAX)
        sh = shade(tb, settings, o[idx], d[idx], hit)
        a = att[idx] * sh["atten_factor"]
        att[idx] = a
        color[idx] = color[idx] + sh["hit_value"] * a
        if depth == 0:
            first[idx] = sh["hit_position"]
        o[idx] = sh["next_origin"]
        d[idx] = sh["next_dir"]
        idx = idx[~sh["done"]]
    return color.float(), first.float()
