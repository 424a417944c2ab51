"""Analytic torus intersection: vectorized quartic root finding on tensors.

Per-ray torus intersection via Ferrari resolvent-cubic factorization with
Newton polish, branch-free (masked selects), in the dtype of the inputs
(float32 on the render path, float64 in the oracle) with the same
Newton-polish counts as the JAX package's `geom/torus.py`.

Torus: axis +y, centered at origin, major radius R, minor radius r:
    (x^2+y^2+z^2 + R^2 - r^2)^2 = 4 R^2 (x^2 + z^2)

Substituting p = o + t d gives a quartic in t. For conditioning the origin is
first translated to the ray's closest approach to the torus center.

`cubic="newton"` is the transcendental-light resolvent solver the torus
kernels use (`_cbrt` from exp/log, `_acos_approx` polynomial): the CUDA
kernels in `csrc/torus_hit.cu` compute the very same function.
"""

from __future__ import annotations

import math

import torch

BIG = 3.0e38


def _cbrt(x):
    """Signed cube root as exp(log|x|/3) (relative error ~1 ulp; the quartic
    Newton polish absorbs it)."""
    ax = x.abs()
    r = torch.exp(torch.log(torch.clamp(ax, min=1e-38)) / 3.0)
    return torch.where(ax < 1e-38, 0.0, torch.sign(x) * r)


def _acos_approx(x):
    """Abramowitz & Stegun 4.4.45 polynomial acos (|err| <= 6.7e-5 rad),
    extended to [-1, 0) via acos(-x) = pi - acos(x)."""
    ax = torch.clamp(x.abs(), max=1.0 - 1e-7)
    r = torch.sqrt(torch.clamp(1.0 - ax, min=1e-12)) * (
        1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * (-0.0187293))))
    return torch.where(x < 0, math.pi - r, r)


def _largest_cubic_root_kernel(A, B, C, polish_iters: int = 3):
    """Largest real root of m^3 + A m^2 + B m + C: trigonometric/Cardano
    split with `_acos_approx` and `_cbrt`, then guarded Newton polish."""
    P = B - A * A / 3.0
    Q = 2.0 * A * A * A / 27.0 - A * B / 3.0 + C
    half_q = Q / 2.0
    third_p = P / 3.0
    D = half_q * half_q + third_p * third_p * third_p

    sqrtD = torch.sqrt(torch.clamp(D, min=1e-30))
    w_single = _cbrt(-half_q + sqrtD) + _cbrt(-half_q - sqrtD)

    three_real = D <= 0.0
    hq_safe = torch.where(three_real, half_q, 0.0)
    tp_safe = torch.where(three_real, third_p, -1.0)
    s = torch.sqrt(torch.clamp(-tp_safe, min=1e-30))
    cos_phi = torch.clamp(-hq_safe / torch.clamp(s * s * s, min=1e-30),
                          -1.0 + 1e-6, 1.0 - 1e-6)
    w_triple = 2.0 * s * torch.cos(_acos_approx(cos_phi) / 3.0)

    m = torch.where(D > 0.0, w_single, w_triple) - A / 3.0
    for _ in range(polish_iters):
        f = ((m + A) * m + B) * m + C
        df = (3.0 * m + 2.0 * A) * m + B
        m = m - f / torch.where(df.abs() > 1e-30, df, 1e-30)
    return m


def _largest_cubic_root(A, B, C):
    """Largest real root of m^3 + A m^2 + B m + C = 0 (exact trig form)."""
    P = B - A * A / 3.0
    Q = 2.0 * A * A * A / 27.0 - A * B / 3.0 + C
    half_q = Q / 2.0
    third_p = P / 3.0
    D = half_q * half_q + third_p * third_p * third_p

    sqrtD = torch.sqrt(torch.clamp(D, min=1e-30))
    w_single = _cbrt(-half_q + sqrtD) + _cbrt(-half_q - sqrtD)

    three_real = D <= 0.0
    hq_safe = torch.where(three_real, half_q, 0.0)
    tp_safe = torch.where(three_real, third_p, -1.0)
    s = torch.sqrt(torch.clamp(-tp_safe, min=1e-30))
    cos_phi = torch.clamp(-hq_safe / torch.clamp(s * s * s, min=1e-30),
                          -1.0 + 1e-6, 1.0 - 1e-6)
    w_triple = 2.0 * s * torch.cos(torch.acos(cos_phi) / 3.0)

    w = torch.where(D > 0.0, w_single, w_triple)
    return w - A / 3.0


def _depressed(b3, b2, b1, b0):
    shift = b3 / 4.0
    p = b2 - 3.0 / 8.0 * b3 * b3
    q = b1 - b3 * b2 / 2.0 + b3 * b3 * b3 / 8.0
    r = (b0 - b3 * b1 / 4.0 + b3 * b3 * b2 / 16.0
         - 3.0 / 256.0 * b3 * b3 * b3 * b3)
    return shift, p, q, r


def _quad_roots(B, C):
    disc = B * B - 4.0 * C
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=1e-30))
    return (-B + sq) / 2.0, (-B - sq) / 2.0, ok


def quartic_roots(b3, b2, b1, b0, newton_iters: int = 3):
    """All real roots of the monic quartic t^4 + b3 t^3 + b2 t^2 + b1 t + b0.

    Returns (roots, valid): both (..., 4); invalid slots hold BIG. Ferrari:
    depress, solve the resolvent cubic, split into two quadratics, then
    polish every root with `newton_iters` Newton steps on the quartic."""
    shift, p, q, r = _depressed(b3, b2, b1, b0)
    m = torch.clamp(_largest_cubic_root(p, p * p / 4.0 - r, -q * q / 8.0),
                    min=0.0)
    two_m = 2.0 * m
    sq2m = torch.sqrt(torch.clamp(two_m, min=1e-30))
    biquad = sq2m < 1e-10

    q_term = q / torch.clamp(2.0 * sq2m, min=1e-30)
    B_a, C_a = -sq2m, p / 2.0 + m + q_term
    B_b, C_b = sq2m, p / 2.0 + m - q_term

    disc_bi = p * p / 4.0 - r
    sq_bi = torch.sqrt(torch.clamp(disc_bi, min=1e-30))
    z_a, z_b = -p / 2.0 + sq_bi, -p / 2.0 - sq_bi

    ra1, ra2, ok_a = _quad_roots(B_a, C_a)
    rb1, rb2, ok_b = _quad_roots(B_b, C_b)

    bi_ok_a = biquad & (disc_bi >= 0.0) & (z_a >= 0.0)
    bi_ok_b = biquad & (disc_bi >= 0.0) & (z_b >= 0.0)
    sz_a = torch.sqrt(torch.clamp(z_a, min=1e-30))
    sz_b = torch.sqrt(torch.clamp(z_b, min=1e-30))

    y = [torch.where(biquad, sz_a, ra1), torch.where(biquad, -sz_a, ra2),
         torch.where(biquad, sz_b, rb1), torch.where(biquad, -sz_b, rb2)]
    va = torch.where(biquad, bi_ok_a, ok_a)
    vb = torch.where(biquad, bi_ok_b, ok_b)
    roots = torch.stack(y, dim=-1) - shift[..., None]
    valid = torch.stack([va, va, vb, vb], dim=-1)

    b3e, b2e = b3[..., None], b2[..., None]
    b1e, b0e = b1[..., None], b0[..., None]
    t = roots
    for _ in range(newton_iters):
        f = (((t + b3e) * t + b2e) * t + b1e) * t + b0e
        df = ((4.0 * t + 3.0 * b3e) * t + 2.0 * b2e) * t + b1e
        step = f / torch.where(df.abs() > 1e-20, df, 1e-20)
        t = torch.where(valid, t - step, t)
    return torch.where(valid, t, BIG), valid


def torus_coefficients(o, d, R, r):
    """Monic quartic coefficients for |o + t d| on the torus surface.

    o, d: (..., 3); R, r broadcastable to (...). d need not be normalized
    (object-space t equals world-space t when d is transformed
    unnormalized). Returns (b3, b2, b1, b0, tshift)."""
    m = torch.clamp((d * d).sum(-1), min=1e-30)
    tshift = -(o * d).sum(-1) / m
    oc = o + tshift[..., None] * d

    od = (oc * d).sum(-1)
    oo = (oc * oc).sum(-1)
    R2, r2 = R * R, r * r
    k = oo + R2 - r2

    dxz2 = d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2]
    oxz_dxz = oc[..., 0] * d[..., 0] + oc[..., 2] * d[..., 2]
    oxz2 = oc[..., 0] * oc[..., 0] + oc[..., 2] * oc[..., 2]

    c4 = m * m
    c3 = 4.0 * m * od
    c2 = 2.0 * m * k + 4.0 * od * od - 4.0 * R2 * dxz2
    c1 = 4.0 * od * k - 8.0 * R2 * oxz_dxz
    c0 = k * k - 4.0 * R2 * oxz2

    inv = 1.0 / c4
    return c3 * inv, c2 * inv, c1 * inv, c0 * inv, tshift


def quartic_min_positive(b3, b2, b1, b0, lo, hi, newton_iters: int = 3,
                         extra_valid=None, cubic: str = "trig"):
    """Smallest real root of the monic quartic inside [lo, hi], BIG where
    none. The four Ferrari candidates are tracked as separate tensors, each
    Newton-polished and residual-checked. `extra_valid` optionally masks
    lanes. cubic="newton" selects the resolvent solver of the kernels."""
    shift, p, q, r0 = _depressed(b3, b2, b1, b0)
    cubic_root = (_largest_cubic_root_kernel if cubic == "newton"
                  else _largest_cubic_root)
    m = torch.clamp(cubic_root(p, p * p / 4.0 - r0, -q * q / 8.0), min=0.0)
    two_m = 2.0 * m
    sq2m = torch.sqrt(torch.clamp(two_m, min=1e-30))
    biquad = sq2m < 1e-10
    q_term = q / torch.clamp(2.0 * sq2m, min=1e-30)

    B_a, C_a = -sq2m, p / 2.0 + m + q_term
    B_b, C_b = sq2m, p / 2.0 + m - q_term

    disc_bi = p * p / 4.0 - r0
    sq_bi = torch.sqrt(torch.clamp(disc_bi, min=1e-30))
    z_a, z_b = -p / 2.0 + sq_bi, -p / 2.0 - sq_bi
    bi_ok_a = biquad & (disc_bi >= 0.0) & (z_a >= 0.0)
    bi_ok_b = biquad & (disc_bi >= 0.0) & (z_b >= 0.0)
    sz_a = torch.sqrt(torch.clamp(z_a, min=1e-30))
    sz_b = torch.sqrt(torch.clamp(z_b, min=1e-30))

    ra1, ra2, ok_a = _quad_roots(B_a, C_a)
    rb1, rb2, ok_b = _quad_roots(B_b, C_b)

    ok_first = (biquad & bi_ok_a) | (~biquad & ok_a)
    ok_second = (biquad & bi_ok_b) | (~biquad & ok_b)
    cands = (
        (torch.where(biquad, sz_a, ra1), ok_first),
        (torch.where(biquad, -sz_a, ra2), ok_first),
        (torch.where(biquad, sz_b, rb1), ok_second),
        (torch.where(biquad, -sz_b, rb2), ok_second),
    )

    best = None
    for y, ok in cands:
        t = y - shift
        for _ in range(newton_iters):
            f = (((t + b3) * t + b2) * t + b1) * t + b0
            df = ((4.0 * t + 3.0 * b3) * t + 2.0 * b2) * t + b1
            step = f / torch.where(df.abs() > 1e-20, df, 1e-20)
            step = torch.clamp(step, -1e3, 1e3)
            t = torch.where(ok, t - step, t)
        good = ok & (t >= lo) & (t <= hi)
        # residual check: a misclassified complex pair after polish has a
        # large |f|; a true root has |f| ~ eps * scale
        at = t.abs()
        f = (((t + b3) * t + b2) * t + b1) * t + b0
        scale = (((at + b3.abs()) * at + b2.abs()) * at
                 + b1.abs()) * at + b0.abs()
        good = good & (f.abs() <= 1e-3 * scale + 1e-30)
        if extra_valid is not None:
            good = good & extra_valid
        t = torch.where(good, t, BIG)
        best = t if best is None else torch.minimum(best, t)
    return best


def torus_intersect(o, d, R, r, tmin, tmax, newton_iters: int = 3,
                    cubic: str = "trig"):
    """Nearest torus hit along each ray. Returns (t, hit): t is BIG where
    no hit; shapes broadcast from o/d (..., 3) and R/r (...). `cubic`
    selects the resolvent solver (see `quartic_min_positive`)."""
    b3, b2, b1, b0, tshift = torus_coefficients(o, d, R, r)
    tmax = torch.as_tensor(tmax, dtype=b3.dtype, device=b3.device)
    lo = tmin - tshift
    hi = tmax - tshift
    # invalid / padding tori carry r < 0 and never hit
    valid = torch.broadcast_to(torch.as_tensor(r, device=b3.device) > 0.0,
                               b3.shape)
    t = quartic_min_positive(b3, b2, b1, b0, lo, hi, newton_iters,
                             extra_valid=valid, cubic=cubic)
    t = torch.where(t < BIG, t + tshift, t)
    return t, t < tmax


def torus_normal(p, R):
    """Outward surface normal at point p on the torus (axis +y): the vector
    from the core circle to p, n = normalize(p - R * normalize((x, 0, z)))."""
    xz = torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 2] ** 2, min=1e-30))
    scale = R / xz
    core = torch.stack(
        [p[..., 0] * scale, torch.zeros_like(p[..., 1]), p[..., 2] * scale],
        dim=-1)
    n = p - core
    ln = torch.sqrt(torch.clamp((n * n).sum(-1, keepdim=True), min=1e-30))
    return n / ln
