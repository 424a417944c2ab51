"""Ray-triangle intersection on tensors.

Replaces the hardware traversal+intersection behind `traceRayEXT`
(VKT/ray_tracing__before/shaders/raytrace.rgen:77, raytrace.rchit:98) with
two formulations:

* `moller_trumbore` — the classic test, used by the oracle
  (`oracle/cpu_renderer.py`) and for small cross-checks, with `ray_aabb`,
  the slab test;
* the Woop unit-triangle test (`intersect_woop`): each triangle carries a
  precomputed affine transform (`Scene.triangles.woop_o`, `woop_d`) into the
  unit-triangle frame. This is the renderer's formulation.

Sums of three products run in index order, ((a0*b0 + a1*b1) + a2*b2), as
NumPy's reductions do, so a float32 test rounds as the NumPy one does.
"""

from __future__ import annotations

import torch

BIG = 3.0e38  # "no hit" sentinel t (a float32 value)


def dot3(a, b):
    """Dot product over the last axis (size 3), summed in index order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    """Cross product over the last axis (size 3), as `np.cross` rounds it."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def moller_trumbore(origins, dirs, v0, e1, e2, tmin, tmax, eps=1e-8):
    """Batched Möller–Trumbore in the dtype of the inputs.

    origins/dirs: (N, 3); v0/e1/e2: (T, 3); tmin/tmax broadcast to (N, T).
    Returns (t, u, v, hit): each (N, T); t == BIG where no hit."""
    o = origins[:, None, :]
    d = dirs[:, None, :]
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
        & (t >= tmin) & (t <= tmax)
    return torch.where(hit, t, BIG), u, v, hit


def ray_aabb(origins, inv_dirs, lo, hi, tmin, tmax):
    """Slab test: rays (N, 3) x boxes (C, 3). Returns the hit mask (N, C).

    `inv_dirs` = 1/dirs with +/-inf where a component is 0 (IEEE slab
    test)."""
    o = origins[:, None, :]
    inv_d = inv_dirs[:, None, :]
    t0 = (lo[None] - o) * inv_d
    t1 = (hi[None] - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    tmax = torch.as_tensor(tmax, dtype=tfar.dtype, device=tfar.device)
    return (tnear <= torch.minimum(tfar, tmax)) & (tfar >= tmin)


def woop_dots(woop_o, woop_d, ox, oy, oz, dx, dy, dz):
    """Transformed origin/direction components (opx, opy, opz, dpx, dpy,
    dpz), summed in input order — ((w0*x + w1*y) + w2*z) + w3 — the order
    the triangle kernel uses, so kernel and plain code round alike.
    woop_o: (3, 4, ...); woop_d: (3, 3, ...); ray components broadcast."""
    op = [((woop_o[k, 0] * ox + woop_o[k, 1] * oy) + woop_o[k, 2] * oz)
          + woop_o[k, 3] for k in range(3)]
    dp = [(woop_d[k, 0] * dx + woop_d[k, 1] * dy) + woop_d[k, 2] * dz
          for k in range(3)]
    return op[0], op[1], op[2], dp[0], dp[1], dp[2]


def woop_hit(opx, opy, opz, dpx, dpy, dpz, tmin, tmax):
    """The unit-triangle test on transformed components. Returns
    (t, u, v, hit); t == BIG where no hit."""
    dz_ok = dpz.abs() > 1e-12
    inv_dz = torch.where(dz_ok, 1.0, 0.0) / torch.where(dz_ok, dpz, 1.0)
    t = -opz * inv_dz
    u = opx + t * dpx
    v = opy + t * dpy
    hit = dz_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= tmin) & (t <= tmax)
    return torch.where(hit, t, BIG), u, v, hit


def intersect_woop(origins, dirs, woop_o, woop_d, tmin, tmax):
    """origins/dirs: (N, 3); woop_o: (3, 4, T); woop_d: (3, 3, T).
    Returns (t, u, v, hit), each (N, T)."""
    o = [origins[:, k, None] for k in range(3)]
    d = [dirs[:, k, None] for k in range(3)]
    comps = woop_dots(woop_o, woop_d, *o, *d)
    return woop_hit(*comps, tmin, tmax)
