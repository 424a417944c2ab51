"""Ray-triangle intersection (Woop unit-triangle test) on tensors.

Replaces the hardware traversal+intersection behind `traceRayEXT`
(VKT/ray_tracing__before/shaders/raytrace.rgen:77, raytrace.rchit:98): each
triangle carries a precomputed affine transform (`Scene.triangles.woop_o`,
`woop_d`) into the unit-triangle frame.
"""

from __future__ import annotations

import torch

BIG = 3.0e38  # "no hit" sentinel t (a float32 value)


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
