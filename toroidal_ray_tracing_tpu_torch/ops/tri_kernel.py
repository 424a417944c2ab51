"""K1: triangle closest-hit / any-hit over SAH clusters.

`tri_closest_hit` is the wrapper: on CUDA tensors it launches the
hand-written kernel `csrc/tri_hit.cu::tri_closest_hit` (one thread per
ray); on CPU tensors it runs `tri_closest_hit_plain`, the plain PyTorch
twin with the same inputs and outputs. It replaces the JAX package's
TPU kernel `ops/tri_kernel.py:77` (`_tri_kernel`).

Contract (per ray, as the TPU kernel): clusters are walked front to back
(by distance of each cluster box from the batch's mean origin); a cluster
whose AABB misses the ray before min(t_best, tmax) is skipped; the Woop
unit-triangle test keeps the minimum t in [TMIN, tmax] with a strict `<`,
so the lowest index wins inside a cluster and the earlier-visited cluster
wins ties across clusters. Occlusion mode only answers "any hit" (t < BIG).
With attr tables, the winner's 21 shading rows come out too:
A0[:, p] + u*A1[:, p] + v*A2[:, p] for rows 0-7, A0 rows 8-20, zero on a
miss. Unlike the TPU kernel, u/v are the true barycentrics in every mode.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.geom.triangle import woop_dots, woop_hit
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, F32, I32, TMIN, _inv_dir, check_args, check_rays, launch, slab,
    visit_order)

N_ATTR = 21


def woop_rows(woop_o, woop_d):
    """(T, 24) row-major Woop table, one 96-byte row per triangle: cols
    0-11 woop_o[k][i] at 4k+i, cols 12-23 woop_d[k][i] at 12+4k+i (i = 3
    zero-padded)."""
    T = woop_o.shape[2]
    wd4 = torch.cat([woop_d, woop_d.new_zeros((3, 1, T))], dim=1)
    return torch.cat([woop_o.permute(2, 0, 1).reshape(T, 12),
                      wd4.permute(2, 0, 1).reshape(T, 12)], dim=1).contiguous()


def tri_closest_hit_plain(origins, dirs, tmax, wrows, clo, chi, order,
                          cluster: int, box_test: bool, attr_tables=None,
                          occlusion: bool = False):
    """Plain PyTorch twin of the CUDA kernel: vectorized over rays, one
    loop step per cluster in `order`. Returns (t, idx, u, v[, attrs])."""
    n = origins.shape[1]
    o = [origins[a] for a in range(3)]
    d = [dirs[a] for a in range(3)]
    inv = [_inv_dir(d[a]) for a in range(3)]
    best = torch.full((n,), BIG, dtype=torch.float32, device=origins.device)
    bidx = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    for c in order.tolist():
        if occlusion:
            bound = torch.where(best < BIG, -1.0, tmax)
        else:
            bound = torch.minimum(best, tmax)
        box = None
        if box_test:
            tn, tf = slab(clo[c], chi[c], o, inv)
            box = (tn <= torch.minimum(tf, bound)) & (tf >= TMIN) \
                & (tmax > TMIN)
            if not bool(box.any()):
                continue
        w = wrows[c * cluster:(c + 1) * cluster].T.reshape(6, 4, cluster, 1)
        comps = woop_dots(w[0:3], w[3:6], *o, *d)          # each (C, N)
        t, u, v, _ = woop_hit(*comps, TMIN, tmax)
        if box is not None:
            t = torch.where(box, t, BIG)
        ct, arg = torch.min(t, dim=0)       # first minimal index on ties
        if occlusion:
            best = torch.minimum(best, ct)
            continue
        better = ct < best
        best = torch.where(better, ct, best)
        bidx = torch.where(better, (c * cluster + arg).to(torch.int32), bidx)
        ar = arg[None, :]
        bu = torch.where(better, u.gather(0, ar)[0], bu)
        bv = torch.where(better, v.gather(0, ar)[0], bv)
    out = (best, bidx, bu, bv)
    if attr_tables is None:
        return out
    a0, a1, a2 = attr_tables
    p = bidx.long()
    top = (a0[:8, p] + bu * a1[:, p]) + bv * a2[:, p]
    attrs = torch.cat([top, a0[8:, p]], dim=0)
    return out + (torch.where(best < BIG, attrs, 0.0),)


def tri_closest_hit(origins, dirs, tmax, woop_o, woop_d, cluster_lo,
                    cluster_hi, cluster: int, attr_tables=None,
                    occlusion: bool = False, n_batch: int | None = None):
    """K1 wrapper. origins/dirs: (3, N) rows; tmax: (N,); woop_o (3, 4, T);
    woop_d (3, 3, T); cluster_lo/hi (C, 3) with C * cluster == T.
    attr_tables: optional ((21, T), (8, T), (8, T)) interpolation tables.
    n_batch: the batch size the visit order averages origins over (the
    caller's padded batch; default N). Returns (t, idx, u, v[, attrs
    (21, N)]) — t is BIG on a miss, idx int32."""
    check_rays(origins, dirs, tmax)
    n = origins.shape[1]
    T = woop_o.shape[2]
    C = cluster_lo.shape[0]
    if C * cluster != T:
        raise ValueError(f"{C} clusters x {cluster} != {T} triangles")
    a0, a1, a2 = attr_tables if attr_tables is not None else (None,) * 3
    wrows = woop_rows(woop_o, woop_d)
    clo = cluster_lo.contiguous()
    chi = cluster_hi.contiguous()
    # a single cluster is tested without its box (nothing to skip ahead to)
    box_test = C > 1
    order = (visit_order(clo, chi, origins, n_batch or n) if box_test
             else torch.zeros((1,), dtype=torch.int32, device=origins.device))
    check_args(origins.device, wrows=(wrows, (T, 24), F32),
               clo=(clo, (C, 3), F32), chi=(chi, (C, 3), F32),
               order=(order, (C,), I32), a0=(a0, (N_ATTR, T), F32),
               a1=(a1, (8, T), F32), a2=(a2, (8, T), F32))

    if not origins.is_cuda:
        return tri_closest_hit_plain(origins, dirs, tmax, wrows, clo, chi,
                                     order, cluster, box_test, attr_tables,
                                     occlusion)

    f32 = dict(dtype=torch.float32, device=origins.device)
    t = torch.empty((n,), **f32)
    idx = torch.empty((n,), dtype=torch.int32, device=origins.device)
    u = torch.empty((n,), **f32)
    v = torch.empty((n,), **f32)
    attrs = (torch.empty((N_ATTR, n), **f32) if attr_tables is not None
             else None)
    if n:
        launch("trt_tri_closest_hit", origins, dirs, tmax, n, wrows, clo, chi,
               order, C, cluster, int(box_test), a0, a1, a2, T,
               int(occlusion), t, idx, u, v, attrs)
    out = (t, idx, u, v)
    return out + ((attrs,) if attrs is not None else ())
