"""K5 and K6: triangle closest-hit / any-hit for meshes above
`TRI_STREAM_MIN` triangles, over superblocks of clusters.

`tri_closest_hit_stream` is the wrapper. On CUDA tensors it launches the
hand-written kernel `csrc/tri_stream.cu::tri_closest_hit_stream` (K5, one
thread per ray), or `tri_closest_hit_stream_grouped` (K6, one CTA of 128
rays stages each superblock in shared memory) when `STREAM_GROUP > 1`; on
CPU tensors it runs `tri_closest_hit_stream_plain`, the plain PyTorch twin
of both. They replace the JAX package's TPU kernels `ops/tri_stream.py:202`
(`_tri_stream_kernel`) and `:303` (`_tri_stream_grouped_kernel`).

Contract (the JAX launcher's, `tri_stream.py:468`): K1's, with clusters
grouped into superblocks of `g` clusters. The superblock set-up is the
TPU launcher's, exactly: `g`, `S` and `sb_tris` from `STREAM_GATE_BOXES`
and `STREAM_MAX_SB`; superblock boxes over the cluster boxes with empty
clusters (far point boxes) masked; superblocks ranked front to back by
distance from the caller's padded batch's mean origin (stable). Per ray the
winner is the lexicographic minimum of (t, superblock rank, row). Inside a
passing superblock the kernels also skip clusters by their own boxes, in
index order: a skipped cluster holds no hit below the running bound, so the
key's minimum is unchanged. u/v are the true barycentrics in every mode.

Not carried over (TPU machinery, default-off A/B paths): the per-span XLA
visit gate and its packed SMEM rows, the visit-row cap and its overflow
fallback, and the HIER / NOGATE / DIAG / SUB switches.
"""

from __future__ import annotations

import os

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, F32, I32, box_pass, check_args, check_rays, count, launch,
    visit_order, walk_bound)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (
    N_ATTR, fold_block, walk_start, winner_attrs, woop_block, woop_rows)

TRI_STREAM_MIN = 65536     # triangles: above this the orchestrator streams
STREAM_GATE_BOXES = 512    # superblock-count target (tri_stream.py:31)
STREAM_MAX_SB = 512        # triangles per superblock cap (tri_stream.py:70)
STREAM_GROUP = int(os.environ.get("TRT_STREAM_GROUP", "0"))
# > 1 selects K6, as the same switch selects the grouped TPU kernel
# (tri_stream.py:446); 0, the default, runs K5. On the GPU a group is one
# CTA of 128 rays whatever the value.


def superblocks(cluster_lo, cluster_hi, cluster: int):
    """The TPU launcher's superblock set-up (tri_stream.py:483-487,
    518-532). Returns (g, S, clo, chi, sb_lo, sb_hi): clo/chi are the
    cluster boxes padded to S*g with far point boxes."""
    C = cluster_lo.shape[0]
    g = max(1, -(-C // STREAM_GATE_BOXES))
    g = min(g, max(1, STREAM_MAX_SB // cluster))
    S = -(-C // g)
    clo, chi = cluster_lo, cluster_hi
    if S * g != C:
        far = torch.full((S * g - C, 3), 1e30, dtype=F32,
                         device=clo.device)
        clo = torch.cat([clo, far])
        chi = torch.cat([chi, far])
    # empty clusters carry far point boxes: min over lo keeps the real
    # bound, but a +FAR hi would blow a mixed superblock up to infinity
    empty = clo[:, 0:1] > 1e29
    chi_eff = torch.where(empty, -1e30, chi)
    sb_lo = clo.reshape(S, g, 3).amin(dim=1)
    sb_hi = chi_eff.reshape(S, g, 3).amax(dim=1)
    all_empty = empty.reshape(S, g, 1).all(dim=1)
    sb_hi = torch.where(all_empty, sb_lo, sb_hi)   # far point, not inverted
    return (g, S, clo.contiguous(), chi.contiguous(), sb_lo.contiguous(),
            sb_hi.contiguous())


def tri_closest_hit_stream_plain(origins, dirs, tmax, wrows, sb_lo, sb_hi,
                                 order, clo, chi, g: int, cluster: int,
                                 attr_tables=None, occlusion: bool = False,
                                 counts=None):
    """Plain PyTorch twin of K5 and K6: vectorized over rays, one loop step
    per superblock in `order`, then per cluster in it. Returns (t, idx, u,
    v[, attrs]). counts: optional dict of the kernels' (ray, box) slab tests
    ("box"), (ray, triangle) Woop tests ("prim") and the distinct triangles
    some ray tests ("rows")."""
    n = origins.shape[1]
    T = wrows.shape[0]
    o, d, inv, state = walk_start(origins, dirs)

    def live():
        return (state[0] >= BIG).sum() if occlusion else n

    for s in order.tolist():
        count(counts, "box", live())
        sb = box_pass(sb_lo[s], sb_hi[s], o, inv,
                      walk_bound(state[0], tmax, occlusion), tmax)
        if not bool(sb.any()):
            continue
        for c in range(s * g, (s + 1) * g):
            base = c * cluster
            if base >= T:
                break
            count(counts, "box", (sb & (state[0] >= BIG)).sum()
                  if occlusion else sb.sum())
            box = sb & box_pass(clo[c], chi[c], o, inv,
                                walk_bound(state[0], tmax, occlusion), tmax)
            if not bool(box.any()):
                continue
            end = min(base + cluster, T)
            count(counts, "prim", (end - base) * box.sum())
            count(counts, "rows", end - base)
            t, u, v = woop_block(wrows, base, end, o, d, tmax)
            state = fold_block(state, torch.where(box, t, BIG), u, v, base,
                               occlusion)
    if attr_tables is None:
        return state
    return state + (winner_attrs(attr_tables, *state),)


def stream_inputs(origins, woop_o, woop_d, cluster_lo, cluster_hi,
                  cluster: int, n_batch: int | None = None):
    """The tables as the wrapper passes them to the kernels or the twin:
    (wrows, sb_lo, sb_hi, order, clo, chi, g)."""
    g, S, clo, chi, sb_lo, sb_hi = superblocks(cluster_lo, cluster_hi,
                                               cluster)
    order = visit_order(sb_lo, sb_hi, origins, n_batch or origins.shape[1])
    return woop_rows(woop_o, woop_d), sb_lo, sb_hi, order, clo, chi, g


def tri_closest_hit_stream(origins, dirs, tmax, woop_o, woop_d, cluster_lo,
                           cluster_hi, cluster: int, attr_tables=None,
                           occlusion: bool = False,
                           n_batch: int | None = None,
                           group: int | None = None):
    """K5/K6 wrapper, K1's contract. origins/dirs (3, N); tmax (N,); woop_o
    (3, 4, T); woop_d (3, 3, T); cluster_lo/hi (C, 3) with C * cluster == T
    and cluster % 128 == 0. attr_tables: optional ((21, T), (8, T), (8, T)).
    n_batch: the batch size the superblock rank averages origins over (the
    caller's padded batch; default N). group: K6 when > 1 (default: the
    module's STREAM_GROUP). Returns (t, idx, u, v[, attrs (21, N)])."""
    check_rays(origins, dirs, tmax)
    n = origins.shape[1]
    T = woop_o.shape[2]
    C = cluster_lo.shape[0]
    if cluster % 128 or C * cluster != T:
        raise ValueError(f"{C} clusters x {cluster} vs {T} triangles: the "
                         "stream kernels take whole 128-multiple clusters")
    group = STREAM_GROUP if group is None else group
    wrows, sb_lo, sb_hi, order, clo, chi, g = stream_inputs(
        origins, woop_o, woop_d, cluster_lo, cluster_hi, cluster, n_batch)
    S, Cp = sb_lo.shape[0], clo.shape[0]
    a0, a1, a2 = attr_tables if attr_tables is not None else (None,) * 3
    check_args(origins.device, wrows=(wrows, (T, 24), F32),
               sb_lo=(sb_lo, (S, 3), F32), sb_hi=(sb_hi, (S, 3), F32),
               order=(order, (S,), I32), clo=(clo, (Cp, 3), F32),
               chi=(chi, (Cp, 3), F32), a0=(a0, (N_ATTR, T), F32),
               a1=(a1, (8, T), F32), a2=(a2, (8, T), F32))

    if not origins.is_cuda:
        return tri_closest_hit_stream_plain(origins, dirs, tmax, wrows, sb_lo,
                                            sb_hi, order, clo, chi, g,
                                            cluster, attr_tables, occlusion)

    # K6 stages one superblock of <= STREAM_MAX_SB rows (48 KB); its entry
    # point refuses a larger one with an error that `launch` raises
    name = "trt_tri_closest_hit_stream" + ("_grouped" if group > 1 else "")
    f32 = dict(dtype=torch.float32, device=origins.device)
    t = torch.empty((n,), **f32)
    idx = torch.empty((n,), dtype=torch.int32, device=origins.device)
    u = torch.empty((n,), **f32)
    v = torch.empty((n,), **f32)
    attrs = (torch.empty((N_ATTR, n), **f32) if attr_tables is not None
             else None)
    if n:
        launch(name, origins, dirs, tmax, n, wrows, T, sb_lo, sb_hi, order,
               S, clo, chi, g, cluster, a0, a1, a2, int(occlusion), t, idx,
               u, v, attrs)
    return (t, idx, u, v) + ((attrs,) if attrs is not None else ())
