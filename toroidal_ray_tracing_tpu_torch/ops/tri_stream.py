"""K5 and K6: triangle closest-hit / any-hit for meshes above
`TRI_STREAM_MIN` triangles, over superblocks of clusters.

`tri_closest_hit_stream` is the wrapper. On CUDA tensors it launches the
hand-written kernel `csrc/tri_stream.cu::tri_closest_hit_stream` (K5, one
thread per ray, the 32 rays of a warp walking as a packet), or
`tri_closest_hit_stream_grouped` (K6, one CTA of 128 rays walks as a
packet and bulk-copies each leaf's rows into shared memory) when
`STREAM_GROUP > 1`; on CPU tensors it runs `tri_closest_hit_stream_plain`,
the plain PyTorch twin of both. They replace the JAX package's TPU kernels
`ops/tri_stream.py:202` (`_tri_stream_kernel`) and `:303`
(`_tri_stream_grouped_kernel`).

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

The twin walks every superblock in rank order. The kernels walk a binary
tree over the superblock boxes instead (`kernel_common.build_tree`; K5
walks it as K1 walks its clusters' tree): its leaves are the non-empty
superblocks, one each, with the superblock's own box; each inner node's
box is the exact min/max of its children's. A packet enters a node
when any of its rays passes the node at its own bound. Visiting order no
longer follows the rank, so the kernels compare the full (t, rank, row)
key and take the rank as `rank[s]`. Where a hit lies within rounding of
its box's entry face, the bound a box meets can differ between the two
orders; everywhere else the two walks return the same bits.

The scene-constant tables (`StreamTables`: the Woop rows, the padded
cluster boxes, the superblock boxes and the tree) are built by
`stream_tables`, once per mesh: the tree is a host build (~0.3 s at config
8), so the wrapper takes the tables and never builds them. The
orchestrator keeps them per scene and device. Only the rank, which depends
on the batch's mean origin, is per call: the caller's (the bounce loop
ranks a segment's sets once with the visit-rank kernel V1,
`ops.visit_kernel`), or V1 on the call's own rays. Beside the hit the
kernels write K1's optional folds (`kernel_common.fold_outputs`).

Not carried over (TPU machinery, default-off A/B paths): the per-span XLA
visit gate and its packed SMEM rows, the visit-row cap and its overflow
fallback, and the HIER / NOGATE / DIAG / SUB switches.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, F32, I32, box_pass, check_args, check_folds, check_rays, count,
    fill, fold_outputs, launch, tree_rank, tree_tensors, walk_bound)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (
    N_ATTR, fold_block, hit_outputs, walk_start, winner_attrs, woop_block,
    woop_rows)
from toroidal_ray_tracing_tpu_torch.ops.visit_kernel import visit_rank
from toroidal_ray_tracing_tpu_torch.utils import profiling

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


@dataclasses.dataclass
class StreamTables:
    """The scene-constant inputs of K5/K6 and their twin."""

    g: int
    cluster: int
    wrows: torch.Tensor      # (T, 24) Woop rows
    clo: torch.Tensor        # (S * g, 3) cluster boxes, far-padded
    chi: torch.Tensor
    sb_lo: torch.Tensor      # (S, 3) superblock boxes
    sb_hi: torch.Tensor
    tree_lo: torch.Tensor    # (M, 3) node boxes
    tree_hi: torch.Tensor
    tree_link: torch.Tensor  # (M, 3) int32, see kernel_common.build_tree
    depth: int


def stream_tables(woop_o, woop_d, cluster_lo, cluster_hi,
                  cluster: int) -> StreamTables:
    """Build the scene-constant tables of a mesh: woop_o (3, 4, T); woop_d
    (3, 3, T); cluster_lo/hi (C, 3) with C * cluster == T and cluster %
    128 == 0 (the kernels take whole 128-multiple clusters). One host sync:
    the tree is built on the host from the superblock boxes."""
    T, C = woop_o.shape[2], cluster_lo.shape[0]
    if cluster % 128 or C * cluster != T:
        raise ValueError(f"{C} clusters x {cluster} vs {T} triangles: the "
                         "stream kernels take whole 128-multiple clusters")
    g, S, clo, chi, sb_lo, sb_hi = superblocks(cluster_lo, cluster_hi,
                                               cluster)
    live = ~(clo[:, 0] > 1e29).reshape(S, g).all(dim=1)
    tree_lo, tree_hi, tree_link, depth = tree_tensors(sb_lo, sb_hi, live)
    return StreamTables(
        g=g, cluster=cluster, wrows=woop_rows(woop_o, woop_d), clo=clo,
        chi=chi, sb_lo=sb_lo, sb_hi=sb_hi, tree_lo=tree_lo, tree_hi=tree_hi,
        tree_link=tree_link, depth=depth)


def tri_closest_hit_stream_plain(origins, dirs, tmax, wrows, sb_lo, sb_hi,
                                 order, clo, chi, g: int, cluster: int,
                                 attr_tables=None, occlusion: bool = False,
                                 counts=None, tmax_out=None, occ_out=None,
                                 occ_or: bool = False):
    """Plain PyTorch twin of K5 and K6: vectorized over rays, one loop step
    per superblock in `order`, then per cluster in it. Returns (t, idx, u,
    v[, attrs]). counts: optional dict of this flat walk's (ray, box) slab
    tests ("box"), (ray, triangle) Woop tests ("prim") and the distinct
    triangles some ray tests ("rows"). tmax_out, occ_out, occ_or: the
    folds, as K1's wrapper's."""
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
    fold_outputs(state[0], tmax, occlusion, tmax_out, occ_out, occ_or)
    if attr_tables is None:
        return state
    return state + (winner_attrs(attr_tables, *state),)


def check_tri_closest_hit_stream(origins, dirs, tmax, tables: StreamTables,
                                 attr_tables=None, occlusion: bool = False,
                                 counters=None, rank=None, tmax_out=None,
                                 occ_out=None, occ_or: bool = False,
                                 out=None) -> int:
    """`tri_closest_hit_stream`'s argument checks (a segment plan runs them
    once on its own arguments and outputs; rank None: V1 makes it);
    returns the rays' row stride."""
    rs = check_rays(origins, dirs, tmax)
    n = origins.shape[1]
    tb = tables
    T, S, Cp, M = (tb.wrows.shape[0], tb.sb_lo.shape[0], tb.clo.shape[0],
                   tb.tree_lo.shape[0])
    a0, a1, a2 = attr_tables if attr_tables is not None else (None,) * 3
    check_args(origins.device, wrows=(tb.wrows, (T, 24), F32),
               sb_lo=(tb.sb_lo, (S, 3), F32), sb_hi=(tb.sb_hi, (S, 3), F32),
               clo=(tb.clo, (Cp, 3), F32), chi=(tb.chi, (Cp, 3), F32),
               tree_lo=(tb.tree_lo, (M, 3), F32),
               tree_hi=(tb.tree_hi, (M, 3), F32),
               tree_link=(tb.tree_link, (M, 3), I32),
               rank=(rank, (S,), I32),
               a0=(a0, (N_ATTR, T), F32), a1=(a1, (8, T), F32),
               a2=(a2, (8, T), F32),
               counters=(counters, (2,), torch.int64))
    check_folds(origins.device, n, occlusion, tmax_out, occ_out, occ_or)
    if out is not None:
        hit_outputs(out, n, attr_tables is not None, origins.device)
    return rs


def tri_closest_hit_stream(origins, dirs, tmax, tables: StreamTables,
                           attr_tables=None, occlusion: bool = False,
                           n_batch: int | None = None,
                           group: int | None = None, counters=None,
                           rank=None, tmax_out=None, occ_out=None,
                           occ_or: bool = False, out=None):
    """K5/K6 wrapper, K1's contract. origins/dirs (3, N), strided rows as
    K1's; tmax (N,); tables: the mesh's `stream_tables`. attr_tables:
    optional ((21, T), (8, T), (8, T)). n_batch: the batch size the
    superblock rank averages origins over (the caller's padded batch;
    default N). group: K6 when > 1 (default: the module's STREAM_GROUP).
    counters: optional (2,) int64 CUDA tensor the kernel adds its (ray,
    box) slab tests and (ray, triangle) Woop tests to. rank: the (S,)
    int32 visit rank of the superblocks (default: V1 on these rays).
    tmax_out, occ_out, occ_or, out: as `tri_closest_hit`'s. Returns (t,
    idx, u, v[, attrs (21, N)])."""
    n = origins.shape[1]
    tb = tables
    group = STREAM_GROUP if group is None else group
    if out is None:
        rs = check_tri_closest_hit_stream(origins, dirs, tmax, tb,
                                          attr_tables, occlusion, counters,
                                          rank, tmax_out, occ_out, occ_or)
    else:
        rs = origins.stride(0)
    if rank is None:
        rank = visit_rank(origins, n_batch or n, tb.sb_lo, tb.sb_hi)
    if profiling.HIT_CALLS is not None and n:
        profiling.HIT_CALLS.append(profiling.HitCall(
            "tri_closest_hit_stream" + ("_grouped" if group > 1 else ""), n,
            attr_tables is not None, tmax_out is not None,
            occ_out is not None, bool(occ_or), tb.tree_lo.shape[0],
            tb.sb_lo.shape[0], tb.clo.shape[0], 0))

    if not origins.is_cuda:
        if counters is not None:
            raise ValueError("counters count the CUDA kernels' work")
        got = tri_closest_hit_stream_plain(
            origins, dirs, tmax, tb.wrows, tb.sb_lo, tb.sb_hi,
            tree_rank(rank), tb.clo, tb.chi, tb.g, tb.cluster, attr_tables,
            occlusion, tmax_out=tmax_out, occ_out=occ_out, occ_or=occ_or)
        return got if out is None else fill(out, got)

    # the entry points refuse a tree deeper than the kernels' stack, and K6
    # a superblock of more than STREAM_MAX_SB rows (48 KB staged), with an
    # error that `launch` raises
    if out is None:
        f32 = dict(dtype=torch.float32, device=origins.device)
        out = (torch.empty((n,), **f32),
               torch.empty((n,), dtype=torch.int32, device=origins.device),
               torch.empty((n,), **f32), torch.empty((n,), **f32))
        if attr_tables is not None:
            out += (torch.empty((N_ATTR, n), **f32),)
    a0, a1, a2 = attr_tables if attr_tables is not None else (None,) * 3
    if n:
        args = (origins, dirs, tmax, n, rs, tb.wrows, tb.wrows.shape[0],
                tb.tree_lo, tb.tree_hi, tb.tree_link, tb.tree_lo.shape[0],
                tb.depth, rank, tb.clo, tb.chi, tb.g, tb.cluster, a0, a1, a2,
                int(occlusion), *out[:4],
                out[4] if attr_tables is not None else None, counters,
                tmax_out, occ_out, int(occ_or))
        launch("trt_tri_closest_hit_stream"
               + ("_grouped" if group > 1 else ""), *args,
               stream=getattr(out, "stream", None))
    return out
