"""K1: triangle closest-hit / any-hit over SAH clusters.

`tri_closest_hit` is the wrapper: on CUDA tensors it launches the
hand-written kernel `csrc/tri_hit.cu::tri_closest_hit` (one thread per
ray, the 32 rays of a warp walking a tree over the clusters as a packet);
on CPU tensors it runs `tri_closest_hit_plain`, the plain PyTorch twin
with the same inputs and outputs. It replaces the JAX package's TPU kernel
`ops/tri_kernel.py:77` (`_tri_kernel`).

Contract (per ray, as the TPU kernel): clusters are walked front to back
(by distance of each cluster box from the batch's mean origin); a cluster
whose AABB misses the ray before min(t_best, tmax) is skipped; the Woop
unit-triangle test keeps the minimum t in [TMIN, tmax] with a strict `<`,
so the lowest index wins inside a cluster and the earlier-visited cluster
wins ties across clusters: the winner is the minimum of (t, rank, row),
a cluster's rank being its position in the visit order. Occlusion mode
only answers "any hit" (t < BIG). With attr tables, the winner's 21
shading rows come out too: A0[:, p] + u*A1[:, p] + v*A2[:, p] for rows
0-7, A0 rows 8-20, zero on a miss. Unlike the TPU kernel, u/v are the true
barycentrics in every mode.

The twin walks every cluster in rank order. The kernel walks a binary tree
over the live clusters' boxes (`kernel_common.build_tree`, one cluster per
leaf; far-boxed clusters, such as the hoisted loose tail, are no leaves)
and compares the full key, so it returns the twin's bits wherever the two
walks meet a box at the same bound. The scene-constant tables (`TriTables`:
the Woop rows, the cluster boxes as walked and the tree) are built once by
`tri_tables`; the wrapper takes them and never builds them, and the
orchestrator keeps them per scene and device. Only the rank is per call:
the caller's (the bounce loop ranks a segment's sets once with the
visit-rank kernel V1, `ops.visit_kernel`), or V1 on the call's own rays.

Beside the hit the kernel can write the query's folds for the kernel after
it (`kernel_common.fold_outputs`): the torus query's tmax and, in any-hit
mode, the query's occlusion byte.
"""

from __future__ import annotations

import dataclasses

import torch

from toroidal_ray_tracing_tpu_torch.geom.triangle import woop_dots, woop_hit
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, F32, I32, TMIN, _inv_dir, box_pass, check_args, check_folds,
    check_rays, count, fill, fold_outputs, launch, tree_rank, tree_tensors,
    walk_bound)
from toroidal_ray_tracing_tpu_torch.ops.visit_kernel import visit_rank
from toroidal_ray_tracing_tpu_torch.utils import profiling

N_ATTR = 21


def woop_rows(woop_o, woop_d):
    """(T, 24) row-major Woop table, one 96-byte row per triangle: cols
    0-11 woop_o[k][i] at 4k+i, cols 12-23 woop_d[k][i] at 12+4k+i (i = 3
    zero-padded)."""
    T = woop_o.shape[2]
    wd4 = torch.cat([woop_d, woop_d.new_zeros((3, 1, T))], dim=1)
    return torch.cat([woop_o.permute(2, 0, 1).reshape(T, 12),
                      wd4.permute(2, 0, 1).reshape(T, 12)], dim=1).contiguous()


def woop_block(wrows, lo: int, hi: int, o, d, tmax):
    """Woop test of table rows [lo, hi) against every ray: (t, u, v), each
    (rows, N), t BIG where a pair misses."""
    w = wrows[lo:hi].T.reshape(6, 4, hi - lo, 1)
    comps = woop_dots(w[0:3], w[3:6], *o, *d)            # each (rows, N)
    t, u, v, _ = woop_hit(*comps, TMIN, tmax)
    return t, u, v


def fold_block(state, t, u, v, base: int, occlusion: bool):
    """Fold one block's (rows, N) Woop results into the running (best, idx,
    u, v): the block minimum (first minimal row on ties) replaces the best
    only if strictly smaller. Occlusion keeps only the minimum t."""
    best, bidx, bu, bv = state
    ct, arg = torch.min(t, dim=0)
    if occlusion:
        return torch.minimum(best, ct), bidx, bu, bv
    better = ct < best
    ar = arg[None, :]
    return (torch.where(better, ct, best),
            torch.where(better, (base + arg).to(torch.int32), bidx),
            torch.where(better, u.gather(0, ar)[0], bu),
            torch.where(better, v.gather(0, ar)[0], bv))


def walk_start(origins, dirs):
    """Per-ray rows o, d, slab reciprocals and the empty running best."""
    n = origins.shape[1]
    o = [origins[a] for a in range(3)]
    d = [dirs[a] for a in range(3)]
    inv = [_inv_dir(d[a]) for a in range(3)]
    best = torch.full((n,), BIG, dtype=torch.float32, device=origins.device)
    bidx = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    return o, d, inv, (best, bidx, torch.zeros_like(best),
                       torch.zeros_like(best))


def winner_attrs(attr_tables, best, bidx, bu, bv):
    """(21, N) attrs of each ray's winning triangle, zero on a miss:
    A0[:, p] + u*A1[:, p] + v*A2[:, p] for rows 0-7, A0 rows 8-20."""
    a0, a1, a2 = attr_tables
    p = bidx.long()
    top = (a0[:8, p] + bu * a1[:, p]) + bv * a2[:, p]
    attrs = torch.cat([top, a0[8:, p]], dim=0)
    return torch.where(best < BIG, attrs, 0.0)


def tri_closest_hit_plain(origins, dirs, tmax, wrows, clo, chi, order,
                          cluster: int, box_test: bool, attr_tables=None,
                          occlusion: bool = False, counts=None,
                          tmax_out=None, occ_out=None, occ_or: bool = False):
    """Plain PyTorch twin of the CUDA kernel: vectorized over rays, one
    loop step per cluster in `order`. Returns (t, idx, u, v[, attrs]).
    counts: optional dict; adds the (ray, box) slab tests under "box", the
    (ray, triangle) Woop tests under "prim" that the kernel runs, and the
    distinct triangles some ray tests under "rows". tmax_out, occ_out,
    occ_or: the folds, as the wrapper's."""
    n = origins.shape[1]
    o, d, inv, state = walk_start(origins, dirs)
    for c in order.tolist():
        bound = walk_bound(state[0], tmax, occlusion)
        box = None
        if box_test:
            count(counts, "box", (state[0] >= BIG).sum() if occlusion else n)
            box = box_pass(clo[c], chi[c], o, inv, bound, tmax)
            if not bool(box.any()):
                continue
        count(counts, "prim", cluster * (n if box is None else box.sum()))
        count(counts, "rows", cluster)
        t, u, v = woop_block(wrows, c * cluster, (c + 1) * cluster, o, d,
                             tmax)
        if box is not None:
            t = torch.where(box, t, BIG)
        state = fold_block(state, t, u, v, c * cluster, occlusion)
    fold_outputs(state[0], tmax, occlusion, tmax_out, occ_out, occ_or)
    if attr_tables is None:
        return state
    return state + (winner_attrs(attr_tables, *state),)


@dataclasses.dataclass
class TriTables:
    """The scene-constant inputs of K1 and its twin."""

    cluster: int
    box_test: bool           # False: one uncullable block, no box test
    wrows: torch.Tensor      # (T, 24) Woop rows
    clo: torch.Tensor        # (C, 3) cluster boxes as walked
    chi: torch.Tensor
    tree_lo: torch.Tensor    # (M, 3) node boxes
    tree_hi: torch.Tensor
    tree_link: torch.Tensor  # (M, 3) int32, see kernel_common.build_tree
    depth: int
    one_rank: torch.Tensor | None   # (1,) int32 [0]: without box test


def tri_tables(woop_o, woop_d, cluster_lo, cluster_hi,
               cluster: int) -> TriTables:
    """Build K1's scene-constant tables: woop_o (3, 4, T); woop_d (3, 3,
    T); cluster_lo/hi (C, 3) with C * cluster == T, far point boxes (lo >
    1e29) marking clusters no ray enters. A single cluster is one block
    tested without its box (nothing to skip ahead to): a one-leaf tree.
    One host sync: the tree is built on the host."""
    T, C = woop_o.shape[2], cluster_lo.shape[0]
    if C * cluster != T:
        raise ValueError(f"{C} clusters x {cluster} != {T} triangles")
    clo, chi = cluster_lo.contiguous(), cluster_hi.contiguous()
    box_test = C > 1
    live = (~(clo[:, 0] > 1e29) if box_test
            else torch.ones((1,), dtype=torch.bool, device=clo.device))
    tree_lo, tree_hi, tree_link, depth = tree_tensors(clo, chi, live)
    return TriTables(cluster=cluster, box_test=box_test,
                     wrows=woop_rows(woop_o, woop_d), clo=clo, chi=chi,
                     tree_lo=tree_lo, tree_hi=tree_hi, tree_link=tree_link,
                     depth=depth, one_rank=None if box_test else torch.zeros(
                         (1,), dtype=I32, device=clo.device))


def hit_outputs(out, n: int, attrs: bool, device):
    """Check a triangle kernel's planned outputs: (t, idx, u, v) (N,) and,
    with attrs, the (21, N) rows."""
    shapes = [((n,), F32), ((n,), I32), ((n,), F32), ((n,), F32)]
    if attrs:
        shapes.append(((N_ATTR, n), F32))
    if len(out) != len(shapes):
        raise ValueError(f"out: {len(out)} outputs, want {len(shapes)}")
    check_args(device, **{f"out{k}": (a, *shape)
                          for k, (a, shape) in enumerate(zip(out, shapes))})


def check_tri_closest_hit(origins, dirs, tmax, tables: TriTables,
                          attr_tables=None, occlusion: bool = False,
                          counters=None, rank=None, tmax_out=None,
                          occ_out=None, occ_or: bool = False,
                          out=None) -> int:
    """`tri_closest_hit`'s argument checks (a segment plan runs them once
    on its own arguments and outputs; rank None: V1 makes it); returns the
    rays' row stride."""
    if not isinstance(tables, TriTables):
        raise TypeError("tri_closest_hit takes the mesh's prebuilt "
                        "TriTables (tri_tables)")
    rs = check_rays(origins, dirs, tmax)
    n = origins.shape[1]
    tb = tables
    T, C, M = tb.wrows.shape[0], tb.clo.shape[0], tb.tree_lo.shape[0]
    a0, a1, a2 = attr_tables if attr_tables is not None else (None,) * 3
    check_args(origins.device, wrows=(tb.wrows, (T, 24), F32),
               clo=(tb.clo, (C, 3), F32), chi=(tb.chi, (C, 3), F32),
               tree_lo=(tb.tree_lo, (M, 3), F32),
               tree_hi=(tb.tree_hi, (M, 3), F32),
               tree_link=(tb.tree_link, (M, 3), I32),
               rank=(rank if tb.box_test else tb.one_rank, (C,), I32),
               a0=(a0, (N_ATTR, T), F32), a1=(a1, (8, T), F32),
               a2=(a2, (8, T), F32), counters=(counters, (2,), torch.int64))
    check_folds(origins.device, n, occlusion, tmax_out, occ_out, occ_or)
    if out is not None:
        hit_outputs(out, n, attr_tables is not None, origins.device)
    return rs


def tri_closest_hit(origins, dirs, tmax, tables: TriTables,
                    attr_tables=None, occlusion: bool = False,
                    n_batch: int | None = None, counters=None, rank=None,
                    tmax_out=None, occ_out=None, occ_or: bool = False,
                    out=None):
    """K1 wrapper. origins/dirs: (3, N) rows, each row contiguous, at one
    row stride (a prefix of the bounce loop's state is fine); tmax: (N,);
    tables: the mesh's `tri_tables`. attr_tables: optional ((21, T), (8,
    T), (8, T)) interpolation tables. n_batch: the batch size the visit
    order averages origins over (the caller's padded batch; default N).
    counters: optional (2,) int64 CUDA tensor the kernel adds its (ray,
    box) slab tests and (ray, triangle) Woop tests to. rank: the (C,)
    int32 visit rank of the clusters (default: V1 on these rays,
    `ops.visit_kernel.visit_rank`). tmax_out: optional (N,) float32 the
    kernel writes the next kernel's tmax into; occ_out: in occlusion mode,
    an optional (N,) bool occlusion byte the kernel writes (or, with
    occ_or, ORs its hits into) (`kernel_common.fold_outputs`). out: (t,
    idx, u, v[, attrs]) from a segment plan (`kernel_common.Planned`; no
    check, no allocation). Returns (t, idx, u, v[, attrs (21, N)]) — t is
    BIG on a miss, idx int32."""
    n = origins.shape[1]
    tb = tables
    if out is None:
        rs = check_tri_closest_hit(origins, dirs, tmax, tb, attr_tables,
                                   occlusion, counters, rank, tmax_out,
                                   occ_out, occ_or)
    else:
        rs = origins.stride(0)
    if not tb.box_test:
        rank = tb.one_rank
    elif rank is None:
        rank = visit_rank(origins, n_batch or n, tb.clo, tb.chi)
    if profiling.HIT_CALLS is not None and n:
        profiling.HIT_CALLS.append(profiling.HitCall(
            "tri_closest_hit", n, attr_tables is not None,
            tmax_out is not None, occ_out is not None, bool(occ_or),
            tb.tree_lo.shape[0], rank.shape[0], 0, 0))

    if not origins.is_cuda:
        if counters is not None:
            raise ValueError("counters count the CUDA kernel's work")
        got = tri_closest_hit_plain(origins, dirs, tmax, tb.wrows, tb.clo,
                                    tb.chi, tree_rank(rank), tb.cluster,
                                    tb.box_test, attr_tables, occlusion,
                                    tmax_out=tmax_out, occ_out=occ_out,
                                    occ_or=occ_or)
        return got if out is None else fill(out, got)

    if out is None:
        f32 = dict(dtype=torch.float32, device=origins.device)
        out = (torch.empty((n,), **f32),
               torch.empty((n,), dtype=torch.int32, device=origins.device),
               torch.empty((n,), **f32), torch.empty((n,), **f32))
        if attr_tables is not None:
            out += (torch.empty((N_ATTR, n), **f32),)
    a0, a1, a2 = attr_tables if attr_tables is not None else (None,) * 3
    # the entry point refuses a tree deeper than the kernel's stack, with an
    # error that `launch` raises
    if n:
        launch("trt_tri_closest_hit", origins, dirs, tmax, n, rs, tb.wrows,
               tb.wrows.shape[0], tb.tree_lo, tb.tree_hi, tb.tree_link,
               tb.tree_lo.shape[0], tb.depth, rank, tb.cluster,
               int(tb.box_test), a0, a1, a2, int(occlusion), *out[:4],
               out[4] if attr_tables is not None else None, counters,
               tmax_out, occ_out, int(occ_or),
               stream=getattr(out, "stream", None))
    return out
