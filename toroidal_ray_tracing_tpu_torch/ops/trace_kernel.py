"""Kernel-backend closest-hit orchestration (the `closest_hit_pallas`
counterpart, the JAX package's ops/trace_kernel.py:258).

Per query:
  1. loose-triangle hoist: the scene's few spatially fat rows (a ground
     plane; `Scene.loose_tris`, compacted to the table tail by the build)
     are tested densely in plain torch, their clusters get far boxes, and
     their hits tighten the triangle kernel's tmax. A plane-only triangle
     set launches no triangle kernel at all;
  2. K1 (`tri_closest_hit`) over the remaining clusters, or K5/K6
     (`tri_stream.tri_closest_hit_stream`) for meshes above
     `TRI_STREAM_MIN` triangles cut into whole 128-multiple clusters (the
     TPU route, trace_kernel.py:345-352);
  3. triangle hits fold into the torus query's tmax, then K2/K3
     (`torus_closest_hit`, routed as the TPU launcher routes);
  4. with want_attrs, the kernels' 21-row (triangle) and 15-row (torus)
     attribute outputs assemble into `ShadeAttrs`.

The kernels' scene-constant tables (K1's `TriTables`, K5/K6's
`StreamTables`, K2/K3's `TorusTables`, the triangle attribute tables) are
built at a scene's first query on a device and kept in
`Scene.kernel_tables`, per geometry slice; only the visit ranks are per
query. An entry is rebuilt when a tensor it was built from changed in
place (an optimizer step on `tori.minor_radius`) or was replaced.

A query on one rank's slice of the primitives (`GeomSlice` with offsets,
`parallel.sharding`) returns global indices, skips the loose hoist (the
loose tail is the whole table's), and reads its own columns of the
triangle attribute tables and its own rows of the torus materials.

The TPU path pads each batch to a 2048-ray tile; no kernel here needs the
padding, but the route between K2 and K3 and the front-to-back visit
orders are computed on that padded size so every batch meets the contract
it meets on the TPU.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import BIG, TMIN, round_up
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import (
    torus_closest_hit, torus_tables)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (tri_closest_hit,
                                                           tri_tables)
from toroidal_ray_tracing_tpu_torch.ops.tri_stream import (
    TRI_STREAM_MIN, stream_tables, tri_closest_hit_stream)
from toroidal_ray_tracing_tpu_torch.scene.types import Scene
from toroidal_ray_tracing_tpu_torch.trace import intersect as _isect

RAY_TILE = 2048          # the TPU orchestrator's batch padding


def _material_rows(scene: Scene, mat_id):
    """Per-primitive baked material table (P, 12):
    [ambient(3), diffuse(3), specular(3), shininess, illum, texture_id]."""
    mats = scene.materials
    m = mat_id.long()
    return torch.cat([
        mats.ambient[m], mats.diffuse[m], mats.specular[m],
        mats.shininess[m][:, None],
        mats.illum[m].float()[:, None],
        mats.texture_id[m].float()[:, None],
    ], dim=1)


def _tri_attr_tables(scene: Scene):
    """((21, T), (8, T), (8, T)) interpolation tables:
    attr = A0[p] + u*A1[p] + v*A2[p]. Rows 0-7 are [pos, nrm, uv]; rows
    8-19 the baked material; row 20 the uv texel density (mip LOD)."""
    tris = scene.triangles
    duv1 = tris.uv1 - tris.uv0
    duv2 = tris.uv2 - tris.uv0
    uv_area = (duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]).abs()
    world_area = torch.linalg.vector_norm(
        torch.linalg.cross(tris.e1, tris.e2, dim=-1), dim=-1)
    density = torch.sqrt(uv_area / torch.clamp(world_area, min=1e-30))
    a0 = torch.cat([tris.v0, tris.n0, tris.uv0,
                    _material_rows(scene, tris.mat_id), density[:, None]],
                   dim=1).T
    a1 = torch.cat([tris.e1, tris.n1 - tris.n0, tris.uv1 - tris.uv0], dim=1).T
    a2 = torch.cat([tris.e2, tris.n2 - tris.n0, tris.uv2 - tris.uv0], dim=1).T
    return a0.contiguous(), a1.contiguous(), a2.contiguous()


def _kept(scene: Scene, name: str, part: tuple, sources, make):
    """The table make() builds from the tensors `sources`, kept in
    scene.kernel_tables[(name, device)] for the whole table, [(name,
    device, offset, size)] for a slice. The entry holds its source tensors
    (so no other tensor takes their memory while it lives) and is rebuilt
    when one of them was replaced (other memory, shape or strides) or
    changed in place since (its `_version` moved: an optimizer step on
    `tori.minor_radius`)."""
    key = (name, scene.device, *part)
    stamp = tuple((s.data_ptr(), s.shape, s.stride(), s._version)
                  for s in sources)
    entry = scene.kernel_tables.get(key)
    if entry is None or entry[0] != stamp:
        entry = (stamp, tuple(sources), make())
        scene.kernel_tables[key] = entry
    return entry[2]


def _material_sources(scene: Scene):
    m = scene.materials
    return (m.ambient, m.diffuse, m.specular, m.shininess, m.illum,
            m.texture_id)


def _walked_boxes(geom, aligned: bool, n_tail: int):
    """The cluster boxes the triangle kernels walk: the hoisted loose tail's
    n_tail clusters get far point boxes (no ray enters them); a slice not
    cut on cluster boundaries is one block with an all-space box."""
    dev = geom.cluster_lo.device
    if not aligned:
        return (torch.full((1, 3), -3e38, device=dev),
                torch.full((1, 3), 3e38, device=dev))
    n_cl = geom.cluster_lo.shape[0]
    far = torch.full((n_tail, 3), 2.0e38, device=dev)
    return (torch.cat([geom.cluster_lo[:n_cl - n_tail], far]).contiguous(),
            torch.cat([geom.cluster_hi[:n_cl - n_tail], far]).contiguous())


def _loose_tri_hit(origins, dirs, tmax, woop_o, woop_d, base: int, L: int):
    """Dense closest hit over the loose tail rows [base, base+L): the Woop
    test as (L, N) tensors, the lowest row winning ties."""
    n = origins.shape[1]
    oh = torch.cat([origins, origins.new_ones((1, n))], dim=0)       # (4, N)
    wo = woop_o[:, :, base:base + L]
    wd = woop_d[:, :, base:base + L]
    hp = torch.einsum("kal,an->kln", wo, oh)                        # (3, L, N)
    dp = torch.einsum("kal,an->kln", wd, dirs)
    dz = dp[2]
    dz_ok = dz.abs() > 1e-12
    inv = torch.where(dz_ok, 1.0, 0.0) / torch.where(dz_ok, dz, 1.0)
    t = -hp[2] * inv
    uu = hp[0] + t * dp[0]
    vv = hp[1] + t * dp[1]
    ok = dz_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) \
        & (t >= TMIN) & (t <= tmax[None, :])
    t = torch.where(ok, t, BIG)
    tb = t.amin(dim=0)
    rows = torch.arange(L, dtype=torch.int32, device=origins.device)[:, None]
    idx = torch.where(t <= tb[None, :], rows, L).amin(dim=0)
    idx = torch.clamp(idx, max=L - 1)
    pick = rows == idx[None, :]
    miss = tb >= BIG
    ub = torch.where(miss, 0.0, torch.where(pick, uu, 0.0).sum(dim=0))
    vb = torch.where(miss, 0.0, torch.where(pick, vv, 0.0).sum(dim=0))
    return tb, idx, ub, vb


def _loose_attr(tables, base: int, L: int, idx, u_, v_, hit):
    """(21, N) interpolated attrs of the loose-prepass winners, as one-hot
    products (the JAX package's formulation, full float32)."""
    a0, a1, a2 = (a[:, base:base + L] for a in tables)
    rows = torch.arange(L, dtype=torch.int32, device=idx.device)[:, None]
    onehot = ((idx[None, :] == rows) & hit[None, :]).float()         # (L, N)
    A0 = torch.einsum("al,ln->an", a0, onehot)
    A1 = torch.einsum("al,ln->an", a1, onehot)
    A2 = torch.einsum("al,ln->an", a2, onehot)
    top = A0[:8] + u_[None, :] * A1 + v_[None, :] * A2
    return torch.cat([top, A0[8:]], dim=0)


def closest_hit_kernel(scene: Scene, geom, origins, dirs, tmax,
                       want_attrs: bool = False, occlusion: bool = False,
                       anchor=None):
    """Closest hit through the kernels. origins/dirs: (3, N) rows; tmax
    (N,). want_attrs: emit Hit.attrs. occlusion: any-hit (only
    Hit.kind >= 0 is meaningful). anchor: the (3,) point the tree kernels'
    visit orders start from (default: the batch's mean origin)."""
    if want_attrs and occlusion:
        raise ValueError("want_attrs and occlusion are exclusive")
    origins = origins.contiguous()
    dirs = dirs.contiguous()
    n = origins.shape[1]
    n_batch = round_up(max(n, 1), RAY_TILE)
    dev = origins.device
    has_tris, has_tori = _isect.has_prims(scene)

    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    kind = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prim = torch.zeros((n,), dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    tri_attr = tor_attr = None

    if has_tris:
        T = geom.woop_o.shape[2]
        cs = scene.cluster_size
        n_cl = geom.cluster_lo.shape[0]
        aligned = n_cl * cs == T
        if not aligned:
            # a slice not cut on cluster boundaries: one uncullable block
            cs, n_cl = T, 1
        off = geom.tri_offset
        whole = T == scene.triangles.count
        part = () if whole else (off, T)
        tables = None
        if want_attrs:
            tris = scene.triangles
            tables = _kept(
                scene, "tri_attrs", part,
                (tris.v0, tris.e1, tris.e2, tris.n0, tris.n1, tris.n2,
                 tris.uv0, tris.uv1, tris.uv2, tris.mat_id,
                 *_material_sources(scene)),
                lambda: tuple(a[:, off:off + T].contiguous()
                              for a in _tri_attr_tables(scene)))

        # the loose tail is the whole table's: a slice tests it like any
        # other cluster (its real boxes)
        L = scene.loose_tris
        n_tail = (L + cs - 1) // cs if L > 0 and aligned and whole else 0
        tri_tmax = tmax
        loose_attr = None
        if n_tail:
            base = T - n_tail * cs
            lt, lidx, lu, lv = _loose_tri_hit(origins, dirs, tmax,
                                              geom.woop_o, geom.woop_d,
                                              base, L)
            lhit = lt < BIG
            t_best = torch.where(lhit, lt, t_best)
            kind = torch.where(lhit, 0, kind)
            prim = torch.where(lhit, base + lidx + off, prim)
            u = torch.where(lhit, lu, u)
            v = torch.where(lhit, lv, v)
            if want_attrs:
                loose_attr = _loose_attr(tables, base, L, lidx, lu, lv, lhit)
            tri_tmax = (torch.where(lhit, 0.0, tmax) if occlusion
                        else torch.minimum(tmax, lt))

        if n_tail and n_tail == n_cl:
            # the hoist covered every live triangle: no K1 launch at all
            tri_attr = loose_attr
        else:
            kw = dict(attr_tables=tables, occlusion=occlusion,
                      n_batch=n_batch, anchor=anchor)
            stream = T > TRI_STREAM_MIN and cs % 128 == 0 and aligned
            make = stream_tables if stream else tri_tables
            mesh = _kept(scene, "stream" if stream else "tri", part,
                         (geom.woop_o, geom.woop_d, geom.cluster_lo,
                          geom.cluster_hi),
                         lambda: make(geom.woop_o, geom.woop_d,
                                      *_walked_boxes(geom, aligned, n_tail),
                                      cs))
            hit_fn = tri_closest_hit_stream if stream else tri_closest_hit
            out = hit_fn(origins, dirs, tri_tmax, mesh, **kw)
            tt, ti, tu, tv = out[:4]
            better = tt < t_best
            if want_attrs:
                tri_attr = out[4]
                if loose_attr is not None:
                    tri_attr = torch.where(better[None, :], tri_attr,
                                           loose_attr)
            t_best = torch.where(better, tt, t_best)
            kind = torch.where(better, 0, kind)
            prim = torch.where(better, ti + off, prim)
            u = torch.where(better, tu, u)
            v = torch.where(better, tv, v)

    if has_tori:
        off, K = geom.tor_offset, geom.tor_major.shape[0]
        tor = _kept(scene, "torus",
                    () if K == scene.tori.count else (off, K),
                    (geom.tor_w2o, geom.tor_major, geom.tor_minor,
                     scene.tori.mat_id, *_material_sources(scene)),
                    lambda: torus_tables(
                        geom.tor_w2o, geom.tor_major, geom.tor_minor,
                        _material_rows(scene, scene.tori.mat_id[off:off + K])
                        .contiguous()))
        # fold triangle hits into the torus query's tmax
        if has_tris and occlusion:
            tor_tmax = torch.where(t_best < BIG, 0.0, tmax)
        elif has_tris:
            tor_tmax = torch.minimum(tmax, t_best)
        else:
            tor_tmax = tmax
        out = torus_closest_hit(origins, dirs, tor_tmax.contiguous(), tor,
                                want_attrs=want_attrs, occlusion=occlusion,
                                n_batch=n_batch, anchor=anchor)
        kt, ki = out[:2]
        if want_attrs:
            tor_attr = out[2]
        better = kt < t_best
        t_best = torch.where(better, kt, t_best)
        kind = torch.where(better, 1, kind)
        prim = torch.where(better, ki + off, prim)

    attrs = None
    if want_attrs:
        is_tor = kind == 1
        if tri_attr is None:
            tri_attr = torch.zeros((21, n), dtype=torch.float32, device=dev)
        if tor_attr is None:
            tor_attr = torch.zeros((15, n), dtype=torch.float32, device=dev)
        # torus world positions are o + t d (shade computes them); the pos
        # rows carry the triangle's barycentric-exact position only
        nrm = torch.where(is_tor, tor_attr[0:3], tri_attr[3:6])
        mat = torch.where(is_tor, tor_attr[3:15], tri_attr[8:20])
        attrs = _isect.ShadeAttrs(
            pos=tri_attr[0:3],
            nrm=nrm,
            uv=tri_attr[6:8],
            ambient=mat[0:3],
            diffuse=mat[3:6],
            specular=mat[6:9],
            shininess=mat[9],
            illum=torch.round(mat[10]).to(torch.int32),
            texture_id=torch.round(mat[11]).to(torch.int32),
            tex_density=torch.where(is_tor, 0.0, tri_attr[20]),
        )
    return _isect.Hit(t=t_best, kind=kind, prim=prim, u=u, v=v, attrs=attrs)
