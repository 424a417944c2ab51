"""Kernel-backend closest-hit orchestration (the `closest_hit_pallas`
counterpart, the JAX package's ops/trace_kernel.py:258).

Per query:
  1. loose-triangle hoist: the scene's few spatially fat rows (a ground
     plane; `Scene.loose_tris`, compacted to the table tail by the build)
     are tested by S1 (`ops.loose_kernel.loose_hit`), their clusters get
     far boxes, and their hits tighten the triangle kernel's tmax. A
     plane-only triangle set launches no triangle kernel at all;
  2. K1 (`tri_closest_hit`) over the remaining clusters, or K5/K6
     (`tri_stream.tri_closest_hit_stream`) for meshes above
     `TRI_STREAM_MIN` triangles cut into whole 128-multiple clusters (the
     TPU route, trace_kernel.py:345-352);
  3. the triangle kernel writes the torus query's tmax (min(tmax, t); in
     any-hit mode 0 where a triangle occludes), then K2/K3
     (`torus_closest_hit`, routed as the TPU launcher routes); in any-hit
     mode each kernel also writes the query's occlusion byte, the first
     one of the query, the later ones ORing into it;
  4. the kernels' hits come out as parts (`AttrRows.base` from S1,
     `.tri_hit`, `.tor_hit`), with want_attrs beside their 21-row
     (triangle) and 15-row (torus) attribute outputs and the loose tail's
     tables. `merge_parts` merges them into a `Hit` for every caller but
     the bounce loop, whose shading kernel S2 merges them in registers
     (`closest_hit_kernel(..., merge=False)`); `ops.shade_kernel.
     shade_attrs` assembles the rows into `ShadeAttrs`. The shadow query
     (`occluded_kernel`) returns the kernels' occlusion byte.

The kernels' scene-constant tables (K1's `TriTables`, K5/K6's
`StreamTables`, K2/K3's `TorusTables`, the triangle attribute tables) are
built at a scene's first query on a device and kept in
`Scene.kernel_tables`, per geometry slice; only the visit ranks are per
segment (`segment_ranks`, the visit-rank kernel V1 once for both of a
bounce-loop segment's queries) or, for any other caller, per query. An
entry is rebuilt when a tensor it was built from changed in
place (an optimizer step on `tori.minor_radius`) or was replaced. On a
segment plan's route (`ops.segment_plan`) the segment's `Ranks` carry each
query's outputs (`QueryOut`, views of the plan's workspace): the kernels
write there and check nothing, and the query resolves no route or table.

Inside a `utils.profiling.record_segments` block each hit-kernel wrapper
(K1, K2, K3, K5/K6) appends a `utils.profiling.HitCall` for each launch
to `profiling.HIT_CALLS`, the latest segment's list (on CPU tensors, for
each call of its twin); outside one that is None and nothing is recorded.

A query on one rank's slice of the primitives (`GeomSlice` with offsets,
`parallel.sharding`) returns global indices, skips the loose hoist (the
loose tail is the whole table's), and reads its own columns of the
triangle attribute tables and its own rows of the torus materials.

The TPU path pads each batch to a 2048-ray tile; no kernel here needs the
padding, but the route between K2 and K3 and the front-to-back visit
ranks are computed on that padded size so every batch meets the contract
it meets on the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (BIG,
                                                              ray_rows,
                                                              round_up)
from toroidal_ray_tracing_tpu_torch.ops.loose_kernel import loose_hit
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import (
    TorusTables, torus_closest_hit, torus_tables, use_small_kernel)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (tri_closest_hit,
                                                           tri_tables)
from toroidal_ray_tracing_tpu_torch.ops.tri_stream import (
    TRI_STREAM_MIN, StreamTables, stream_tables, tri_closest_hit_stream)
from toroidal_ray_tracing_tpu_torch.ops.visit_kernel import visit_ranks
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


def _kept(scene: Scene, name: str, part: tuple, sources, make,
          numbers: tuple = ()):
    """The table make() builds from the tensors `sources` (and the Python
    `numbers`), kept in scene.kernel_tables[(name, device)] for the whole
    table, [(name, device, offset, size)] for a slice. The entry holds its
    source tensors (so no other tensor takes their memory while it lives)
    and is rebuilt when one of them was replaced (other memory, shape or
    strides) or changed in place since (its `_version` moved: an optimizer
    step on `tori.minor_radius`), or a number changed."""
    key = (name, scene.device, *part)
    stamp = tuple((s.data_ptr(), s.shape, s.stride(), s._version)
                  for s in sources) + (numbers,)
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


def _no_hit(n: int, dev):
    """The merged hit before any query: (t BIG, kind -1, prim 0, u 0, v 0)."""
    return (torch.full((n,), BIG, dtype=torch.float32, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev))


def merge_parts(rows: _isect.AttrRows, n: int, dev) -> _isect.Hit:
    """The merged `Hit` of a query's parts (`AttrRows.base`, `.tri_hit`,
    `.tor_hit`): the triangle kernel's hit where its t is strictly below
    the base's, then the torus kernel's where its t is strictly below that.
    Hit.attrs: the rows without the parts, with the triangle side's winner
    (`tri_kind` / `tri_prim`) where the loose tables are and no earlier
    merge set it. S2 (`csrc/shade.cu`) makes the same comparisons in
    registers."""
    t, kind, prim, u, v = (rows.base if rows.base is not None
                           else _no_hit(n, dev))
    if rows.tri_hit is not None:
        tt, ti, tu, tv = rows.tri_hit
        better = tt < t
        t, kind, prim, u, v = (torch.where(better, tt, t),
                               torch.where(better, 0, kind),
                               torch.where(better, ti + rows.tri_offset, prim),
                               torch.where(better, tu, u),
                               torch.where(better, tv, v))
    attrs = dataclasses.replace(rows, base=None, tri_hit=None, tor_hit=None)
    if rows.loose is not None and rows.tri_kind is None:
        attrs.tri_kind, attrs.tri_prim = kind, prim
    if rows.tor_hit is not None:
        kt, ki = rows.tor_hit
        better = kt < t
        t = torch.where(better, kt, t)
        kind = torch.where(better, 1, kind)
        prim = torch.where(better, ki + rows.tor_offset, prim)
    return _isect.Hit(t=t, kind=kind, prim=prim, u=u, v=v, attrs=attrs)


@dataclasses.dataclass
class _TriPlan:
    """How a query tests a geometry's triangles: the loose hoist's rows
    (S1) and the kept tables of the triangle kernel (K1, or K5/K6 when
    `stream`; None when the hoist covers every live triangle)."""

    T: int                 # the geometry's triangle rows
    off: int               # the global index of its first row
    part: tuple            # the kept tables' key: () for the whole table
    L: int                 # loose rows S1 tests (0: no hoist)
    base: int              # the loose tail's first row
    mesh: object           # TriTables / StreamTables, or None
    stream: bool


def _tri_plan(scene: Scene, geom) -> _TriPlan:
    T = geom.woop_o.shape[2]
    cs = scene.cluster_size
    n_cl = geom.cluster_lo.shape[0]
    aligned = n_cl * cs == T
    if not aligned:
        # a slice not cut on cluster boundaries: one uncullable block
        cs, n_cl = T, 1
    whole = T == scene.triangles.count
    part = () if whole else (geom.tri_offset, T)
    # the loose tail is the whole table's: a slice tests it like any other
    # cluster (its real boxes)
    L = scene.loose_tris
    n_tail = (L + cs - 1) // cs if L > 0 and aligned and whole else 0
    mesh, stream = None, False
    if n_tail != n_cl:
        # (the hoist may cover every live triangle: no K1 launch)
        stream = T > TRI_STREAM_MIN and cs % 128 == 0 and aligned
        make = stream_tables if stream else tri_tables
        mesh = _kept(scene, "stream" if stream else "tri", part,
                     (geom.woop_o, geom.woop_d, geom.cluster_lo,
                      geom.cluster_hi),
                     lambda: make(geom.woop_o, geom.woop_d,
                                  *_walked_boxes(geom, aligned, n_tail), cs))
    return _TriPlan(T=T, off=geom.tri_offset, part=part,
                    L=L if n_tail else 0, base=T - n_tail * cs, mesh=mesh,
                    stream=stream)


def _torus_tables(scene: Scene, geom):
    off, K = geom.tor_offset, geom.tor_major.shape[0]
    return _kept(scene, "torus", () if K == scene.tori.count else (off, K),
                 (geom.tor_w2o, geom.tor_major, geom.tor_minor,
                  scene.tori.mat_id, *_material_sources(scene)),
                 lambda: torus_tables(
                     geom.tor_w2o, geom.tor_major, geom.tor_minor,
                     _material_rows(scene, scene.tori.mat_id[off:off + K])
                     .contiguous()))


@dataclasses.dataclass
class _Route:
    """What a query of a geometry runs: the triangle plan (None: no
    triangles), the torus tables (None: no tori) and the torus route."""

    tri: Optional[_TriPlan]
    tor: Optional[TorusTables]
    small: bool            # K3, not K2, tests the tori


def _route(scene: Scene, geom, n_batch: int) -> _Route:
    """The route of a query of `n_batch` rays (the padded batch)."""
    has_tris, has_tori = _isect.has_prims(scene)
    tor = _torus_tables(scene, geom) if has_tori else None
    return _Route(tri=_tri_plan(scene, geom) if has_tris else None, tor=tor,
                  small=tor is not None and use_small_kernel(n_batch, tor.K))


def _kept_attr_tables(scene: Scene, plan: _TriPlan):
    """The triangle attribute tables of the geometry's rows, kept."""
    tris = scene.triangles
    off, T = plan.off, plan.T
    return _kept(
        scene, "tri_attrs", plan.part,
        (tris.v0, tris.e1, tris.e2, tris.n0, tris.n1, tris.n2,
         tris.uv0, tris.uv1, tris.uv2, tris.mat_id,
         *_material_sources(scene)),
        lambda: tuple(a[:, off:off + T].contiguous()
                      for a in _tri_attr_tables(scene)))


@dataclasses.dataclass
class QueryOut:
    """One query's outputs at a segment plan's bucket (`ops.segment_plan`):
    each kernel's `out` (`kernel_common.Planned`, None where the route runs
    no such kernel), the triangle kernel's next tmax, the occlusion byte
    (any-hit), the triangle attribute tables, and the `AttrRows` those
    views make up (the parts; the closest query's attribute rows and loose
    tables too), which the query returns as the default route would."""

    s1: Optional[tuple]
    tri: Optional[tuple]
    tor: Optional[tuple]
    tmax_next: Optional[torch.Tensor]
    occ: Optional[torch.Tensor]
    tables: Optional[tuple]
    rows: Optional[_isect.AttrRows]


@dataclasses.dataclass
class Ranks:
    """A segment's route and visit ranks (`segment_ranks`), for both of its
    queries: the rank of each box set they walk (None: a set no query
    walks); on a segment plan's route, also each query's outputs
    (closest, any-hit)."""

    route: _Route
    tri: Optional[torch.Tensor]      # K1's clusters or K5's superblocks
    tor: Optional[torch.Tensor]      # K2's chunks
    out: Optional[tuple] = None      # (QueryOut, QueryOut) from a plan


def segment_ranks(scene: Scene, geom, origins, n_batch: int,
                  lanes: int) -> Ranks:
    """The route and visit ranks of a bounce-loop segment, decided once for
    both of its queries of `lanes` rays: V1 (`ops.visit_kernel.
    visit_ranks`, one launch on the card) from the anchor of the (3, L)
    origin rows `origins` (the loop's whole state, divided by `n_batch`)
    over the sets the route walks: K1's cluster boxes (where it tests them)
    or K5's superblocks, and K2's chunk boxes where K2, not K3, is the
    torus route. No set, no launch."""
    route = _route(scene, geom, round_up(max(lanes, 1), RAY_TILE))
    tri = tor = None
    mesh = route.tri.mesh if route.tri is not None else None
    if isinstance(mesh, StreamTables):
        tri = (mesh.sb_lo, mesh.sb_hi)
    elif mesh is not None and mesh.box_test:
        tri = (mesh.clo, mesh.chi)
    if route.tor is not None and not route.small:
        tor = (route.tor.clo, route.tor.chi)
    sets = [s for s in (tri, tor) if s is not None]
    ranks = iter(visit_ranks(origins, n_batch, sets)[1] if sets else ())
    return Ranks(route=route, tri=next(ranks) if tri else None,
                 tor=next(ranks) if tor else None)


def _query(scene: Scene, geom, origins, dirs, tmax, want_attrs: bool,
           occlusion: bool, ranks: Optional[Ranks]):
    """Run a query's kernels, each on the tmax the earlier ones left: S1
    (the loose hoist), K1/K5, K2/K3. Each kernel writes the next one's tmax
    and, in occlusion mode, the query's occlusion byte (the first kernel
    writes it, the later ones OR into it). ranks: the segment's route and
    visit ranks (None: the query decides its route, and each tree kernel
    ranks its own set), and on a segment plan's route the outputs each
    kernel writes (`Ranks.out`). Rays whose rows are contiguous at one
    stride (a prefix of the bounce loop's state) go to the kernels as they
    are, others as contiguous copies (`kernel_common.ray_rows`). Returns
    (rows, occ): the parts unmerged in an `AttrRows` (with the kernels'
    attribute rows and the loose tables where want_attrs), and in
    occlusion mode the (N,) occlusion byte (else None)."""
    n = origins.shape[1]
    dev = origins.device
    n_batch = round_up(max(n, 1), RAY_TILE)
    route = ranks.route if ranks is not None else _route(scene, geom, n_batch)
    q = ranks.out[occlusion] if ranks is not None and ranks.out else None
    if q is None:
        origins, dirs = ray_rows(origins, dirs)
    rows = _isect.AttrRows() if q is None else q.rows
    tri_tmax = tmax   # the next kernel's tmax: below every hit so far
    occ = None
    if occlusion:
        occ = (q.occ if q is not None
               else torch.empty((n,), dtype=torch.bool, device=dev))
    first = True      # no kernel wrote occ yet

    plan, tor = route.tri, route.tor
    if plan is not None:
        off = plan.off
        tables = None
        if want_attrs:
            tables = (q.tables if q is not None
                      else _kept_attr_tables(scene, plan))

        # S1 writes the base hit the triangle kernels start from and their
        # tmax (0 where it occludes)
        if plan.L:
            *hit, tri_tmax = loose_hit(origins, dirs, tmax, geom.woop_o,
                                       geom.woop_d, plan.base, plan.L,
                                       plan.base + off, occlusion,
                                       occ_out=occ,
                                       out=q.s1 if q is not None else None)
            first = False
            if q is None:
                rows.base = tuple(hit)
                if want_attrs:
                    rows.loose, rows.loose_base, rows.n_loose = (
                        tables, plan.base, plan.L)

        if plan.mesh is not None:
            # the torus query's tmax comes out of the triangle kernel (S1's
            # hit is in the tmax it starts from)
            nxt = None
            if tor is not None:
                nxt = (q.tmax_next if q is not None else
                       torch.empty((n,), dtype=torch.float32, device=dev))
            hit_fn = (tri_closest_hit_stream if plan.stream
                      else tri_closest_hit)
            out = hit_fn(origins, dirs, tri_tmax, plan.mesh,
                         attr_tables=tables, occlusion=occlusion,
                         n_batch=n_batch,
                         rank=ranks.tri if ranks is not None else None,
                         tmax_out=nxt, occ_out=occ,
                         occ_or=occlusion and not first,
                         out=q.tri if q is not None else None)
            first = False
            if q is None:
                rows.tri_hit, rows.tri_offset = tuple(out[:4]), off
                if want_attrs:
                    rows.tri = out[4]
            if tor is not None:
                tri_tmax = nxt

    if tor is not None:
        out = torus_closest_hit(origins, dirs, tri_tmax, tor,
                                want_attrs=want_attrs, occlusion=occlusion,
                                n_batch=n_batch, small=route.small,
                                rank=ranks.tor if ranks is not None else None,
                                occ_out=occ, occ_or=occlusion and not first,
                                out=q.tor if q is not None else None)
        first = False
        if q is None:
            rows.tor_hit, rows.tor_offset = tuple(out[:2]), geom.tor_offset
            if want_attrs:
                rows.tor = out[2]
    if occlusion and first:
        occ.zero_()    # no primitive to occlude
    return rows, occ


def closest_hit_kernel(scene: Scene, geom, origins, dirs, tmax,
                       want_attrs: bool = False, occlusion: bool = False,
                       ranks: Optional[Ranks] = None, merge: bool = True):
    """Closest hit through the kernels. origins/dirs: (3, N) rows; tmax
    (N,). want_attrs: emit Hit.attrs, the kernels' raw `AttrRows`.
    occlusion: any-hit (only Hit.kind >= 0 is meaningful). ranks: the tree
    kernels' visit ranks (`segment_ranks`; default: each kernel ranks its
    set from the batch's mean origin). merge=False (with want_attrs): the
    parts unmerged in Hit.attrs, what S2 reads, and Hit's own fields None;
    `merge_parts` merges them."""
    if want_attrs and occlusion:
        raise ValueError("want_attrs and occlusion are exclusive")
    if not merge and not want_attrs:
        raise ValueError("merge=False hands the parts to S2: want_attrs")
    rows, _ = _query(scene, geom, origins, dirs, tmax, want_attrs,
                     occlusion, ranks)
    if not merge:
        return _isect.Hit(t=None, kind=None, prim=None, u=None, v=None,
                          attrs=rows)
    hit = merge_parts(rows, origins.shape[1], origins.device)
    if not want_attrs:
        hit.attrs = None
    return hit


def occluded_kernel(scene: Scene, geom, origins, dirs, tmax,
                    ranks: Optional[Ranks] = None):
    """The any-hit query through the kernels: the (N,) bool mask of the rays
    a primitive occludes, the occlusion byte its kernels write (equal to
    `closest_hit_kernel(..., occlusion=True).kind >= 0` on every lane)."""
    return _query(scene, geom, origins, dirs, tmax, False, True, ranks)[1]
