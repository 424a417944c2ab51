"""The bounce loop's segment plan: each segment's launches with their checks,
routes and outputs settled once.

A kernel-backend segment (`trace.wavefront.trace_state`) is V1, the closest
query (S1, K1/K5, K2/K3), S2, K4 on textured scenes, the any-hit query and
S3, each through its wrapper. Called on its own, a wrapper checks every
argument, allocates every output, and the query resolves its route and
kept tables: tens of microseconds of host time a launch, which the device
spends idle on a host-paced frame.

`segment_plan` builds a `SegmentPlan` for a loop of `lanes` (its bucket
sizes, `wavefront.bucket_sizes`) once and keeps it on the scene, one a
device and stream (`Scene.kernel_tables`, as the kernel tables are kept;
a loop of other lanes, or after the tables changed, replaces it). Loops
of one scene on one stream run one after another on the device, so they
can share its workspace; a loop on another stream gets its own. It
holds:

* each bucket's route (K2 or K3 by the bucket's size), the scene's tables
  and V1's box sets;
* one workspace (`Workspace`): every output a wrapper writes is a region
  sized for `lanes`, and a bucket of nb lanes takes each region's
  contiguous prefix as a (rows, nb) view. The any-hit query writes into the
  closest query's views (S2 has read them by then); S2's outputs, the
  occlusion byte and K4's words have their own regions;
* the loop's tmax row: S3 writes the next segment's where it updates a ray
  and G1 where it moves one (`kernel_common.SEG_TMAX` where active, else
  0), so between V1 and S3 no ATen operation runs;
* the raw stream handle every launch goes on.

The constructor runs each wrapper's checks on the arguments and views it
will hand the wrapper; the wrappers, handed the views (`out=`,
`kernel_common.Planned`), check and allocate nothing. The K1 and K2 calls
still go through `ops.trace_kernel.tri_closest_hit` and
`ops.torus_kernel.torus_closest_hit_chunked`, one call a launch. On CPU
tensors the wrappers run their twins and copy the results into the views.

`COUNTERS["plan_builds"]` counts the plans built, `["plan_segments"]` the
segments run from one (`utils.profiling`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from toroidal_ray_tracing_tpu_torch.ops import (loose_kernel, shade_kernel,
                                                tex_kernel, torus_kernel,
                                                tri_kernel, tri_stream,
                                                visit_kernel)
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    F32, I32, SEG_TMAX, Planned, check_args, round_up)
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import use_small_kernel
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
    RAY_TILE, QueryOut, Ranks, _kept_attr_tables, _Route, _route)
from toroidal_ray_tracing_tpu_torch.ops.tri_stream import StreamTables
from toroidal_ray_tracing_tpu_torch.scene.types import Scene
from toroidal_ray_tracing_tpu_torch.trace import intersect as _isect
from toroidal_ray_tracing_tpu_torch.utils.profiling import COUNTERS

ALIGN = 256          # bytes: each region starts on a 256-B boundary
N_TOR_ATTR = torus_kernel.N_ATTR


def _small(tor, nb: int) -> bool:
    """Whether K3, not K2, tests the tori of a bucket of nb lanes (the TPU
    launcher's route on the padded bucket)."""
    return tor is not None and use_small_kernel(
        round_up(max(nb, 1), RAY_TILE), tor.K)


class Workspace:
    """One flat device buffer of regions, each sized for `lanes` lanes:
    `add(rows, dtype)` reserves (rows, lanes) (rows None: (lanes,)), then
    `allocate()` makes the buffer and `view(region, nb)` gives a region's
    contiguous (rows, nb) prefix. `fixed(shape, dtype)` reserves a region
    of one shape (V1's anchor, ranks and scratch)."""

    def __init__(self, lanes: int, device):
        self.lanes, self.device = lanes, device
        self.size = 0
        self.buffer = None

    def _reserve(self, nbytes: int) -> int:
        off = self.size
        self.size += round_up(max(nbytes, 1), ALIGN)
        return off

    def add(self, rows, dtype) -> tuple:
        return (self._reserve((rows or 1) * self.lanes * dtype.itemsize),
                rows, dtype)

    def fixed(self, shape: tuple, dtype) -> tuple:
        return (self._reserve(math.prod(shape) * dtype.itemsize), shape,
                dtype)

    def allocate(self) -> None:
        self.buffer = torch.empty((self.size,), dtype=torch.uint8,
                                  device=self.device)

    def view(self, region: tuple, nb: Optional[int] = None):
        off, rows, dtype = region
        if nb is None:           # a fixed region
            shape = rows
        else:
            shape = (nb,) if rows is None else (rows, nb)
        nbytes = math.prod(shape) * dtype.itemsize
        return self.buffer[off:off + nbytes].view(dtype).view(shape)


@dataclasses.dataclass
class Bucket:
    """A bucket's launches: the segment's `Ranks` (route, the rank views,
    each query's `QueryOut`), V1's box sets and outputs, S2's, K4's and
    S3's outputs."""

    ranks: Ranks
    sets: list
    v1: Planned
    s2: Planned
    k4: Optional[Planned]
    s3: Planned


class SegmentPlan:
    """A loop's launches at each of its bucket sizes (the module's
    docstring). Built by `segment_plan`."""

    def __init__(self, scene: Scene, geom, route: _Route, tables, sizes,
                 state, active, params, stream):
        dev = state.device
        lanes = sizes[0]
        self.sizes = tuple(sizes)
        self.geom, self.route, self.tables = geom, route, tables
        self.atlas = params.atlas
        self.params = params
        tri, tor = route.tri, route.tor
        mesh = tri.mesh if tri is not None else None
        loose = tri is not None and tri.L > 0

        ws = Workspace(lanes, dev)
        tmax = ws.add(None, F32)
        spans = ws.fixed((-(-lanes // 128),), torch.bool)  # S3's, G1 reads
        s1 = ([ws.add(None, t) for t in (F32, I32, I32, F32, F32, F32)]
              if loose else None)
        k1 = ([ws.add(None, t) for t in (F32, I32, F32, F32)]
              + [ws.add(tri_kernel.N_ATTR, F32)] if mesh is not None
              else None)
        tnext = ws.add(None, F32) if mesh is not None and tor else None
        k2 = ([ws.add(None, F32), ws.add(None, I32),
               ws.add(N_TOR_ATTR, F32)] if tor is not None else None)
        s2 = [ws.add(3, F32), ws.add(3, F32), ws.add(None, F32),
              ws.add(shade_kernel.N_BLOCK, F32), ws.add(None, torch.uint8)]
        if self.atlas is not None:
            s2 += [ws.add(None, I32), ws.add(None, I32),
                   ws.add(None, torch.bool)]
        k4 = ([ws.add(3, I32), ws.add(3, I32)] if self.atlas is not None
              else None)
        occ = ws.add(None, torch.bool)
        # V1: the anchor and each set's rank (the same for every bucket)
        tri_set = None
        if isinstance(mesh, StreamTables):
            tri_set = (mesh.sb_lo, mesh.sb_hi)
        elif mesh is not None and mesh.box_test:
            tri_set = (mesh.clo, mesh.chi)
        tor_set = (tor.clo, tor.chi) if tor is not None else None
        anchor = ws.fixed((3,), F32)
        rank_tri = (ws.fixed((tri_set[0].shape[0],), I32) if tri_set
                    else None)
        rank_tor = (ws.fixed((tor_set[0].shape[0],), I32) if tor_set
                    else None)
        ws.allocate()
        self.tmax = ws.view(tmax, lanes)
        self.spans = ws.view(spans)
        self.rank_views = (ws.view(anchor),
                           ws.view(rank_tri) if rank_tri else None,
                           ws.view(rank_tor) if rank_tor else None)

        def planned(regions, nb, count=None):
            if regions is None:
                return None
            views = [ws.view(r, nb) for r in regions[:count]]
            return Planned(views, stream)

        self.buckets = {}
        for nb in self.sizes:
            small = _small(tor, nb)
            sets, rank_out = [], [self.rank_views[0]]
            if tri_set is not None:
                sets.append(tri_set)
                rank_out.append(self.rank_views[1])
            if tor_set is not None and not small:
                sets.append(tor_set)
                rank_out.append(self.rank_views[2])
            v1 = (visit_kernel.planned_outputs(sets, dev, stream,
                                               tuple(rank_out))
                  if sets else None)
            closest = QueryOut(
                s1=planned(s1, nb), tri=planned(k1, nb),
                tor=planned(k2, nb),
                tmax_next=ws.view(tnext, nb) if tnext else None, occ=None,
                tables=tables, rows=None)
            closest.rows = _isect.AttrRows(
                tri=closest.tri[4] if k1 else None,
                tor=closest.tor[2] if k2 else None,
                loose=tables if loose else None,
                loose_base=tri.base if loose else 0,
                n_loose=tri.L if loose else 0,
                base=tuple(closest.s1[:5]) if loose else None,
                tri_hit=tuple(closest.tri[:4]) if k1 else None,
                tri_offset=tri.off if k1 else 0,
                tor_hit=tuple(closest.tor[:2]) if k2 else None,
                tor_offset=geom.tor_offset if k2 else 0)
            shadow = QueryOut(
                s1=closest.s1, tri=planned(k1, nb, 4),
                tor=planned(k2, nb, 2), tmax_next=closest.tmax_next,
                occ=ws.view(occ, nb), tables=None, rows=None)
            shadow.rows = _isect.AttrRows(
                base=closest.rows.base, tri_hit=closest.rows.tri_hit,
                tri_offset=closest.rows.tri_offset,
                tor_hit=closest.rows.tor_hit,
                tor_offset=closest.rows.tor_offset)
            ranks = Ranks(
                route=_Route(tri=tri, tor=tor, small=small),
                tri=self.rank_views[1] if tri_set is not None else None,
                tor=(self.rank_views[2] if tor_set is not None and not small
                     else None),
                out=(closest, shadow))
            self.buckets[nb] = Bucket(
                ranks=ranks, sets=sets, v1=v1,
                s2=planned(s2, nb), k4=planned(k4, nb),
                s3=Planned((self.tmax,), stream))
        self._check(state, active, params)

    def _check(self, state, active, params) -> None:
        """Each wrapper's checks on the arguments and views the plan hands
        it, at every bucket, with the building loop's state and shading
        constants (`start` checks a later loop's)."""
        dev = state.device
        lanes = self.sizes[0]
        check_args(dev, state=(state, (15, lanes), F32),
                   active=(active, (lanes,), torch.bool))
        tri, tor, geom = self.route.tri, self.route.tor, self.geom
        tally = torch.zeros((3,), dtype=I32, device=dev)
        rays, count = tally[:2].view(torch.int64)[0], tally[2]
        for nb, b in self.buckets.items():
            o, d = state[0:3, :nb], state[3:6, :nb]
            tmax = self.tmax[:nb]
            if b.v1 is not None:
                visit_kernel.check_visit_ranks(state[0:3], 1, b.sets)
            sr = shade_kernel._shade_rays(b.s2)
            closest, shadow = b.ranks.out
            for q, (qo, qd, qt) in ((closest, (o, d, tmax)),
                                    (shadow, (sr.shadow_o, sr.shadow_d,
                                              sr.shadow_tmax))):
                occlusion = q is shadow
                first = True
                t = qt
                if tri is not None and tri.L:
                    loose_kernel.check_loose_hit(
                        qo, qd, t, geom.woop_o, geom.woop_d, tri.base,
                        tri.L, occlusion, q.occ, out=q.s1)
                    t, first = q.s1[5], False
                if tri is not None and tri.mesh is not None:
                    check = (tri_stream.check_tri_closest_hit_stream
                             if tri.stream
                             else tri_kernel.check_tri_closest_hit)
                    check(qo, qd, t, tri.mesh, q.tables, occlusion, None,
                          b.ranks.tri, q.tmax_next, q.occ,
                          occlusion and not first, out=q.tri)
                    first = False
                    if tor is not None:
                        t = q.tmax_next
                if tor is not None:
                    if b.ranks.route.small:
                        torus_kernel.check_torus_closest_hit_small(
                            qo, qd, t, tor, not occlusion, occlusion, None,
                            q.occ, occlusion and not first, out=q.tor)
                    else:
                        torus_kernel.check_torus_closest_hit_chunked(
                            qo, qd, t, tor, not occlusion, occlusion, None,
                            b.ranks.tor, q.occ, occlusion and not first,
                            out=q.tor)
            shade_kernel.check_shade_hit(o, d, closest.rows, params,
                                         out=b.s2)
            quads = None
            if b.k4 is not None:
                tex_kernel.check_quad_gather(self.atlas.data4q, *sr.tex,
                                             out=b.k4)
                quads = tuple(b.k4)
            shade_kernel.check_shade_finish(state, active, nb, sr,
                                            shadow.occ, quads, params, rays,
                                            self.spans, count, out=b.s3)

    def fits(self, sizes, geom, route: _Route, tables, params) -> bool:
        """Whether this plan runs a loop of these bucket sizes over these
        tables (the route `_route` gives now: the kept tables are rebuilt
        when a scene tensor changed) on each bucket's torus route."""
        mine, now = self.route.tri, route.tri
        same_tri = (mine is None) == (now is None) and (
            mine is None or (mine.mesh is now.mesh and mine.L == now.L
                             and mine.base == now.base
                             and mine.off == now.off
                             and mine.stream == now.stream))
        g, h = self.geom, geom
        smalls = [b.ranks.route.small for b in self.buckets.values()]
        return (self.sizes == tuple(sizes) and same_tri
                and self.route.tor is route.tor
                and smalls == [_small(route.tor, nb) for nb in self.sizes]
                and self.tables is tables
                and g.woop_o is h.woop_o and g.woop_d is h.woop_d
                and g.tor_offset == h.tor_offset
                and (self.atlas is None) == (params.atlas is None)
                and (self.atlas is None
                     or self.atlas.data4q is params.atlas.data4q))

    def ranks(self, state, bucket: Bucket, n_batch: int) -> Ranks:
        """V1 into the bucket's rank views from the anchor of the whole
        state's origin rows (`trace_kernel.segment_ranks`); returns the
        bucket's `Ranks`."""
        if bucket.v1 is not None:
            visit_kernel.visit_ranks(state[0:3], n_batch, bucket.sets,
                                     out=bucket.v1)
        return bucket.ranks

    def start(self, state, active, params) -> None:
        """A loop's start: the state's layout, the shading constants'
        tensors (once a `ShadeParams`: S2's and S3's checks of them) and
        segment 0's tmax row (SEG_TMAX where active, else 0: one operation
        a loop)."""
        dev = state.device
        lanes = self.sizes[0]
        check_args(dev, state=(state, (15, lanes), F32),
                   active=(active, (lanes,), torch.bool))
        if params is not self.params:
            check_args(dev, consts=(params.consts, (9,), F32),
                       srgb=(params.srgb, (256,), F32))
            if (params.srgb is None) != (self.atlas is None):
                raise ValueError("the sRGB table goes with a textured "
                                 "scene's params")
            self.params = params
        torch.mul(active, SEG_TMAX, out=self.tmax)


def segment_plan(scene: Scene, state, active, sizes, params) -> SegmentPlan:
    """The segment plan of a kernel-backend loop over `state` (15, lanes)
    with these bucket sizes (`wavefront.bucket_sizes`) on the current
    stream, kept on the scene and replaced when it does not fit
    (`SegmentPlan.fits`); then started for this loop
    (`SegmentPlan.start`)."""
    dev = state.device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    geom = _isect.geom_from_scene(scene)
    route = _route(scene, geom, round_up(max(sizes[0], 1), RAY_TILE))
    tables = (_kept_attr_tables(scene, route.tri)
              if route.tri is not None else None)
    key = ("segment_plan", dev, stream)
    plan = scene.kernel_tables.get(key)
    if plan is None or not plan.fits(sizes, geom, route, tables, params):
        # the old workspace goes before the new one is made
        scene.kernel_tables.pop(key, None)
        plan = None
        plan = SegmentPlan(scene, geom, route, tables, sizes, state, active,
                           params, stream)
        scene.kernel_tables[key] = plan
        COUNTERS["plan_builds"] += 1
    plan.start(state, active, params)
    return plan
