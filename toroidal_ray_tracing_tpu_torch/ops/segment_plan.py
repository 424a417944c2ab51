"""The bounce loop's segment plan: each segment's launches with their checks,
routes and outputs settled once. Every kernel-backend loop
(`trace.wavefront.trace_state`) runs its segments from one.

A segment is V1, the closest query (S1, K1/K5, K2/K3), S2, K4 on textured
scenes, the any-hit query and S3, each through its wrapper. Called on its
own, a wrapper checks every argument, allocates every output, and the
query resolves its route and kept tables: tens of microseconds of host
time a launch, which the device spends idle on a host-paced frame.

`segment_plan` builds a `SegmentPlan` for a loop of `lanes` (its bucket
sizes, `wavefront.bucket_sizes`) on a geometry (the scene's, or a sharded
rank's slice) once and keeps it on the scene, one a device and stream
(`Scene.kernel_tables`; a loop of other lanes or geometry, or after the
tables changed, replaces it). Loops of one scene on one stream run one
after another on the device, so they share its workspace. It holds:

* each bucket's route and V1's box sets (`trace_kernel.segment_routes`:
  K2 or K3 by the bucket's size), the scene's tables;
* one workspace (`Workspace`): every output a wrapper writes is a region
  sized for `lanes`, and a bucket of nb lanes takes each region's
  contiguous prefix as a (rows, nb) view. The any-hit query writes into the
  closest query's views (S2 has read them by then); S2's outputs, the
  occlusion byte and K4's words have their own regions;
* the loop's tmax row: S3 writes the next segment's where it updates a ray
  and G1 where it moves one (`kernel_common.SEG_TMAX` where active, else
  0), so between V1 and S3 no ATen operation runs but a sharded loop's
  merges over the primitive ranks (`intersect.combine_hits_over_axis`);
* the raw stream handle every launch goes on.

The constructor runs each wrapper's checks on the arguments and views it
will hand the wrapper; the wrappers, handed the views (`out=`,
`kernel_common.Planned`), check and allocate nothing, and give the bits
their standalone calls give. The K1 and K2 calls still go through
`ops.trace_kernel.tri_closest_hit` and
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
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
    QueryOut, Ranks, _kept_attr_tables, segment_routes, stamp)
from toroidal_ray_tracing_tpu_torch.scene.types import Scene
from toroidal_ray_tracing_tpu_torch.trace import intersect as _isect
from toroidal_ray_tracing_tpu_torch.utils.profiling import COUNTERS

ALIGN = 256          # bytes: each region starts on a 256-B boundary
N_TOR_ATTR = torus_kernel.N_ATTR


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

    def __init__(self, geom, routes: dict, tables, state, active, params,
                 stream):
        dev = state.device
        self.sizes = tuple(routes)
        lanes = self.sizes[0]
        self.geom, self.tables = geom, tables
        self.atlas = params.atlas
        self.params = params
        tri, tor = routes[lanes].tri, routes[lanes].tor
        mesh = tri.mesh if tri is not None else None
        loose = tri is not None and tri.L > 0
        tri_set = routes[lanes].tri_set
        tor_set = next((r.tor_set for r in routes.values()
                        if r.tor_set is not None), None)

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
        anchor = ws.fixed((3,), F32)
        rank_tri = (ws.fixed((tri_set[0].shape[0],), I32) if tri_set
                    else None)
        rank_tor = (ws.fixed((tor_set[0].shape[0],), I32) if tor_set
                    else None)
        ws.allocate()
        self.tmax = ws.view(tmax, lanes)
        self.spans = ws.view(spans)
        anchor = ws.view(anchor)
        rank_tri = ws.view(rank_tri) if rank_tri else None
        rank_tor = ws.view(rank_tor) if rank_tor else None

        def planned(regions, nb, count=None):
            if regions is None:
                return None
            views = [ws.view(r, nb) for r in regions[:count]]
            return Planned(views, stream)

        self.buckets = {}
        for nb, route in routes.items():
            tri_b, tor_b = route.tri_set, route.tor_set
            sets, rank_out = [], [anchor]
            if tri_b is not None:
                sets.append(tri_b)
                rank_out.append(rank_tri)
            if tor_b is not None:
                sets.append(tor_b)
                rank_out.append(rank_tor)
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
            ranks = Ranks(route=route,
                          tri=rank_tri if tri_b is not None else None,
                          tor=rank_tor if tor_b is not None else None,
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
        geom = self.geom
        tally = torch.zeros((3,), dtype=I32, device=dev)
        rays, count = tally[:2].view(torch.int64)[0], tally[2]
        for nb, b in self.buckets.items():
            tri, tor = b.ranks.route.tri, b.ranks.route.tor
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
            # (a sharded loop's S2 rows are checked at each call:
            # `merged_rows`)
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

    def fits(self, geom, routes: dict, tables, params) -> bool:
        """Whether this plan runs a loop of these buckets' routes
        (`segment_routes`' now: the kept tables are rebuilt when a scene
        tensor changed) over this geometry (the same tensors, by `stamp`: a
        sharded rank's slice views are made anew every frame) and these
        tables."""
        g, h = self.geom, geom
        return (self.sizes == tuple(routes)
                and all(b.ranks.route == routes[nb]
                        for nb, b in self.buckets.items())
                and self.tables is tables
                and stamp((g.woop_o, g.woop_d)) == stamp((h.woop_o,
                                                          h.woop_d))
                and g.tor_offset == h.tor_offset
                and (self.atlas is None) == (params.atlas is None)
                and (self.atlas is None
                     or self.atlas.data4q is params.atlas.data4q))

    def merged_rows(self, o, d, hit, bucket: Bucket):
        """S2's rows on a sharded loop: the hit merged over the primitive
        ranks (`intersect.combine_hits_over_axis`) as the base
        (`shade_kernel.base_rows`). They come out of the merge's
        collectives, not the plan's views, so S2's checks run on them at
        each call."""
        rows = shade_kernel.base_rows(hit)
        shade_kernel.check_shade_hit(o, d, rows, self.params, out=bucket.s2)
        return rows

    def ranks(self, state, bucket: Bucket, n_batch: int) -> Ranks:
        """V1 into the bucket's rank views from the anchor of the whole
        state's origin rows, the loop's batch padded to `n_batch`; returns
        the bucket's `Ranks`."""
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


def segment_plan(scene: Scene, geom, state, active, sizes,
                 params) -> SegmentPlan:
    """The segment plan of a kernel-backend loop over `state` (15, lanes)
    with these bucket sizes (`wavefront.bucket_sizes`) on the geometry
    `geom` (the scene's, or a rank's slice) on the current stream. Kept
    on the scene and replaced when it does not fit (`SegmentPlan.fits`);
    then started for this loop (`SegmentPlan.start`)."""
    dev = state.device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    routes = segment_routes(scene, geom, sizes)
    tri = routes[sizes[0]].tri
    tables = _kept_attr_tables(scene, tri) if tri is not None else None
    key = ("segment_plan", dev, stream)
    plan = scene.kernel_tables.get(key)
    if plan is None or not plan.fits(geom, routes, tables, params):
        # the old workspace goes before the new one is made
        scene.kernel_tables.pop(key, None)
        plan = None
        plan = SegmentPlan(geom, routes, tables, state, active, params,
                           stream)
        scene.kernel_tables[key] = plan
        COUNTERS["plan_builds"] += 1
    plan.start(state, active, params)
    return plan
