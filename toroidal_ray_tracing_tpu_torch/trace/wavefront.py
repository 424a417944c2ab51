"""Wavefront bounce loop over the ray batch.

The reference expresses bounces iteratively in raygen (the payload
round-trip at VKT/ray_tracing__before/shaders/raytrace.rgen:75-108): a
do-while that always traces the primary segment and stops once no ray
wants another bounce (`prd.done == 1 || depth >= maxDepth`). Here that is
an eager Python loop; per-ray vectors are (3, N) rows.

Live-ray compaction (`backend="kernel"`, the JAX package's `pallas` path):
the reference's dead rays leave the raygen loop for free
(raytrace.rgen:100-103); here every segment would trace the whole batch.
So once every live `COMPACT_SPAN`-ray span fits in the first n/f lanes (f
in `COMPACT_FACTORS`), the spans are packed live-first and the segment
traces and shades only that prefix; the suffix is all dead and stays as
it is. Spans move whole: raygen's block swizzle makes a span a compact
screen patch, so the kernels' warps stay coherent. The move is G1
(`ops.front_kernel.span_gather`), from the state into a second buffer that
then becomes the state; the first-hit rows never move (segment 0 writes
them, before any shrink). The color is unpermuted once at the end, by F1
on the front doors. `backend="torch"` traces every segment whole, as the
JAX package's jnp path does.

A kernel-backend segment is V1 (`ops.trace_kernel.segment_ranks`: the
anchor and the tree kernels' visit ranks, once for both queries) -> S1
(the loose hoist) -> K1/K5 -> K2/K3 (the closest hit's parts unmerged,
its raw attribute rows; each kernel writes the next one's tmax), S2
(`ops.shade_kernel.shade_hit`: the merges, shading up to the shadow ray)
-> K4 (textured scenes) -> S1 -> the any-hit kernels (each writes or ORs
into the query's occlusion byte), then S3 (`shade_finish`: the rest of
the shading and the state update in place, the ray count and the live
spans), and G1 when the bucket shrinks. The torch backend shades with
`trace.shade.shade` and updates the state with tensor ops (`_advance`).

Each stage runs inside a `utils.profiling.span`: `trt.loop` (the whole
loop), `trt.segment` (one pass) and within it `trt.segment.ranks` (V1),
`.query` (the closest hit), `.shade` (S2, K4), `.shadow` (the any-hit),
`.finish` (S3, or `_advance`), `.read` (the stop test's host read) and
`.compact` (G1); then `trt.loop.read` (the ray total's). They cost nothing
outside `utils.profiling.recording`. Each host read adds one to
`utils.profiling.COUNTERS["host_reads"]`.

The kernels read a prefix's rows where they lie in the state (they take
its row stride). A front door's kernel-backend loop (`trace_state(...,
planned=True)`, unsharded) runs from a segment plan (`ops.segment_plan`:
each bucket's route, checked arguments and outputs in one workspace, kept
on the scene; `COUNTERS["plan_segments"]` counts its segments), where S3
and G1 write the next segment's tmax row, so no ATen operation runs
between V1 and S3. `trace_rays` (the banded and sharded paths) and the
torch backend make each call's checks and outputs as they go.

`trace_rays_fixed` is the differentiable variant: a fixed number of
segments, autograd through shading and (on the kernel backend)
`closest_hit_diff`'s recompute.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from toroidal_ray_tracing_tpu_torch.ops.front_kernel import (  # noqa: F401
    fill_state_plain, span_gather, span_lanes, span_order, unpermute_rows)
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (SEG_TMAX,
                                                              round_up)
from toroidal_ray_tracing_tpu_torch.ops.segment_plan import segment_plan
# live_spans: the 128-lane spans that hold a live ray (S3 writes them on
# the kernel backend; kept here beside span_order and span_lanes)
from toroidal_ray_tracing_tpu_torch.ops.shade_kernel import (  # noqa: F401
    base_rows, kept_shade_params, live_spans, shade_finish, shade_hit)
from toroidal_ray_tracing_tpu_torch.ops.tex_kernel import quad_gather
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (RAY_TILE,
                                                             segment_ranks)
from toroidal_ray_tracing_tpu_torch.scene.types import RenderSettings, Scene
from toroidal_ray_tracing_tpu_torch.trace.intersect import (
    any_hit, closest_hit, closest_hit_diff, geom_from_scene)
from toroidal_ray_tracing_tpu_torch.trace.shade import shade
from toroidal_ray_tracing_tpu_torch.utils.collectives import MAX, all_reduce
from toroidal_ray_tracing_tpu_torch.utils.profiling import COUNTERS, span

COMPACT_SPAN = 128   # compaction moves whole spans of this many rays
COMPACT_FACTORS = tuple(
    int(f) for f in os.environ.get("TRT_COMPACT_FACTORS", "2,4,8").split(",")
    if f)            # prefix buckets n/f; "" traces every segment whole. The
                     # mirror-floor ladder scenes keep 15.2% of spans live at
                     # bounce 2 (the JAX package's scripts/live_fraction.py)
COMPACT_MIN = 2048   # a bucket holds at least one 2048-ray kernel tile

# rows of the stacked ray state: origin, direction, accumulated color,
# attenuation, first-hit position
_O, _D, _HV, _AT, _HP = (slice(0, 3), slice(3, 6), slice(6, 9),
                         slice(9, 12), slice(12, 15))


def bucket_sizes(n: int, factors=None) -> tuple:
    """The lane counts a segment of an n-ray kernel-backend batch may trace,
    largest first: n rounded up to whole spans (the tail lanes start dead),
    then ceil(n / f) rounded up to whole spans for each factor f with
    n // f >= COMPACT_MIN. Just (n,) when no factor qualifies: the batch
    then traces whole and unpadded."""
    factors = COMPACT_FACTORS if factors is None else factors
    lanes = round_up(n, COMPACT_SPAN)
    smaller = {round_up(-(-n // f), COMPACT_SPAN) for f in factors
               if n // f >= COMPACT_MIN}
    smaller = sorted((s for s in smaller if s < lanes), reverse=True)
    return (lanes, *smaller) if smaller else (n,)


def _sync_group(ray_group, prim_group):
    """The group whose ranks must agree on the stop and the bucket: the one
    group given, or the world when both are (a ("rays", "prims") mesh
    spans it, `parallel.sharding.make_mesh`)."""
    if ray_group is not None and prim_group is not None:
        return torch.distributed.group.WORLD
    return ray_group if ray_group is not None else prim_group


def lane_count(n: int, backend: str) -> int:
    """The lanes of an n-ray batch's state: `bucket_sizes(n)[0]` on the
    kernel backend, n on the torch backend."""
    return bucket_sizes(n)[0] if backend == "kernel" else n


def new_state(lanes: int, device):
    """An unfilled (15, lanes) float32 bounce state and its (lanes,) bool
    active mask (rows origin, direction, color, attenuation, first hit)."""
    return (torch.empty((15, lanes), dtype=torch.float32, device=device),
            torch.empty((lanes,), dtype=torch.bool, device=device))


@dataclasses.dataclass
class Traced:
    """A bounce loop's end (`trace_state`)."""

    state: torch.Tensor      # (15, lanes): each slot's rows now (color)
    first: torch.Tensor      # (15, lanes): the buffer segment 0 ran on,
    #                          its first-hit rows in original lane order
    slot: Optional[torch.Tensor]   # (lanes / 128,) int32 original span ->
    #                                slot, None when no span moved
    rays: int                # the exact ray count


def trace_rays(scene: Scene, settings: RenderSettings, origins, dirs,
               backend: str = "torch", geom=None, prim_group=None,
               ray_group=None):
    """Run the bounce loop for a batch of primary rays.

    origins/dirs: (3, N) rows. Returns (hit_value (3, N), hit_position
    (3, N), rays_traced) — the color and first-hit buffers the raygen
    writes to `RenderedData` (rgen:110-115), and the exact
    traceRayEXT-equivalent count (one closest-hit per live ray plus one
    shadow ray per lit hit, raytrace.rchit:90-109) of this batch as a
    Python int.

    The state is filled here with tensor ops; the front doors fill it with
    R1 (`ops.front_kernel.raygen_state`) and call `trace_state`, as this
    does, then F1.

    backend="kernel" compacts live spans into the smallest of
    `bucket_sizes(N)` that holds them all (module docstring). Its kernels
    order their boxes front to back from the mean origin of the whole
    batch, dead and unpacked rays included, so a compacted segment visits
    in the order, and breaks exact ties as, the whole batch would: each
    ray's result is the same wherever its span sits (the K2 / K3 route
    still follows the prefix's size, as on the TPU).

    geom / prim_group: primitive-sharded queries (`closest_hit`).
    ray_group: the group the ray batch is sharded over. Each segment's
    stop test and bucket come from one reduction over both groups (the
    most live spans of any rank), so every rank runs the same number of
    segments on the same prefix size (the queries' merges are
    collectives). The host reads one number a segment."""
    n = origins.shape[1]
    lanes = lane_count(n, backend)
    state, active = new_state(lanes, origins.device)
    fill_state_plain(state, active, origins, dirs, 0, lanes - n)
    tr = trace_state(scene, settings, state, active, n, backend, geom,
                     prim_group, ray_group)
    # only the color rows moved (G1 leaves the first hit in place)
    return (unpermute_rows(tr.state[_HV], tr.slot)[:, :n],
            tr.first[_HP, :n], tr.rays)


def trace_state(scene: Scene, settings: RenderSettings, state, active,
                n: int, backend: str = "torch", geom=None, prim_group=None,
                ray_group=None, planned: bool = False) -> Traced:
    """The bounce loop on a filled (15, lanes) state of n rays and its
    active mask (`trace_rays`' arguments and module docstring), lanes =
    `lane_count(n, backend)`. On a bucket shrink G1
    (`ops.front_kernel.span_gather`) moves the prefix's spans into a spare
    buffer, which becomes the state: the result names the buffer that
    holds the color rows and the one that holds the first hit. planned:
    run the segments from the scene's segment plan for these lanes
    (`ops.segment_plan`; the front doors' batches), where the loop is the
    kernel backend's and unsharded (no geom, no group); the results are
    the same bits."""
    dev = state.device
    max_depth = int(settings.max_depth)
    kernel = backend == "kernel"
    sizes = bucket_sizes(n) if kernel else (n,)
    compact = len(sizes) > 1
    lanes = sizes[0]
    if state.shape != (15, lanes):
        raise ValueError(f"state {tuple(state.shape)} for {n} rays on "
                         f"{backend}: want (15, {lanes})")
    with span("trt.loop"):
        first = state
        n_batch = round_up(max(n, 1), RAY_TILE)  # the kernels' anchor divisor
        group = _sync_group(ray_group, prim_group)
        spare = slot = None     # G1's second buffer; original span -> slot
        orig_in = orig_out = None   # G1's maps slot -> original span
        nb = lanes              # lanes this segment traces
        any_active = True
        depth = 0
        plan = bucket = None
        if kernel:
            params = kept_shade_params(scene, settings)
            if planned and geom is None and group is None:
                plan = segment_plan(scene, state, active, sizes, params)
            spans = (plan.spans if plan is not None else
                     torch.empty((-(-lanes // COMPACT_SPAN),),
                                 dtype=torch.bool, device=dev))
            # the ray counter (int64, S3 adds to it) and each segment's
            # live-span count, zeroed by one fill
            tally = torch.zeros((2 + max(max_depth, 1),), dtype=torch.int32,
                                device=dev)
            rays, counts = tally[:2].view(torch.int64)[0], tally[2:]
        else:
            rays = torch.zeros((), dtype=torch.int64, device=dev)

        # do-while (rgen:75-108): the primary segment is traced even when
        # max_depth <= 0
        while any_active and (depth < max_depth or depth == 0):
            with span("trt.segment"):
                s = state[:, :nb]
                act = active[:nb]
                if plan is not None:
                    bucket = plan.buckets[nb]
                    COUNTERS["plan_segments"] += 1
                if kernel:
                    # the segment's visit ranks, from the whole state's
                    # anchor, for both of its queries (V1, one launch)
                    with span("trt.segment.ranks"):
                        ranks = (plan.ranks(state, bucket, n_batch)
                                 if plan is not None else segment_ranks(
                                     scene, geom or geom_from_scene(scene),
                                     state[_O], n_batch, nb))
                else:
                    ranks = None
                with span("trt.segment.query"):
                    # the prefix's rows where they lie in the state (the
                    # kernels take its row stride)
                    o, d = s[_O], s[_D]
                    # dead rays trace with tmax = 0: every kernel skips
                    # them (a plan's row: S3 and G1 wrote it)
                    seg_tmax = (plan.tmax[:nb] if plan is not None
                                else torch.where(act, SEG_TMAX, 0.0))
                    # the kernel backend's unsharded query hands S2 its
                    # parts unmerged; a sharded one merges over the ranks
                    # first
                    hit = closest_hit(scene, o, d, tmax=seg_tmax,
                                      backend=backend, geom=geom,
                                      prim_group=prim_group,
                                      want_attrs=kernel, ranks=ranks,
                                      merge=not kernel
                                      or prim_group is not None)
                if kernel:
                    # S2 -> K4 (textured) -> the shadow any-hit -> S3,
                    # which updates the state, the ray count and the live
                    # spans in place
                    with span("trt.segment.shade"):
                        sr = shade_hit(o, d, hit.attrs if hit.t is None
                                       else base_rows(hit), params,
                                       out=bucket.s2 if bucket else None)
                        quads = (quad_gather(scene.textures.data4q, *sr.tex,
                                             out=bucket.k4 if bucket
                                             else None)
                                 if sr.tex is not None else None)
                    # (a missed lane's shadow ray is undefined, its tmax 0:
                    # the visit ranks are the segment's; S3 reads the
                    # occlusion byte the query's kernels write)
                    with span("trt.segment.shadow"):
                        occluded = any_hit(scene, sr.shadow_o, sr.shadow_d,
                                           sr.shadow_tmax, backend=backend,
                                           geom=geom, prim_group=prim_group,
                                           ranks=ranks)
                    with span("trt.segment.finish"):
                        local = counts[depth]
                        shade_finish(state, active, nb, sr, occluded, quads,
                                     params, depth, max_depth, rays, spans,
                                     local,
                                     out=bucket.s3 if bucket else None)
                    count = local
                else:
                    with span("trt.segment.finish"):
                        count = _advance(scene, settings, s, active, nb, hit,
                                         depth, max_depth, rays, geom,
                                         prim_group)

                # the stop test and the next bucket: the live spans (the
                # most of any rank's, which every rank's bucket then
                # holds), read once
                with span("trt.segment.read"):
                    if group is not None:
                        count = all_reduce(count, MAX, group)
                    count = int(count)
                    COUNTERS["host_reads"] += 1
                any_active = count > 0
                fit = (min(z for z in sizes if z >= count * COMPACT_SPAN)
                       if compact else nb)
                if any_active and fit < nb:
                    # G1: the prefix's live spans first (the suffix is
                    # dead), into the spare buffer, which becomes the state
                    with span("trt.segment.compact"):
                        if spare is None:
                            spare, spare_act = new_state(lanes, dev)
                            orig_out = torch.empty((lanes // COMPACT_SPAN,),
                                                   dtype=torch.int32,
                                                   device=dev)
                            slot = torch.empty_like(orig_out)
                        span_gather(state, spare, active, spare_act, spans,
                                    local, orig_in, orig_out, slot, nb, fit,
                                    plan.tmax if plan is not None else None)
                        state, spare = spare, state
                        active, spare_act = spare_act, active
                        orig_in, orig_out = orig_out, (
                            torch.empty_like(orig_out) if orig_in is None
                            else orig_in)
                    nb = fit
                depth += 1
        with span("trt.loop.read"):
            rays = int(rays)
            COUNTERS["host_reads"] += 1
    return Traced(state, first, slot, rays)


def _advance(scene, settings, s, active, nb, hit, depth, max_depth, rays,
             geom, prim_group):
    """One segment's shading and state update on the torch backend, in
    place (the kernel backend's S2 / S3 twins restate it). Returns whether
    a ray is still live (0-d)."""
    o, d, att, hv = s[_O], s[_D], s[_AT], s[_HV]
    act = active[:nb]
    sh = shade(scene, settings, o, d, hit, backend="torch", geom=geom,
               prim_group=prim_group)
    live = act[None, :]
    # rchit multiplies prd.attenuation before rgen accumulates
    # (rchit:127 runs inside traceRayEXT, before rgen:92)
    torch.where(live, att * sh.atten_factor, att, out=att)
    torch.where(live, hv + sh.hit_value * att, hv, out=hv)
    if depth == 0:
        torch.where(live, sh.hit_position, s[_HP], out=s[_HP])
    rays += act.sum() + (act & sh.shadow_rays).sum()
    act = act & ~sh.done & (depth + 1 < max_depth)
    active[:nb] = act
    torch.where(act[None, :], sh.next_origin, o, out=o)
    torch.where(act[None, :], sh.next_dir, d, out=d)
    return act.any()


def trace_rays_fixed(scene: Scene, settings: RenderSettings, origins, dirs,
                     depth: int, backend: str = "torch"):
    """Differentiable variant: `max(depth, 1)` segments, no early exit and
    no depth test (the JAX package's `lax.scan` loop), so the render is a
    differentiable function of the scene's and the settings' tensors
    (torus radii and transforms, materials, light). Matches `trace_rays`
    for rays that end within `depth` segments.

    backend="kernel" runs the kernels for each segment's closest hit
    (`closest_hit_diff`: the backward pass recomputes on the dense torch
    path) and shades with the gather formulation (no kernel attrs); the
    shadow any-hit and the texture fetch stay on the kernels.
    origins/dirs: (N, 3). Returns (hit_value (N, 3), hit_position (N, 3)).
    """
    origins, dirs = origins.T, dirs.T
    n = origins.shape[1]
    dev = origins.device
    hit_value = torch.zeros((3, n), dtype=torch.float32, device=dev)
    attenuation = torch.ones((3, n), dtype=torch.float32, device=dev)
    hit_position = torch.zeros((3, n), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    for i in range(max(depth, 1)):
        seg_tmax = torch.where(active, SEG_TMAX, 0.0)
        if backend == "kernel":
            hit = closest_hit_diff(scene, origins, dirs, tmax=seg_tmax)
        else:
            hit = closest_hit(scene, origins, dirs, tmax=seg_tmax,
                              backend=backend)
        sh = shade(scene, settings, origins, dirs, hit, backend=backend)

        live = active[None, :]
        attenuation = torch.where(live, attenuation * sh.atten_factor,
                                  attenuation)
        hit_value = torch.where(live, hit_value + sh.hit_value * attenuation,
                                hit_value)
        if i == 0:
            hit_position = torch.where(live, sh.hit_position, hit_position)
        active = active & ~sh.done
        origins = torch.where(active[None, :], sh.next_origin, origins)
        dirs = torch.where(active[None, :], sh.next_dir, dirs)
    return hit_value.T, hit_position.T
