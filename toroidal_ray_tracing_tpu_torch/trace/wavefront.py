"""Wavefront bounce loop over the ray batch.

The reference expresses bounces iteratively in raygen (the payload
round-trip at VKT/ray_tracing__before/shaders/raytrace.rgen:75-108): a
do-while that always traces the primary segment and stops once no ray
wants another bounce (`prd.done == 1 || depth >= maxDepth`). Here that is
an eager Python loop; per-ray vectors are (3, N) rows.

`trace_rays_fixed` is the differentiable variant: a fixed number of
segments, autograd through shading and (on the kernel backend)
`closest_hit_diff`'s recompute.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.scene.types import RenderSettings, Scene
from toroidal_ray_tracing_tpu_torch.trace.intersect import (closest_hit,
                                                            closest_hit_diff)
from toroidal_ray_tracing_tpu_torch.trace.shade import shade
from toroidal_ray_tracing_tpu_torch.utils.collectives import MAX, all_reduce

SEG_TMAX = 10000.0   # raytrace.rgen:62


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

    geom / prim_group: primitive-sharded queries (`closest_hit`).
    ray_group: the group the ray batch is sharded over. The stop test is
    reduced over both groups, so every rank runs the same number of
    segments (the queries' merges are collectives)."""
    n = origins.shape[1]
    dev = origins.device
    max_depth = int(settings.max_depth)
    hit_value = torch.zeros((3, n), dtype=torch.float32, device=dev)
    attenuation = torch.ones((3, n), dtype=torch.float32, device=dev)
    hit_position = torch.zeros((3, n), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    any_active = True
    depth = 0
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    # do-while (rgen:75-108): the primary segment is traced even when
    # max_depth <= 0
    while any_active and (depth < max_depth or depth == 0):
        # dead rays trace with tmax = 0: every kernel skips them
        seg_tmax = torch.where(active, SEG_TMAX, 0.0)
        hit = closest_hit(scene, origins, dirs, tmax=seg_tmax,
                          backend=backend, geom=geom, prim_group=prim_group,
                          want_attrs=backend == "kernel")
        sh = shade(scene, settings, origins, dirs, hit, backend=backend,
                   geom=geom, prim_group=prim_group)

        live = active[None, :]
        # rchit multiplies prd.attenuation before rgen accumulates
        # (rchit:127 runs inside traceRayEXT, before rgen:92)
        attenuation = torch.where(live, attenuation * sh.atten_factor,
                                  attenuation)
        hit_value = torch.where(live, hit_value + sh.hit_value * attenuation,
                                hit_value)
        if depth == 0:
            hit_position = torch.where(live, sh.hit_position, hit_position)

        rays = rays + active.sum() + (active & sh.shadow_rays).sum()
        active = active & ~sh.done & (depth + 1 < max_depth)
        origins = torch.where(active[None, :], sh.next_origin, origins)
        dirs = torch.where(active[None, :], sh.next_dir, dirs)
        live_any = active.any()
        for group in (ray_group, prim_group):
            if group is not None:
                live_any = all_reduce(live_any, MAX, group)
        any_active = bool(live_any)
        depth += 1
    return hit_value, hit_position, int(rays)


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
