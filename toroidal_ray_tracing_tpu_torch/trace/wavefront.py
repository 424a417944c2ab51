"""Wavefront bounce loop over the ray batch.

The reference expresses bounces iteratively in raygen (the payload
round-trip at VKT/ray_tracing__before/shaders/raytrace.rgen:75-108): a
do-while that always traces the primary segment and stops once no ray
wants another bounce (`prd.done == 1 || depth >= maxDepth`). Here that is
an eager Python loop; per-ray vectors are (3, N) rows.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.scene.types import RenderSettings, Scene
from toroidal_ray_tracing_tpu_torch.trace.intersect import closest_hit
from toroidal_ray_tracing_tpu_torch.trace.shade import shade

SEG_TMAX = 10000.0   # raytrace.rgen:62


def trace_rays(scene: Scene, settings: RenderSettings, origins, dirs,
               backend: str = "torch"):
    """Run the bounce loop for a batch of primary rays.

    origins/dirs: (3, N) rows. Returns (hit_value (3, N), hit_position
    (3, N), rays_traced) — the color and first-hit buffers the raygen
    writes to `RenderedData` (rgen:110-115), and the exact
    traceRayEXT-equivalent count (one closest-hit per live ray plus one
    shadow ray per lit hit, raytrace.rchit:90-109) as a Python int."""
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
                          backend=backend, want_attrs=backend == "kernel")
        sh = shade(scene, settings, origins, dirs, hit, backend=backend)

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
        any_active = bool(active.any())
        depth += 1
    return hit_value, hit_position, int(rays)
