"""Top-level render entry point.

One call replaces the reference's per-frame command buffer (`raytrace()` +
offscreen image + RenderedData SSBO,
VKT/ray_tracing__before/hello_vulkan.cpp:936-958): generate rays for the
camera, run the wavefront bounce loop, and return the image plus the
`RenderedData` quartet (pos / color / rayOrigin / rayDir,
shaders/host_device.h:101-107).

The image is linear color; `tonemap` applies the post pass's gamma
(post.frag:35-36) for display.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import (block_unswizzle,
                                                            pick_block)
from toroidal_ray_tracing_tpu_torch.scene.types import RenderSettings, Scene
from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays

F32 = np.float32
INV_GAMMA = float(F32(1.0 / 2.2))


def tonemap(image):
    """Post-pass gamma (pow(color, 1/2.2), post.frag:35-36)."""
    return torch.pow(torch.clamp(image, min=0.0), INV_GAMMA)


def autofill_pixel_spread(settings: RenderSettings, camera, width, height):
    """Fill `pixel_spread` from the camera when unset (0) — the reference's
    sampler is always mipmapped (hello_vulkan.cpp:315-339). A negative
    value forces level-0 sampling."""
    ps = float(settings.pixel_spread)
    if ps == 0.0 and hasattr(camera, "pixel_spread"):
        return dataclasses.replace(
            settings, pixel_spread=float(F32(camera.pixel_spread(width,
                                                                 height))))
    if ps < 0.0:
        return dataclasses.replace(settings, pixel_spread=0.0)
    return settings


def _frame(scene, settings, camera, params, width, height, backend, jitter,
           device):
    """Raygen + trace + unswizzle of one frame. Rays are traced in
    block-major pixel order (each warp of a trace kernel covers a compact
    screen patch); outputs come back row-major (H, W, 3)."""
    block = pick_block(width, height)
    origins, dirs = camera.device_rays(params, width, height, settings,
                                       jitter=jitter, block=block, rows=True,
                                       device=device)
    color, hitpos, nrays = trace_rays(scene, settings, origins, dirs,
                                      backend=backend)

    def unsw(a):
        return block_unswizzle(a.T, width, height, block)

    return unsw(color), unsw(hitpos), unsw(origins), unsw(dirs), nrays


def _render_banded(scene, camera, width, height, settings, backend, spp,
                   gen, device, tile_rows):
    """Row-band rendering: bounds the live ray state for very large frames.
    Bands trace row-major slices of the full-frame rays."""
    n = width * height
    bands = [(y0, min(tile_rows, height - y0))
             for y0 in range(0, height, tile_rows)]
    color = torch.zeros((n, 3), dtype=torch.float32, device=device)
    hitpos = orig0 = dir0 = None
    nrays = 0
    for s in range(max(spp, 1)):
        jitter = (None if s == 0 else
                  torch.rand((n, 2), generator=gen).to(device))
        o_full, d_full = generate_rays(camera, width, height, settings,
                                       jitter=jitter, device=device)
        if s == 0:
            orig0, dir0 = o_full, d_full
            hitpos = torch.zeros_like(o_full)
        for y0, rows in bands:
            sl = slice(y0 * width, (y0 + rows) * width)
            c, hp, nr = trace_rays(scene, settings,
                                   o_full[sl].T.contiguous(),
                                   d_full[sl].T.contiguous(), backend)
            color[sl] += c.T
            nrays += nr
            if s == 0:
                hitpos[sl] = hp.T
    shape = (height, width, 3)
    return {
        "image": (color / float(max(spp, 1))).reshape(shape),
        "hit_position": hitpos.reshape(shape),
        "ray_origin": orig0.reshape(shape),
        "ray_dir": dir0.reshape(shape),
        "rays_traced": nrays,
    }


def render(scene: Scene, camera, width: int, height: int,
           settings: RenderSettings | None = None, backend: str = "torch",
           spp: int = 1, seed: int = 0, tile_rows: int | None = None,
           device=None):
    """Render one frame.

    backend: "torch" (plain tensor ops) or "kernel" (the hand-written
         closest-hit kernels on CUDA; their plain twins on the CPU).
    spp: samples per pixel; > 1 adds jittered samples (a torch.Generator
         seeded with `seed`) after the centered one.
    tile_rows: render in horizontal bands of this many rows.
    device: where to render (default: the scene's device). "cuda" without a
         GPU raises — there is no CPU fallback.

    Returns a dict: image, hit_position, ray_origin, ray_dir — each
    (H, W, 3) — and rays_traced (int).
    """
    device = torch.device(device) if device is not None else scene.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda'): no CUDA device available")
    if settings is None:
        settings = RenderSettings.default()
    settings = autofill_pixel_spread(settings, camera, width, height)
    scene = scene.to(device)
    settings = settings.to(device)
    gen = torch.Generator().manual_seed(seed)

    if tile_rows is not None and tile_rows < height:
        return _render_banded(scene, camera, width, height, settings,
                              backend, spp, gen, device, tile_rows)

    params = camera.ray_params(width, height, settings)
    n = width * height
    acc = hitpos = origins = dirs = None
    nrays = 0
    for s in range(max(spp, 1)):
        # center sample first (it also provides the hit/ray dumps)
        jitter = (None if s == 0 else
                  torch.rand((n, 2), generator=gen).to(device))
        c, hp, o, d, nr = _frame(scene, settings, camera, params, width,
                                 height, backend, jitter, device)
        acc = c if acc is None else acc + c
        nrays += nr
        if s == 0:
            hitpos, origins, dirs = hp, o, d
    return {
        "image": acc / float(max(spp, 1)),
        "hit_position": hitpos,
        "ray_origin": origins,
        "ray_dir": dirs,
        "rays_traced": nrays,
    }
