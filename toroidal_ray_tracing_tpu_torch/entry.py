"""The port's graft entry: `entry()` returns `(fn, args)`, the
counterpart of the JAX package's `__graft_entry__.entry()`.

`fn(*args)` traces one frame of the flagship pipeline: config 3's scene
(four analytic tori over a mirror plane), a pinhole eye at (8, 5, 8)
looking at (0, 0.5, 0), depth 3, 64x64 primary rays, through
`trace.wavefront.trace_rays` on the kernel backend (K3 on the card, its
plain twin on the CPU). It returns (color (3, N), first-hit position
(3, N), rays traced).
"""

from __future__ import annotations

import functools

from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.render.renderer import check_device
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays

RES = 64


def entry(device=None):
    """Returns (fn, args): fn = `trace_rays` with backend="kernel", args =
    (scene, settings, origins, dirs) with the scene and settings moved to
    the device and the 64x64 row-major rays as (3, N) rows, the port's
    trace layout (the JAX entry passes the same rays as (N, 3)).

    device: the CUDA device when None; without a GPU that raises (no
    fallback), pass device="cpu" for the CPU, where the kernels' plain
    twins run."""
    device = check_device("cuda" if device is None else device)
    scene = build_scene(procedural.scene_multi_torus(analytic=True))
    cam = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    settings = RenderSettings.default(max_depth=3)
    origins, dirs = cam.generate_rays(RES, RES, settings, device=device)
    fn = functools.partial(trace_rays, backend="kernel")
    return fn, (scene.to(device), settings.to(device),
                origins.T.contiguous(), dirs.T.contiguous())
