"""Pinhole camera — port of the stock NVIDIA tutorial ray generation
(VKT/ray_tracing_reflections/shaders/raytrace.rgen:42-48):

    pixelCenter = gl_LaunchID.xy + 0.5
    d           = pixelCenter / gl_LaunchSize * 2 - 1
    origin      = viewInverse * (0,0,0,1)
    target      = projInverse * (d.x, d.y, 1, 1)
    direction   = viewInverse * (normalize(target.xyz), 0)

The view/projection matrices mirror `updateUniformBuffer`
(VKT/ray_tracing__before/hello_vulkan.cpp:58-100): perspectiveVK(fov, aspect,
0.1, 1000) and the CameraManipulator look-at matrix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from toroidal_ray_tracing_tpu_torch.ops import front_kernel
# the block-major pixel order and its inverse (R1's twin keeps them)
from toroidal_ray_tracing_tpu_torch.ops.front_kernel import (  # noqa: F401
    block_unswizzle, pixel_coords)
from toroidal_ray_tracing_tpu_torch.utils import math3d

F32 = np.float32


def pick_block(width: int, height: int) -> int:
    """Largest supported block size dividing both dimensions."""
    for b in (32, 24, 16, 12, 8, 6, 4, 3, 2):
        if width % b == 0 and height % b == 0:
            return b
    return 1


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    KIND = front_kernel.PINHOLE      # R1's camera kind (not a field)

    eye: tuple = (10.0, 0.0, 0.0)     # reference default pose: lookat (0,0,0)
    center: tuple = (0.0, 0.0, 0.0)   # from (10,0,0) (main.cpp:123-133)
    up: tuple = (0.0, 1.0, 0.0)
    fov_deg: float = 60.0             # CameraManipulator default FOV
    near: float = 0.1
    far: float = 1000.0

    def pixel_spread(self, width: int, height: int) -> float:
        """World-units-per-unit-distance footprint of one pixel (vertical
        FOV over the pixel rows) — drives texture mip LOD selection."""
        return 2.0 * math.tan(math.radians(self.fov_deg) / 2.0) / height

    def matrices(self, aspect: float):
        view = math3d.look_at(self.eye, self.center, self.up)
        proj = math3d.perspective_vk(self.fov_deg, aspect, self.near, self.far)
        return view, proj, math3d.inverse(view), math3d.inverse(proj)

    def ray_params(self, width: int, height: int, settings=None):
        """Host arrays consumed by `device_rays`: (view_inv, proj_inv)."""
        _, _, view_inv, proj_inv = self.matrices(width / height)
        return (view_inv.astype(F32), proj_inv.astype(F32))

    @staticmethod
    def device_rays(params, width: int, height: int, settings=None,
                    jitter=None, block: int = 1, rows: bool = False,
                    device="cpu"):
        """Raygen on `device` (R1, `ops.front_kernel.raygen`: the CUDA
        kernel on a CUDA device, its plain twin on the CPU). rows=True
        emits (3, N) ray rows (the trace layout); otherwise (N, 3).
        jitter: optional (N, 2) subpixel offsets replacing +0.5."""
        return front_kernel.raygen(front_kernel.PINHOLE, params, width,
                                   height, jitter, block, rows, device)

    def generate_rays(self, width: int, height: int, settings=None,
                      jitter=None, device="cpu"):
        """Rays for every pixel, row-major (i = y*W + x), as (N, 3)."""
        params = self.ray_params(width, height, settings)
        return self.device_rays(params, width, height, settings,
                                jitter=jitter, device=device)
