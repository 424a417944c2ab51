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
import torch

from toroidal_ray_tracing_tpu_torch.utils import math3d

F32 = np.float32


def pixel_coords(width: int, height: int, block: int = 1, device="cpu"):
    """Pixel (px, py) for flat index i, float32.

    block > 1 emits pixels in block-major order (b x b tiles, row-major
    within and across tiles): consecutive ray indices then form compact
    screen patches — a warp of the trace kernels covers a small screen
    patch, so its rays take similar paths. Callers un-swizzle with
    `block_unswizzle`."""
    i = torch.arange(width * height, dtype=torch.int32, device=device)
    if block <= 1:
        return (i % width).float(), (i // width).float()
    b = block
    wb = width // b
    blk = i // (b * b)
    off = i % (b * b)
    px = (blk % wb) * b + off % b
    py = (blk // wb) * b + off // b
    return px.float(), py.float()


def pick_block(width: int, height: int) -> int:
    """Largest supported block size dividing both dimensions."""
    for b in (32, 24, 16, 12, 8, 6, 4, 3, 2):
        if width % b == 0 and height % b == 0:
            return b
    return 1


def block_unswizzle(a, width: int, height: int, block: int):
    """(H*W, C) block-major -> (H, W, C) row-major."""
    c = a.shape[-1]
    if block <= 1:
        return a.reshape(height, width, c)
    b = block
    a = a.reshape(height // b, width // b, b, b, c)
    return a.permute(0, 2, 1, 3, 4).reshape(height, width, c)


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
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
        """Raygen on `device`: pixel indices come from a device arange.
        rows=True emits (3, N) ray rows (the trace layout); otherwise
        (N, 3). jitter: optional (N, 2) subpixel offsets replacing +0.5."""
        view_inv, proj_inv = params

        px, py = pixel_coords(width, height, block, device)
        if jitter is not None:
            px = px + jitter[:, 0]
            py = py + jitter[:, 1]
        else:
            px = px + 0.5
            py = py + 0.5
        dx = px / float(width) * 2.0 - 1.0
        dy = py / float(height) * 2.0 - 1.0

        # elementwise (no matmul): one rounding order everywhere
        pi = torch.as_tensor(proj_inv, device=device)
        tc = [pi[j, 0] * dx + pi[j, 1] * dy + pi[j, 2] + pi[j, 3]
              for j in range(3)]
        tn = torch.sqrt(tc[0] * tc[0] + tc[1] * tc[1] + tc[2] * tc[2])
        tc = [c / tn for c in tc]
        vi = torch.as_tensor(view_inv, device=device)
        dc = [vi[j, 0] * tc[0] + vi[j, 1] * tc[1] + vi[j, 2] * tc[2]
              for j in range(3)]
        dim = 0 if rows else -1
        dirs = torch.stack(dc, dim=dim)
        eye = vi[:3, 3][:, None] if rows else vi[:3, 3][None, :]
        origin = torch.broadcast_to(eye, dirs.shape).contiguous()
        return origin, dirs

    def generate_rays(self, width: int, height: int, settings=None,
                      jitter=None, device="cpu"):
        """Rays for every pixel, row-major (i = y*W + x), as (N, 3)."""
        params = self.ray_params(width, height, settings)
        return self.device_rays(params, width, height, settings,
                                jitter=jitter, device=device)
