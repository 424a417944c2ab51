"""Toroidal camera — port of the reference's experimental raygen
(VKT/ray_tracing__before/shaders/raytrace.rgen:19-57).

Each pixel (x, y) maps to two angles covering 360x360 degrees:

    d_alfa = 360 / W ; d_beta = 360 / H
    alfa   = d_alfa * x           (around the big circle)
    beta   = d_beta * y           (around each small circle)

A yaw offset `omega` aligns alfa=0 with the camera's sight direction in the
x-z plane (rgen:36-43, with the acos branch flip when temp.z < 0), and a pitch
offset `theta` is applied only when eye.y != center.y (rgen:45-53). Rays
originate on a horizontal circle of radius rho around the eye (rgen:56-57):

    origin = eye + rho * (cos(alfa+omega), 0, sin(alfa+omega))
    dir    = (cos(alfa+omega) cos(beta+theta),
              sin(beta+theta),
              sin(alfa+omega) cos(beta+theta))
"""

from __future__ import annotations

import dataclasses

import numpy as np

from toroidal_ray_tracing_tpu_torch.ops import front_kernel

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class ToroidalCamera:
    KIND = front_kernel.TOROIDAL     # R1's camera kind (not a field)

    eye: tuple = (0.0, 0.0, 0.0)
    center: tuple = (10.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)  # unused by the toroidal math; kept for UI parity

    def pixel_spread(self, width: int, height: int) -> float:
        """Angular pixel pitch (the grid is 360 degrees over H rows)."""
        return float(np.radians(360.0 / height))

    def offsets(self, rho: float):
        """Scalar (omega, theta) offsets in degrees (rgen:34-53)."""
        eye = np.asarray(self.eye, dtype=F32)
        center = np.asarray(self.center, dtype=F32)
        temp = center - eye
        d = np.array([temp[0], temp[2]], dtype=F32)
        d = d / F32(np.linalg.norm(d))
        omega = F32(np.degrees(np.arccos(np.clip(d[0], -1.0, 1.0))))
        if temp[2] < 0:
            omega = F32(360.0) - omega
        theta = F32(0.0)
        if eye[1] != center[1]:  # exact comparison, as in rgen:45
            first = np.array(
                [eye[0] + rho * np.cos(np.radians(omega)),
                 eye[1],
                 eye[2] + rho * np.sin(np.radians(omega))], dtype=F32)
            temp2 = center - first
            d2 = np.array([temp2[0], temp2[1]], dtype=F32)
            d2 = d2 / F32(np.linalg.norm(d2))
            theta = F32(np.degrees(np.arccos(np.clip(d2[0], -1.0, 1.0))))
            if temp2[1] < 0:
                theta = F32(360.0) - theta
        return float(omega), float(theta)

    def ray_params(self, width: int, height: int, settings):
        """Host arrays consumed by `device_rays`: (eye, [omega, theta,
        rho]); the acos branch flips run here on host floats."""
        rho = float(settings.rho)
        omega, theta = self.offsets(rho)
        return (np.asarray(self.eye, dtype=F32),
                np.asarray([omega, theta, rho], dtype=F32))

    @staticmethod
    def device_rays(params, width: int, height: int, settings=None,
                    jitter=None, block: int = 1, rows: bool = False,
                    device="cpu"):
        """Raygen on `device` (R1, `ops.front_kernel.raygen`: the CUDA
        kernel on a CUDA device, its plain twin on the CPU); rows=True
        emits (3, N) rays, else (N, 3)."""
        return front_kernel.raygen(front_kernel.TOROIDAL, params, width,
                                   height, jitter, block, rows, device)

    def generate_rays(self, width: int, height: int, settings, jitter=None,
                      device="cpu"):
        """Rays for every pixel, row-major (i = y*W + x), as (N, 3)."""
        params = self.ray_params(width, height, settings)
        return self.device_rays(params, width, height, settings,
                                jitter=jitter, device=device)
