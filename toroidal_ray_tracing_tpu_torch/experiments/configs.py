"""The scenario ladder as data: each configuration's scene, frame size,
depth, samples per pixel and camera, the same table as the JAX package's
`experiments/configs.py` (`SCENARIOS` 1-8).

  1. single torus, primary rays only, 256x256
  2. torus + ground plane, Lambertian + hard shadows, 512x512
  3. multi-torus with specular reflections, 3 bounces, 1080p
  4. instanced torus grid (1,024), 1080p, 5 bounces
  5. 4K animated camera fly-through, jittered AA (2 spp)
  6. tessellated-mesh multi-torus (23k triangles), 1080p
  7. textured mesh scene (trilinear mip sampling), 1080p
  8. 1.18M-triangle tessellated mesh (the streamed kernels), 1080p
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)


@dataclasses.dataclass
class Scenario:
    name: str
    scene: Callable
    width: int
    height: int
    max_depth: int
    spp: int = 1
    camera: Optional[PinholeCamera] = None
    animate_frames: int = 0  # > 0: fly-through
    tile_rows: Optional[int] = None  # band rendering for very large frames

    def build(self):
        return build_scene(self.scene())

    def camera_at(self, frame: int = 0):
        if self.camera is not None and self.animate_frames == 0:
            return self.camera
        # orbiting fly-through for the animated scenario
        a = 2.0 * math.pi * frame / max(self.animate_frames, 1)
        eye = (10.0 * math.cos(a), 5.0 + 1.5 * math.sin(2 * a),
               10.0 * math.sin(a))
        return PinholeCamera(eye=eye, center=(0.0, 0.5, 0.0))

    def cameras_seq(self, frames: int):
        """Per-frame cameras: the fly-through for the animated scenario,
        else an orbit of the configured eye about the vertical axis through
        the look-at center (the reference animates the camera between
        captures, main.cpp:296)."""
        if self.animate_frames:
            return [self.camera_at(f) for f in range(frames)]
        eye = np.asarray(self.camera.eye, np.float64)
        ctr = np.asarray(self.camera.center, np.float64)
        rel = eye - ctr
        cams = []
        for f in range(frames):
            a = 2.0 * math.pi * f / frames
            c, s = math.cos(a), math.sin(a)
            rot = np.array([rel[0] * c + rel[2] * s, rel[1],
                            -rel[0] * s + rel[2] * c])
            cams.append(PinholeCamera(eye=tuple(ctr + rot),
                                      center=tuple(ctr)))
        return cams

    def settings(self):
        return RenderSettings.default(max_depth=self.max_depth)


SCENARIOS = {
    1: Scenario("config1_single_torus",
                lambda: procedural.scene_single_torus(analytic=True),
                256, 256, 1,
                camera=PinholeCamera(eye=(6.0, 3.0, 6.0))),
    2: Scenario("config2_torus_plane",
                lambda: procedural.scene_torus_plane(analytic=True),
                512, 512, 1,
                camera=PinholeCamera(eye=(7.0, 4.0, 7.0),
                                     center=(0.0, 0.5, 0.0))),
    3: Scenario("config3_multi_torus",
                lambda: procedural.scene_multi_torus(analytic=True),
                1920, 1080, 3,
                camera=PinholeCamera(eye=(8.0, 5.0, 8.0),
                                     center=(0.0, 0.5, 0.0))),
    4: Scenario("config4_instanced_grid",
                lambda: procedural.scene_instanced_torus_grid(n=1024),
                1920, 1080, 5,
                camera=PinholeCamera(eye=(25.0, 18.0, 25.0),
                                     center=(0.0, 0.0, 0.0))),
    5: Scenario("config5_4k_flythrough",
                lambda: procedural.scene_multi_torus(analytic=True),
                3840, 2160, 3, spp=2, animate_frames=8),
    6: Scenario("config6_mesh_torus",
                lambda: procedural.scene_multi_torus(analytic=False),
                1920, 1080, 3,
                camera=PinholeCamera(eye=(8.0, 5.0, 8.0),
                                     center=(0.0, 0.5, 0.0))),
    7: Scenario("config7_textured",
                procedural.scene_textured_mesh,
                1920, 1080, 3,
                camera=PinholeCamera(eye=(8.0, 5.0, 8.0),
                                     center=(0.0, 0.5, 0.0))),
    8: Scenario("config8_streamed_mesh",
                procedural.scene_hires_mesh,
                1920, 1080, 2,
                camera=PinholeCamera(eye=(6.0, 4.0, 6.0),
                                     center=(0.0, 0.6, 0.0))),
}
