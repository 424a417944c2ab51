"""The scenario ladder: each configuration's scene, frame size, depth,
samples per pixel and camera, the same table as the JAX package's
`experiments/configs.py` (`SCENARIOS` 1-8), and `run_scenario`, which
renders one of them and times it:

    python -m toroidal_ray_tracing_tpu_torch.experiments.configs --run 3 \
        [--backend kernel] [--sequence | --raster] [--frames N] [--out DIR]
        [--device cpu]

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

import argparse
import dataclasses
import json
import math
import os
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.io import png
from toroidal_ray_tracing_tpu_torch.render.renderer import (check_device,
                                                            render_frames,
                                                            render_sequence,
                                                            tonemap)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)

WINDOWS = 3                    # timed windows after one warm-up
DUMPS_MAX_PIXELS = 64 * 1024 * 1024   # F x H x W above which the front
                                      # door skips the dump buffers


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


def _windows(run, device):
    """One warm-up call of `run`, then WINDOWS timed calls, each ended by
    `torch.cuda.synchronize()` on a CUDA device. Returns (the last
    result, the window times in seconds)."""
    out = run()
    times = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        out = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return out, times


def _timing(total_rays, times):
    """Mrays/s from the median window, and the windows as [min, median,
    max] milliseconds."""
    med = statistics.median(times)
    return {"mrays_per_s": total_rays / med / 1e6,
            "window_ms": [1e3 * min(times), 1e3 * med, 1e3 * max(times)]}


def run_scenario(num: int, backend: str = "torch", out_dir: str | None = None,
                 frames: int | None = None, sequence: bool = False,
                 raster: bool = False, device="cuda"):
    """Render scenario `num` and time it. Returns (output, stats).

    Three modes, as the JAX package's `run_scenario`:
      raster:   one `raster_render` frame (the reference UI's "use raster"
                checkbox); a PNG in `out_dir`;
      sequence: `render_sequence(..., keep_images=False)` over
                `cameras_seq(frames)` (at least 2 frames), the sustained
                throughput;
      default:  the front door, `render_frames` over `camera_at(f)` for
                `frames` frames (default: the scenario's animated frames,
                or 1), without the dump buffers when frames x W x H
                exceeds 64M pixels; the last frame as a PNG in `out_dir`.

    Timing (both render modes): one warm-up call, then 3 timed windows of
    the whole call, each ended by `torch.cuda.synchronize()` on the card.
    stats: scenario, frames, rays_per_frame, mrays_per_s, protocol and
    window_ms ([min, median, max] ms). mrays_per_s comes from the MEDIAN
    window, not the best: host-bound frames spread widely between windows
    and processes, and the best of 3 hides that.

    device: the CUDA device by default; without a GPU that raises (no
    fallback), pass device="cpu" for the CPU."""
    device = check_device(device)
    sc = SCENARIOS[num]
    scene = sc.build()
    st = sc.settings()
    n_frames = frames if frames is not None else max(sc.animate_frames, 1)

    if raster:
        from toroidal_ray_tracing_tpu_torch.render.raster import raster_render

        out = raster_render(scene, sc.camera_at(0), sc.width, sc.height, st,
                            device=device)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            png.save_png(os.path.join(out_dir, f"{sc.name}_raster.png"),
                         tonemap(out["image"]).cpu().numpy())
        return out, {"scenario": sc.name, "frames": 1, "protocol": "raster"}

    if sequence:
        n_frames = max(n_frames, 2)
        cams = sc.cameras_seq(n_frames)

        def run():
            return render_sequence(scene, cams, sc.width, sc.height, st,
                                   backend=backend, spp=sc.spp,
                                   keep_images=False, device=device)

        out, times = _windows(run, device)
        total = out["rays_traced"]
        return None, {"scenario": sc.name, "frames": n_frames,
                      "rays_per_frame": total / n_frames,
                      **_timing(total, times), "protocol": "sequence"}

    cams = [sc.camera_at(f) for f in range(n_frames)]
    dumps = sc.width * sc.height * n_frames <= DUMPS_MAX_PIXELS

    def run():
        return render_frames(scene, cams, sc.width, sc.height, st,
                             backend=backend, spp=sc.spp, dumps=dumps,
                             device=device)

    last, times = _windows(run, device)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        png.save_png(os.path.join(out_dir, f"{sc.name}.png"),
                     tonemap(last["images"][-1]).permute(1, 2, 0)
                     .cpu().numpy())
    total = last["rays_traced"]
    return last, {"scenario": sc.name, "frames": n_frames,
                  "rays_per_frame": total / n_frames,
                  **_timing(total, times), "protocol": "front_door"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", type=int, required=True, choices=sorted(SCENARIOS))
    ap.add_argument("--backend", default="torch", choices=["torch", "kernel"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--sequence", action="store_true",
                    help="render_sequence over an orbit (sustained "
                         "throughput, no per-frame outputs)")
    ap.add_argument("--raster", action="store_true",
                    help="render through the z-buffered raster pipeline "
                         "(the reference UI's 'use raster' checkbox)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    _, stats = run_scenario(args.run, args.backend, args.out, args.frames,
                            sequence=args.sequence, raster=args.raster,
                            device=args.device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
