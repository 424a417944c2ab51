"""Render-parameter sweeps: the reference's ImGui tweak panel as a CLI (the
port of the JAX package's `experiments/settings_sweep.py`).

The reference exposes light type / position / intensity and the bounce cap
as interactive controls changed between frames without a pipeline rebuild
(`renderUI`, VKT/ray_tracing__before/main.cpp:279-290, pushed to the shaders
through PushConstantRay each frame). `RenderSettings` is the PushConstantRay
clone and nothing here compiles per value, so a sweep is a loop of renders
over the settings variants, with the scene copied to the device once.

    python -m toroidal_ray_tracing_tpu_torch.experiments.settings_sweep \\
        --scene multi_torus --param light_intensity --values 20 60 100 180 \\
        --out DIR [--backend torch] [--device cpu]

Sweepable parameters (all PushConstantRay fields, main.cpp:279-290):
  light_intensity   point-light power
  light_x/y/z       light position component
  light_type        0 = point, 1 = infinite (directional)
  max_depth         bounce cap (hello_vulkan.h:153's maxDepth slider)
  rho               toroidal-camera ring radius
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.io import png
from toroidal_ray_tracing_tpu_torch.render.renderer import (
    autofill_pixel_spread, check_device, render, tonemap)
from toroidal_ray_tracing_tpu_torch.scene import RenderSettings, build_scene

F32 = np.float32

PARAMS = ("light_intensity", "light_x", "light_y", "light_z", "light_type",
          "max_depth", "rho")


def _apply(settings: RenderSettings, name: str, value) -> RenderSettings:
    """A copy of `settings` with parameter `name` set to `value`."""
    light = settings.light
    if name == "light_intensity":
        return dataclasses.replace(settings, light=dataclasses.replace(
            light, intensity=float(F32(value))))
    if name in ("light_x", "light_y", "light_z"):
        pos = light.position.clone()
        pos["xyz".index(name[-1])] = float(F32(value))
        return dataclasses.replace(settings, light=dataclasses.replace(
            light, position=pos))
    if name == "light_type":
        return dataclasses.replace(settings, light=dataclasses.replace(
            light, type=int(value)))
    if name == "max_depth":
        return dataclasses.replace(settings, max_depth=int(value))
    if name == "rho":
        return dataclasses.replace(settings, rho=float(F32(value)))
    raise ValueError(f"unknown sweep parameter {name!r} (one of {PARAMS})")


def sweep(scene, camera, width, height, base_settings, param: str, values,
          backend: str = "torch", device="cuda"):
    """Render one frame per value of `param`: each frame equals a single
    `render` of that variant. The scene is copied to `device` once and the
    pixel spread filled once. device: the CUDA device by default (raises
    without a GPU); device="cpu" for the CPU.

    Returns {"images": (S, H, W, 3) linear, "rays_traced": (S,) int64}."""
    device = check_device(device)
    base = autofill_pixel_spread(base_settings, camera, width, height)
    scene = scene.to(device)
    images, rays = [], []
    for v in values:
        out = render(scene, camera, width, height, _apply(base, param, v),
                     backend=backend, device=device)
        images.append(out["image"])
        rays.append(out["rays_traced"])
    return {"images": torch.stack(images),
            "rays_traced": torch.tensor(rays, dtype=torch.int64)}


def main(argv=None):
    from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
    from toroidal_ray_tracing_tpu_torch.experiments.scene_args import (
        add_scene_args, scene_def_from_args)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_scene_args(ap)
    ap.add_argument("--out", required=True)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--backend", default="kernel", choices=["torch", "kernel"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--eye", type=float, nargs=3, default=(8.0, 5.0, 8.0))
    ap.add_argument("--center", type=float, nargs=3, default=(0.0, 0.5, 0.0))
    ap.add_argument("--param", required=True, choices=PARAMS)
    ap.add_argument("--values", type=float, nargs="+", required=True)
    ap.add_argument("--max-depth", type=int, default=10)
    args = ap.parse_args(argv)

    check_device(args.device)
    scene = build_scene(scene_def_from_args(args))
    cam = PinholeCamera(eye=tuple(args.eye), center=tuple(args.center))
    st = RenderSettings.default(max_depth=args.max_depth)
    out = sweep(scene, cam, args.width, args.height, st, args.param,
                args.values, backend=args.backend, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    imgs = tonemap(out["images"]).cpu().numpy()
    files = []
    for i, v in enumerate(args.values):
        tag = f"{args.param}_{v:g}".replace(".", "p")
        path = os.path.join(args.out, f"sweep_{i:03d}_{tag}.png")
        png.save_png(path, imgs[i])
        files.append(path)
        print(f"{args.param}={v:g} rays={int(out['rays_traced'][i])} "
              f"-> {path}")
    return files


if __name__ == "__main__":
    main()
