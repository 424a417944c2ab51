"""App-3 script: pinhole ground-truth renders (`ray_tracing_reflections`);
the port of the JAX package's `experiments/gtruth.py`.

Replicates VKT/ray_tracing_reflections: the stock pinhole camera with the
iterative specular-reflection loop (maxDepth default 10, hello_vulkan.h:157)
dumping `data/<scene>gTruth.txt` (hello_vulkan.cpp:1065-1111, main.cpp:315-330).

Run: python -m toroidal_ray_tracing_tpu_torch.experiments.gtruth --out DIR
(renders on the CUDA device; --device cpu for the CPU).
"""

from __future__ import annotations

import argparse
import os

from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.io import dumps, png
from toroidal_ray_tracing_tpu_torch.render.renderer import render, tonemap
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, Scene,
                                                  build_scene)


def run_gtruth(scene_def, out_dir: str, scene_name: str,
               camera: PinholeCamera | None = None,
               width: int = 1920, height: int = 1080,
               settings: RenderSettings | None = None,
               backend: str = "kernel", save_png: bool = True,
               device="cuda"):
    """Render the ground truth of a `Scene` or a `SceneDef` and dump it;
    returns the written files (the text dump, then the PNG)."""
    if camera is None:
        camera = PinholeCamera(eye=(10.0, 0.0, 0.0), center=(0.0, 0.0, 0.0))
    if settings is None:
        settings = RenderSettings.default(max_depth=10)
    os.makedirs(out_dir, exist_ok=True)
    scene = scene_def if isinstance(scene_def, Scene) else build_scene(
        scene_def)
    out = render(scene, camera, width, height, settings, backend=backend,
                 device=device)
    path = dumps.write_gtruth(out_dir, scene_name, out["image"].cpu().numpy())
    written = [path]
    if save_png:
        written.append(png.save_png(
            os.path.join(out_dir, f"{scene_name}gTruth.png"),
            tonemap(out["image"]).cpu().numpy()))
    return written


def main(argv=None):
    from toroidal_ray_tracing_tpu_torch.experiments.scene_args import (
        add_scene_args, scene_def_from_args)

    ap = argparse.ArgumentParser(description=__doc__)
    add_scene_args(ap)  # --scene NAME | --obj PATH[@x,y,z[,s[,ry]]] ...
    ap.add_argument("--out", required=True)
    ap.add_argument("--name", default=None, help="scene tag in the filename")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--backend", default="kernel", choices=["torch", "kernel"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eye", type=float, nargs=3, default=(10.0, 0.0, 0.0))
    ap.add_argument("--center", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--max-depth", type=int, default=10)
    args = ap.parse_args(argv)

    scene_def = scene_def_from_args(args)
    cam = PinholeCamera(eye=tuple(args.eye), center=tuple(args.center))
    st = RenderSettings.default(max_depth=args.max_depth)
    files = run_gtruth(scene_def, args.out, args.name or args.scene, cam,
                       args.width, args.height, st, backend=args.backend,
                       device=args.device)
    print(f"wrote {files}")


if __name__ == "__main__":
    main()
