"""The reference's full research experiment, end to end (the port's analog
of the repository's `scripts/toroidal_experiment.py`).

Three stages, the reference's app pipeline:
  1. CAPTURE  — toroidal-camera rho sweep 4.0..10.0 at 1920x1080, dumping
     per-step position/color text files (app 1: main.cpp:239-257,337-341,
     376-402).
  2. GTRUTH   — pinhole ground-truth render of the same scene
     (app 3: ray_tracing_reflections/hello_vulkan.cpp:1065-1111).
  3. REPROJECT — splat every captured rho step's point cloud from the
     gTruth pose and compare (app 2: before_second/hello_vulkan.cpp:
     496-628, 781-826): the per-rho RMSE table is the experiment's output.

The scene is the reflective multi-torus (`--scene`) or an OBJ list (`--obj
PATH[@x,y,z[,scale[,ry]]]`, repeatable). Writes the dumps, PNGs and
summary.json under --out and prints the stage seconds and the RMSE table.

Run: python -m toroidal_ray_tracing_tpu_torch.experiments.toroidal_experiment
[--obj PATH ...] [--width 1920 --height 1080] (on the CUDA device; --device
cpu for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _fmt(v) -> str:
    return f"{v:9.6f}" if v is not None else f"{'-':>9}"


def main(argv=None):
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        ToroidalCamera)
    from toroidal_ray_tracing_tpu_torch.experiments import (gtruth, reproject,
                                                            rho_sweep)
    from toroidal_ray_tracing_tpu_torch.experiments.scene_args import (
        add_scene_args, scene_def_from_args)
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene)

    ap = argparse.ArgumentParser(description=__doc__)
    add_scene_args(ap)
    ap.set_defaults(scene="multi_torus")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--backend", default="kernel", choices=["torch", "kernel"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-gtruth", action="store_true",
                    help="skip stage 2 (the table then has no RMSE)")
    ap.add_argument("--out", default=os.path.join("smoke_out",
                                                  "toroidal_experiment"))
    args = ap.parse_args(argv)
    W, H = args.width, args.height
    os.makedirs(args.out, exist_ok=True)

    # the toroidal camera rides the rho-ring around the scene (the
    # reference's capture pose, main.cpp:123-133); gTruth from a pinhole
    # above it
    sd = scene_def_from_args(args)
    cam_t = ToroidalCamera(eye=(0.0, 1.5, 0.0), center=(8.0, 0.0, 0.0))
    cam_p = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    st = RenderSettings.default(max_depth=10)  # the gTruth depth default

    t0 = time.perf_counter()
    files = rho_sweep.run_sweep(sd, args.out, cam_t, W, H, st,
                                backend=args.backend, save_rays=True,
                                device=args.device)
    t_capture = time.perf_counter() - t0
    print(f"capture: {len(files)} dump files in {t_capture:.1f} s",
          flush=True)

    t_gtruth = None
    if not args.no_gtruth:
        t0 = time.perf_counter()
        gtruth.run_gtruth(build_scene(sd), args.out, "toroidal", cam_p, W, H,
                          st, backend=args.backend, device=args.device)
        t_gtruth = time.perf_counter() - t0
        print(f"gTruth: {t_gtruth:.1f} s", flush=True)

    t0 = time.perf_counter()
    results = reproject.run_reproject_all(args.out, "toroidal", cam_p, W, H,
                                          W, H, device=args.device)
    t_reproject = time.perf_counter() - t0

    print(f"\nreproject+compare: {t_reproject:.1f} s")
    print(f"{'rho':>6}  {'RMSE':>9}  {'covered':>9}  {'holes':>9}  "
          f"{'coverage':>9}  {'points':>9}")
    for r in results:
        print(f"{r['rho']:6.1f}  {_fmt(r['rmse'])}  "
              f"{_fmt(r.get('rmse_covered'))}  {_fmt(r.get('rmse_holes'))}  "
              f"{r['coverage']:9.4f}  {r['n_points']:9d}")

    summary = {
        "width": W, "height": H, "backend": args.backend,
        "device": args.device, "capture_seconds": t_capture,
        "gtruth_seconds": t_gtruth, "reproject_seconds": t_reproject,
        "by_rho": {str(r["rho"]): {k: v for k, v in r.items()
                                   if k not in ("rho", "files")}
                   for r in results},
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
