"""App-2 script: point-cloud reprojection of a toroidal capture (the port of
the JAX package's `experiments/reproject.py`; the same files and stats).

Replicates VKT/ray_tracing__before_second: load one rho step's position +
color dumps (`loadPoints`, hello_vulkan.cpp:496-628), splat them from a
pinhole camera, and dump `data/<scene>ptCloudImage_10.txt`
(hello_vulkan.cpp:781-826). Also compares against a gTruth dump when present
(the comparison the reference did outside its repository).

Run: python -m toroidal_ray_tracing_tpu_torch.experiments.reproject
--capture DIR [--all-rhos] (splats on the CUDA device; --device cpu for the
CPU).
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.io import dumps, png
from toroidal_ray_tracing_tpu_torch.pointcloud.splat import (POINT_SIZE,
                                                             splat_points)
from toroidal_ray_tracing_tpu_torch.render.renderer import tonemap


def run_reproject(capture_dir: str, rho: float, scene_name: str,
                  camera: PinholeCamera | None = None,
                  width: int = 1920, height: int = 1080,
                  capture_width: int = 1920, capture_height: int = 1080,
                  out_dir: str | None = None, save_png: bool = True,
                  tag: str = "10", point_size: float | None = None,
                  fill_holes: float = 0.0, device="cuda"):
    """Returns (image, written_files, stats); image is a host (H, W, 3)
    float32 array. Raises if the dumps are missing or mismatched (app 2
    throws on length mismatch, hello_vulkan.cpp:636-639).

    stats separates splat sparsity from renderer error: n_points
    (surviving cloud points), coverage (fraction of pixels some point
    won), and, when a gTruth dump exists in out_dir/data, rmse (all
    pixels), rmse_covered (splat-won pixels only) and rmse_holes
    (uncovered pixels: splat background against gTruth). stats["rmse"] is
    None without gTruth.

    point_size overrides the reference's 2.5 px; fill_holes > point_size
    adds the depth-aware hole-filling second splat (splat_points)."""
    if camera is None:
        camera = PinholeCamera(eye=(10.0, 0.0, 0.0), center=(0.0, 0.0, 0.0))
    out_dir = out_dir or capture_dir
    pos, col = dumps.read_position_color(capture_dir, rho,
                                         capture_width, capture_height)
    img, cover, n_points = splat_points(
        pos, col, camera, width, height,
        point_size=POINT_SIZE if point_size is None else point_size,
        fill_holes=fill_holes, return_cover=True, device=device)
    img_np = img.cpu().numpy()
    cover_np = cover.cpu().numpy()
    written = [dumps.write_ptcloud_image(out_dir, scene_name, img_np,
                                         tag=tag)]
    if save_png:
        written.append(png.save_png(
            os.path.join(out_dir, f"{scene_name}ptCloudImage_{tag}.png"),
            tonemap(img).cpu().numpy()))

    stats = {"rho": rho, "n_points": int(n_points),
             "coverage": float(cover_np.mean()), "rmse": None}
    gtruth_path = os.path.join(out_dir, "data", f"{scene_name}gTruth.txt")
    if os.path.exists(gtruth_path):
        gt = dumps.read_points(gtruth_path).reshape(height, width, 3)
        err2 = np.sum((img_np - gt) ** 2, axis=2) / 3.0
        stats["rmse"] = float(np.sqrt(err2.mean()))
        if cover_np.any():
            stats["rmse_covered"] = float(np.sqrt(err2[cover_np].mean()))
        if (~cover_np).any():
            stats["rmse_holes"] = float(np.sqrt(err2[~cover_np].mean()))
    return img_np, written, stats


def capture_rhos(capture_dir: str) -> list:
    """Every rho step captured under `capture_dir/data` — the batch analog
    of app 2's hard-coded 19-rho filename list
    (before_second/hello_vulkan.cpp:499-527), derived from the files on
    disk."""
    rhos = []
    for p in glob.glob(os.path.join(capture_dir, "data",
                                    "renderedPosition*.txt")):
        m = re.fullmatch(r"renderedPosition([0-9.+-eE]+)\.txt",
                         os.path.basename(p))
        if m:
            rhos.append(float(m.group(1)))
    return sorted(set(rhos))


def run_reproject_all(capture_dir: str, scene_name: str,
                      camera: PinholeCamera | None = None,
                      width: int = 1920, height: int = 1080,
                      capture_width: int = 1920, capture_height: int = 1080,
                      out_dir: str | None = None, save_png: bool = True,
                      point_size: float | None = None,
                      fill_holes: float = 0.0, device="cuda"):
    """Reproject EVERY rho dump found in the capture dir (app 2's batch
    workflow across rho steps, before_second/hello_vulkan.cpp:499-527).

    Returns a list of {rho, files, rmse, rmse_covered, rmse_holes,
    coverage, n_points} result rows (the rmse fields are None or absent
    when no gTruth dump exists)."""
    rhos = capture_rhos(capture_dir)
    if not rhos:
        raise FileNotFoundError(
            f"no renderedPosition*.txt dumps under {capture_dir}/data")
    results = []
    for rho in rhos:
        tag = dumps.rho_tag(rho).rstrip("0").rstrip(".") or "0"
        _, files, stats = run_reproject(
            capture_dir, rho, scene_name, camera, width, height,
            capture_width, capture_height, out_dir, save_png, tag=tag,
            point_size=point_size, fill_holes=fill_holes, device=device)
        results.append({**stats, "files": files})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--capture", required=True, help="dir with data/ dumps")
    ap.add_argument("--rho", type=float, default=10.0)
    ap.add_argument("--all-rhos", action="store_true",
                    help="reproject every rho dump found in the capture dir "
                         "and print a summary RMSE table")
    ap.add_argument("--name", default="scene")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--capture-width", type=int, default=1920)
    ap.add_argument("--capture-height", type=int, default=1080)
    ap.add_argument("--eye", type=float, nargs=3, default=(10.0, 0.0, 0.0))
    ap.add_argument("--center", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--point-size", type=float, default=None,
                    help="splat size in px (default: the reference's 2.5)")
    ap.add_argument("--fill-holes", type=float, default=0.0,
                    help="> point-size: depth-aware hole-filling second "
                         "splat pass")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cam = PinholeCamera(eye=tuple(args.eye), center=tuple(args.center))
    if args.all_rhos:
        results = run_reproject_all(
            args.capture, args.name, cam, args.width, args.height,
            args.capture_width, args.capture_height,
            point_size=args.point_size, fill_holes=args.fill_holes,
            device=args.device)
        print(f"{'rho':>8}  {'RMSE vs gTruth':>15}  {'coverage':>9}  files")
        for r in results:
            rm = f"{r['rmse']:.6g}" if r["rmse"] is not None else "-"
            print(f"{r['rho']:8.2f}  {rm:>15}  {r['coverage']:9.4f}  "
                  f"{len(r['files'])}")
        return
    _, files, stats = run_reproject(
        args.capture, args.rho, args.name, cam, args.width, args.height,
        args.capture_width, args.capture_height,
        point_size=args.point_size, fill_holes=args.fill_holes,
        device=args.device)
    rmse = stats["rmse"]
    print(f"wrote {files}; coverage {stats['coverage']:.4f}"
          + (f"; RMSE vs gTruth: {rmse:.4g}" if rmse is not None else ""))


if __name__ == "__main__":
    main()
