"""Headline benchmark of the port: Mrays/s of config 3 (1080p, 3 bounces,
4 reflective tori) as a 16-frame `render_sequence` on backend="kernel".

    python -m toroidal_ray_tracing_tpu_torch.bench [--frames 16]
        [--ladder [PATH]] [--backend kernel] [--device cuda]

Prints ONE JSON line: metric, value (Mrays/s), unit, mfu, cull_speedup,
window_ms and device (the card's name and power limit, as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them).

Protocol (`experiments.configs.run_scenario`): one warm-up call, then 3
timed windows of the whole call, each ended by `torch.cuda.synchronize()`;
Mrays/s from the median window; window_ms = [min, median, max].

Ray accounting is the reference's traceRayEXT semantics: one closest-hit
query per live ray per bounce plus one shadow ray per lit hit
(raytrace.rgen:75-108, raytrace.rchit:89-120), counted by the bounce loop.

mfu (`utils.roofline`) is a utilization: Mrays/s x the post-cull work
model (the JAX kernels' box gates on the scenario's primary rays) over the
H100's f32 peak, capped at 1.0. The work the culling removes is
cull_speedup (brute-force / post-cull modeled work).

--ladder writes every ladder config (1-8) to PATH (default
smoke_out/ladder_h100.json at the repository root): per config the
front-door row (`render_frames`) and the sequence row, at the JAX
package's frame counts, with mfu, mfu_sequence, cull_speedup and both
rows' window_ms.

There is no fallback: with no CUDA device, or a kernel that fails to
build or launch, the bench raises and exits 1 without a result line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
from toroidal_ray_tracing_tpu_torch.experiments import configs
from toroidal_ray_tracing_tpu_torch.render.renderer import check_device
from toroidal_ray_tracing_tpu_torch.utils import roofline

HEADLINE_FRAMES = 16
# frames of the front-door row (default 6; animated configs: their own)
# and of the sequence row (default 16), as the JAX package's ladder
FRONT_FRAMES = {1: 240, 2: 24, 4: 24}
SEQ_FRAMES = {1: 240, 2: 60, 3: 16, 4: 16, 5: 8, 6: 16, 8: 4}
LADDER_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "smoke_out", "ladder_h100.json")
PROTOCOL = ("one warm-up call, then 3 timed windows of the whole call, each "
            "ended by torch.cuda.synchronize(); rates from the median "
            "window; window_ms = [min, median, max]. mrays_per_s = "
            "front-door render_frames batch (per-frame images and dumps); "
            "mrays_per_s_sequence = render_sequence over an orbit (no "
            "per-frame outputs); mfu = post-cull work model over the H100 "
            "f32 peak (67 TFLOP/s), capped at 1.0; cull_speedup = "
            "brute-force / post-cull modeled work")


def card(device) -> str:
    """The device a result ran on: for a CUDA device, its name and power
    limit as nvidia-smi reports them; else the device type."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _scenario_rays(sc, device):
    """The scenario's primary rays ((N, 3) origins, dirs) on `device`, for
    the post-cull roofline model."""
    return generate_rays(sc.camera_at(0), sc.width, sc.height,
                         sc.settings(), device=device)


def _roofline(num, device):
    """(scene, primary rays) of ladder config `num`."""
    sc = configs.SCENARIOS[num]
    return sc.build(), _scenario_rays(sc, device)


def headline(frames: int = HEADLINE_FRAMES, backend: str = "kernel",
             device="cuda") -> dict:
    """The headline row: config 3's `frames`-frame sequence."""
    device = check_device(device)
    _, stats = configs.run_scenario(3, backend=backend, frames=frames,
                                    sequence=True, device=device)
    scene, rays = _roofline(3, device)
    value = stats["mrays_per_s"]
    return {
        "metric": f"Mrays/s @1080p 3-bounce reflective (config 3, "
                  f"{frames}-frame render_sequence, {backend} backend, "
                  "median of 3 synchronized windows)",
        "value": value,
        "unit": "Mrays/s",
        "mfu": roofline.mfu(value, scene, rays=rays),
        "cull_speedup": roofline.cull_speedup(scene, rays),
        "window_ms": stats["window_ms"],
        "rays_per_frame": stats["rays_per_frame"],
        "device": card(device),
    }


def write_ladder(path: str, head: dict, backend: str = "kernel",
                 device="cuda") -> dict:
    """Run the front-door and sequence rows of every ladder config and
    write them, with the headline `head`, to `path` as JSON."""
    device = check_device(device)
    rows = []
    for n in sorted(configs.SCENARIOS):
        sc = configs.SCENARIOS[n]
        scene, rays = _roofline(n, device)
        frames = None if sc.animate_frames else FRONT_FRAMES.get(n, 6)
        _, row = configs.run_scenario(n, backend=backend, frames=frames,
                                      device=device)
        row["mfu"] = roofline.mfu(row["mrays_per_s"], scene, rays=rays)
        _, seq = configs.run_scenario(n, backend=backend,
                                      frames=SEQ_FRAMES.get(n, 16),
                                      sequence=True, device=device)
        row["frames_sequence"] = seq["frames"]
        row["mrays_per_s_sequence"] = seq["mrays_per_s"]
        row["window_ms_sequence"] = seq["window_ms"]
        row["mfu_sequence"] = roofline.mfu(seq["mrays_per_s"], scene,
                                           rays=rays)
        row["cull_speedup"] = roofline.cull_speedup(scene, rays)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    out = {
        "protocol": PROTOCOL,
        "backend": backend,
        "device": card(device),
        "torch": torch.__version__,
        "headline_mrays_per_s_per_chip": head["value"],
        "headline_mfu": head["mfu"],
        "headline_cull_speedup": head["cull_speedup"],
        "headline_window_ms": head["window_ms"],
        "ladder": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=HEADLINE_FRAMES)
    ap.add_argument("--backend", default="kernel", choices=["kernel", "torch"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ladder", nargs="?", const=LADDER_PATH, default=None,
                    metavar="PATH", help="also write the ladder of configs "
                    "1-8 (default path: smoke_out/ladder_h100.json)")
    args = ap.parse_args(argv)
    head = headline(args.frames, args.backend, args.device)
    if args.ladder:
        write_ladder(args.ladder, head, args.backend, args.device)
        print(json.dumps({"ladder_written": args.ladder}), file=sys.stderr)
    print(json.dumps(head), flush=True)
    return head


if __name__ == "__main__":
    main()
