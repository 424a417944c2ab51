"""Ladder frames of two checkouts in turns, each turn a fresh process, then
one profiled frame of each in a fresh process of its own:

    python -m toroidal_ray_tracing_tpu_torch.experiments.config5_turns \\
        --parent DIR [--configs 5 ...] [--pairs 5] [--frames 20] [--out PATH]

A turn is a new Python process with `PYTHONPATH` set to one checkout
(`--parent DIR`, e.g. a `git archive` of another commit unpacked into a
gitignored directory, or this one) and no profiler in it. It builds the
config's scene, moves it to the card, renders frame 0 of the config at its
own size (`render(scene, camera_at(0), width, height, settings,
backend="kernel", spp=spp)`: config 5 is 3840x2160 with 2 spp, the others
1920x1080) 3 times to warm up, then `--frames` times, each frame timed on
the host clock to a `torch.cuda.synchronize()` (config 5: a quarter as many
frames), and counts the launches of each kernel a frame and the rays a
frame. With spp > 1 it also times one jittered sample's draw as that
checkout makes it: the threefry kernel (`ops.threefry_kernel.uniform`)
where the checkout has it, else `utils.prng.uniform` on the card where it
has `utils.prng`, else a host `torch.rand` with a seeded generator and its
copy to the card; median of 10 after a warm-up. Pair p runs the parent
first when p is even and this checkout first when p is odd. After a
config's pairs, one more fresh process a side profiles one frame after the
warm-up (torch.profiler, CPU and CUDA activities): device busy (the CUDA
events' device times summed), the CUDA events, the port's kernels' ms by
name (the kernel names of both checkouts), busy outside them, and the idle
share against that side's median unprofiled frame; its image is saved
under `smoke_out/turns/` and the two sides' images compared (max |diff|,
the pixels that differ), then deleted.

Prints the card's name and power limit, one line a turn, a summary a
config, and one JSON line with every number (also written to `--out`).
Needs an NVIDIA GPU and nvcc. A turn imports only what both checkouts
have.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAG = "TURN "
DRAWS = 10
KERNELS = ("tri_closest_hit", "torus_closest_hit", "torus_closest_hit_small",
           "quad_gather", "tri_closest_hit_stream",
           "tri_closest_hit_stream_grouped", "threefry_uniform", "loose_hit",
           "shade_hit", "shade_finish")

TURN = r"""
import json, re, statistics, sys, time
import torch
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (LAUNCHES,
                                                               reset_launches)

num, frames, profile = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
kernels, image_path = set(sys.argv[4].split(",")), sys.argv[5]
sc = SCENARIOS[num]
w, h = sc.width, sc.height
scene = sc.build().to("cuda")
cam, st = sc.camera_at(0), sc.settings()

def frame():
    out = render(scene, cam, w, h, st, backend="kernel", spp=sc.spp,
                 device="cuda")
    torch.cuda.synchronize()
    return out

for _ in range(3):
    out = frame()
row = dict(config=num, width=w, height=h, spp=sc.spp,
           rays=out["rays_traced"])
if profile:
    from torch.profiler import ProfilerActivity, profile as prof_
    ours = re.compile(r"(\w+)(?:<[^>]*>)?\(")
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        out = frame()
    torch.save(out["image"].cpu(), image_path)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = {}
    for e in dev:
        m = ours.search(e.name.split("::")[-1])
        if m and m.group(1) in kernels:
            r = mine.setdefault(m.group(1), [0.0, 0])
            r[0] += e.time_range.elapsed_us() / 1e3
            r[1] += 1
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    row.update(device_busy_ms=busy if dev else None, cuda_events=len(dev),
               kernels_ms={k: v[0] for k, v in mine.items()},
               kernel_calls={k: v[1] for k, v in mine.items()},
               outside_kernels_ms=(busy - sum(v[0] for v in mine.values())
                                   if dev else None))
else:
    times = []
    reset_launches()
    for _ in range(frames):
        t0 = time.perf_counter()
        frame()
        times.append((time.perf_counter() - t0) * 1e3)
    row.update(ms_per_frame=statistics.median(times), frame_ms=times,
               launches_per_frame={k: v / frames for k, v in
                                   LAUNCHES.items() if v})
    if sc.spp > 1:
        shape = (w * h, 2)
        try:
            from toroidal_ray_tracing_tpu_torch.utils import prng
        except ImportError:
            gen = torch.Generator().manual_seed(0)
            how = "host torch.rand + copy"
            draw = lambda: torch.rand(shape, generator=gen).to("cuda")
        else:
            key = prng.fold_in(prng.prng_key(0), 1)
            try:
                from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel
            except ImportError:
                how = "utils.prng.uniform on the card"
                draw = lambda: prng.uniform(key, shape, "cuda")
            else:
                how = "ops.threefry_kernel.uniform (the CUDA kernel)"
                draw = lambda: threefry_kernel.uniform(key, shape, "cuda")
        times = []
        for i in range(DRAWS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            draw()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        row.update(draw=how, draw_ms=statistics.median(times[1:]))
print("TAG" + json.dumps(row), flush=True)
""".replace("DRAWS", str(DRAWS)).replace("TAG", TAG)


def turn(checkout: str, num: int, frames: int, profile: bool,
         image_path: str = "") -> dict:
    """One turn in a fresh process on `checkout` (a profiled one saves its
    frame's image to image_path)."""
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run(
        [sys.executable, "-c", TURN, str(num), str(frames),
         "1" if profile else "0", ",".join(KERNELS), image_path],
        cwd=checkout, env=env, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
    if proc.returncode or not lines:
        raise RuntimeError(f"turn on {checkout} failed (rc "
                           f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len(TAG):])


def spread(values) -> dict:
    """Median and quartiles."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--configs", type=int, nargs="+", default=[5])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sides = {"parent": os.path.abspath(args.parent), "change": ROOT}
    result = {"device": smi, "pairs": args.pairs, "configs": {}}
    image_dir = os.path.join(ROOT, "smoke_out", "turns")
    os.makedirs(image_dir, exist_ok=True)
    for num in args.configs:
        frames = max(args.frames // 4, 3) if num == 5 else args.frames
        turns: dict = {k: [] for k in sides}
        for p in range(args.pairs):
            order = (["parent", "change"] if p % 2 == 0
                     else ["change", "parent"])
            for side in order:
                row = turn(sides[side], num, frames, False)
                turns[side].append(row)
                draw = (f", draw {row['draw_ms']:.3f} ms ({row['draw']})"
                        if "draw" in row else "")
                print(f"config {num} pair {p} {side}: "
                      f"{row['ms_per_frame']:.2f} ms/frame, {row['rays']} "
                      f"rays{draw}, launches a frame "
                      f"{row['launches_per_frame']}", flush=True)
        cell: dict = {"frames_per_turn": frames, "turns": turns}
        images = {}
        for side in sides:
            ms = spread([r["ms_per_frame"] for r in turns[side]])
            images[side] = os.path.join(image_dir, f"config{num}_{side}.pt")
            prof = turn(sides[side], num, frames, True, images[side])
            busy = prof["device_busy_ms"]
            prof["idle_share"] = (None if busy is None
                                  else 1 - busy / ms["median"])
            cell[side] = {"ms_per_frame": ms, "profile": prof,
                          "rays": turns[side][0]["rays"],
                          "launches_per_frame":
                              turns[side][0]["launches_per_frame"]}
            if "draw" in turns[side][0]:
                cell[side].update(draw=turns[side][0]["draw"], draw_ms=spread(
                    [r["draw_ms"] for r in turns[side]]))
            print(f"config {num} {side}: ms/frame {ms}, profiled frame: "
                  f"busy {busy} ms, outside the port's kernels "
                  f"{prof['outside_kernels_ms']} ms, {prof['cuda_events']} "
                  f"CUDA events, idle {prof['idle_share']}, kernels "
                  f"{prof['kernels_ms']} ({smi})", flush=True)
        cell["change_faster"] = sum(
            c["ms_per_frame"] < p["ms_per_frame"]
            for p, c in zip(turns["parent"], turns["change"]))
        cell["rays_equal"] = cell["parent"]["rays"] == cell["change"]["rays"]
        a, b = (torch.load(images[k]) for k in sides)
        for path in images.values():
            os.remove(path)
        diff = (a - b).abs()
        cell["image_max_abs_diff"] = float(diff.max())
        cell["image_pixels_differing"] = int((diff.amax(dim=-1) > 0).sum())
        print(f"config {num}: rays equal {cell['rays_equal']}, image max "
              f"|diff| {cell['image_max_abs_diff']:.3e}, "
              f"{cell['image_pixels_differing']} pixels differ", flush=True)
        result["configs"][str(num)] = cell
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
