"""Config 3's 512x512 frame (the K3 cell of chip_smoke phase 4) timed on
the card for the package on the import path, so that two checkouts can be
timed in turns in one call:

    PYTHONPATH=<checkout> python <path of this file> [frames]

(run as a file, it imports the `toroidal_ray_tracing_tpu_torch` that
PYTHONPATH names; this file itself may come from another checkout). The
scene is built and moved to the card once, as chip_smoke does; each frame
is `render(..., backend="kernel", device="cuda")` timed on the host clock
to a `torch.cuda.synchronize()`, after 3 warm-up frames. Also times the
render front door's `_setup` alone (device check, scene and settings onto
the card), over 2,000 calls. Only names that every checkout of the port
shares are used. Needs an NVIDIA GPU and nvcc. Prints the card's name and
power limit, then one JSON line.

    python <path of this file> [frames] ab [pairs]

times both ways of `_setup` in one process instead, in `pairs` pairs (12
by default) of windows in turns (A B, B A, A B, ...): A as the package has
it (a scene already on the card is used as it is), B with the scene copied
at every call (`Scene.to`, what `_setup` did before `_as_device_scene`).
A window is `frames` renders ended by one `torch.cuda.synchronize()`, the
protocol of `experiments.configs.run_scenario`. Needs a checkout that has
`_as_device_scene`. One JSON line: each way's ms a frame per pair, their
medians and quartiles, and the pairs each way won.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.render import renderer

RES = 512
SETUP_CALLS = 2000


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    frames = int(argv[0]) if argv else 30
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    sc = SCENARIOS[3]
    scene = sc.build().to("cuda")
    cam, st = sc.camera, sc.settings()

    def frame():
        out = render(scene, cam, RES, RES, st, backend="kernel",
                     device="cuda")
        torch.cuda.synchronize()
        return out

    def timed(n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            frame()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    for _ in range(3):
        out = frame()
    if argv[1:2] == ["ab"]:
        pairs = int(argv[2]) if argv[2:] else 12
        as_is = renderer._as_device_scene
        ways = {"as_is": as_is,
                "copy_per_call": lambda scene, device: scene.to(device)}
        per_frame = {k: [] for k in ways}
        for p in range(pairs):
            order = list(ways) if p % 2 == 0 else list(ways)[::-1]
            for way in order:
                renderer._as_device_scene = ways[way]
                t0 = time.perf_counter()
                for _ in range(frames):
                    render(scene, cam, RES, RES, st, backend="kernel",
                           device="cuda")
                torch.cuda.synchronize()
                per_frame[way].append(
                    (time.perf_counter() - t0) * 1e3 / frames)
        renderer._as_device_scene = as_is
        a, b = per_frame["as_is"], per_frame["copy_per_call"]
        print(json.dumps({
            "cell": f"config3 {RES}x{RES}", "frames_per_window": frames,
            "pairs": pairs, "ms_per_frame": per_frame,
            "median_ms": {k: statistics.median(v)
                          for k, v in per_frame.items()},
            "quartiles_ms": {k: statistics.quantiles(v, n=4)
                             for k, v in per_frame.items()},
            "as_is_won": sum(x < y for x, y in zip(a, b)),
            "copy_per_call_won": sum(y < x for x, y in zip(a, b))}),
            flush=True)
        return 0
    times = timed(frames)
    t0 = time.perf_counter()
    for _ in range(SETUP_CALLS):
        renderer._setup(scene, st, cam, RES, RES, "cuda")
    setup_us = (time.perf_counter() - t0) * 1e6 / SETUP_CALLS
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        renderer.__file__)))
    print(json.dumps({
        "package": root, "cell": f"config3 {RES}x{RES}",
        "rays": out["rays_traced"], "frames": frames,
        "median_ms": statistics.median(times), "min_ms": min(times),
        "max_ms": max(times), "frame_ms": times,
        "setup_us": setup_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
