"""A ladder frame (config 3's 512x512, the K3 cell of chip_smoke phase 4,
by default) timed on the card for the package on the import path, so that
two checkouts can be timed in turns in one call:

    PYTHONPATH=<checkout> python <path of this file> [frames]
        [--config N] [--res WxH]

(run as a file, it imports the `toroidal_ray_tracing_tpu_torch` that
PYTHONPATH names; this file itself may come from another checkout). The
scene is built and moved to the card once, as chip_smoke does; each frame
is `render(..., backend="kernel", device="cuda")` timed on the host clock
to a `torch.cuda.synchronize()`, after 3 warm-up frames. Also times the
render front door's `_setup` alone (device check, scene and settings onto
the card), over 2,000 calls. Only names that every checkout of the port
shares are used. Needs an NVIDIA GPU and nvcc. Prints the card's name and
power limit, then one JSON line.

    python <path of this file> [frames] kept [pairs] [--config N]
        [--res WxH]

times the kernel tables' lookup (`ops.trace_kernel._kept`) two ways in
one process instead, in `pairs` pairs (12 by default) of windows in turns
(A B, B A, A B, ...): A as the package has it (each query stamps its
source tensors' memory, shape, strides and `_version`), B with an entry
found under its key used as it is (no stamp). A window is `frames`
renders ended by one `torch.cuda.synchronize()`, the protocol of
`experiments.configs.run_scenario`. Also counts `_kept`'s calls a frame
and times one call that finds its entry (microseconds, over 20,000
calls, for each table name the frame looks up). One JSON line: each
way's ms a frame per pair, their medians and quartiles, the pairs each
way won, and the lookups.
"""

from __future__ import annotations

import argparse
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

SETUP_CALLS = 2000
KEPT_CALLS = 20000


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", type=int, nargs="?", default=30)
    ap.add_argument("mode", nargs="?", choices=["kept"])
    ap.add_argument("pairs", type=int, nargs="?", default=12)
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--res", default="512x512")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    frames = args.frames
    w, h = (int(x) for x in args.res.split("x"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    sc = SCENARIOS[args.config]
    scene = sc.build().to("cuda")
    cam, st = sc.camera, sc.settings()
    cell = f"config{args.config} {w}x{h}"

    def frame():
        out = render(scene, cam, w, h, st, backend="kernel", device="cuda")
        torch.cuda.synchronize()
        return out

    for _ in range(3):
        out = frame()
    if args.mode == "kept":
        print(json.dumps(dict(cell=cell, frames_per_window=frames,
                              pairs=args.pairs,
                              **_kept_turns(frame, frames, args.pairs))),
              flush=True)
        return 0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        frame()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(SETUP_CALLS):
        renderer._setup(scene, st, cam, w, h, "cuda")
    setup_us = (time.perf_counter() - t0) * 1e6 / SETUP_CALLS
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        renderer.__file__)))
    print(json.dumps({
        "package": root, "cell": cell,
        "rays": out["rays_traced"], "frames": frames,
        "median_ms": statistics.median(times), "min_ms": min(times),
        "max_ms": max(times), "frame_ms": times,
        "setup_us": setup_us}), flush=True)
    return 0


def _kept_turns(frame, frames: int, pairs: int) -> dict:
    """`_kept` as it is against `_kept` without its stamp, in turns."""
    from toroidal_ray_tracing_tpu_torch.ops import trace_kernel

    stamped = trace_kernel._kept

    def unstamped(scene, name, part, sources, make):
        entry = scene.kernel_tables.get((name, scene.device, *part))
        return (entry[2] if entry is not None
                else stamped(scene, name, part, sources, make))

    calls = []

    def counting(scene, name, part, sources, make):
        calls.append((scene, name, part, tuple(sources)))
        return stamped(scene, name, part, sources, make)

    trace_kernel._kept = counting
    frame()
    trace_kernel._kept = stamped
    lookup_us = {}
    for scene, name, part, sources in {c[1:3]: c for c in calls}.values():
        t0 = time.perf_counter()
        for _ in range(KEPT_CALLS):
            stamped(scene, name, part, sources, None)
        lookup_us[f"{name} ({len(sources)} tensors)"] = (
            (time.perf_counter() - t0) * 1e6 / KEPT_CALLS)
    ways = {"stamped": stamped, "unstamped": unstamped}
    per_frame = {k: [] for k in ways}
    try:
        for p in range(pairs):
            order = list(ways) if p % 2 == 0 else list(ways)[::-1]
            for way in order:
                trace_kernel._kept = ways[way]
                t0 = time.perf_counter()
                for _ in range(frames):
                    frame()
                per_frame[way].append(
                    (time.perf_counter() - t0) * 1e3 / frames)
    finally:
        trace_kernel._kept = stamped
    a, b = per_frame["stamped"], per_frame["unstamped"]
    return {
        "kept_calls_per_frame": len(calls), "kept_hit_us": lookup_us,
        "ms_per_frame": per_frame,
        "median_ms": {k: statistics.median(v) for k, v in per_frame.items()},
        "quartiles_ms": {k: statistics.quantiles(v, n=4)
                         for k, v in per_frame.items()},
        "stamped_won": sum(x < y for x, y in zip(a, b)),
        "unstamped_won": sum(y < x for x, y in zip(a, b))}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
