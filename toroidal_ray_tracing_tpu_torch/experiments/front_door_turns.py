"""The render front doors of one ladder config timed in turns in one
process, so that what a window costs on each path can be told apart from
what a process costs:

    python -m toroidal_ray_tracing_tpu_torch.experiments.front_door_turns \\
        [config] [frames] [rounds]

(defaults 3, 6, 10). Each path renders `frames` frames of the config's
camera at its size on backend="kernel" in one window ended by
`torch.cuda.synchronize()` (the protocol of `experiments.configs.
run_scenario`), after one warm-up window per path:

  render_sync   `render` of the card's scene, a synchronize after each
                frame (chip_smoke phase 4's timing);
  render        `render` of the card's scene, one synchronize at the end;
  render_host   `render` of the host scene (copied to the card once);
  frames_dumps  `render_frames` of the host scene with the dump buffers
                (run_scenario's front door);
  frames        `render_frames` without the dump buffers;
  sequence      `render_sequence(..., keep_images=False)` (run_scenario's
                sequence mode, here over the same camera).

The paths run in a rotated order each round. Needs an NVIDIA GPU. Prints
the card's name and power limit, then one JSON line: each path's ms a
frame per round, and their medians.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from toroidal_ray_tracing_tpu_torch import (render, render_frames,
                                            render_sequence)
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    num = int(argv[0]) if argv else 3
    frames = int(argv[1]) if argv[1:] else 6
    rounds = int(argv[2]) if argv[2:] else 10
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    sc = SCENARIOS[num]
    host = sc.build()
    on_card = host.to("cuda")
    cam, st, w, h = sc.camera, sc.settings(), sc.width, sc.height
    cams = [cam] * frames
    kw = dict(backend="kernel", device="cuda")

    def render_sync():
        for _ in range(frames):
            render(on_card, cam, w, h, st, **kw)
            torch.cuda.synchronize()

    paths = {
        "render_sync": render_sync,
        "render": lambda: [render(on_card, cam, w, h, st, **kw)
                           for _ in range(frames)],
        "render_host": lambda: [render(host, cam, w, h, st, **kw)
                                for _ in range(frames)],
        "frames_dumps": lambda: render_frames(host, cams, w, h, st, **kw),
        "frames": lambda: render_frames(host, cams, w, h, st, dumps=False,
                                        **kw),
        "sequence": lambda: render_sequence(host, cams, w, h, st,
                                            keep_images=False, **kw),
    }
    names = list(paths)
    ms = {k: [] for k in names}
    for r in range(rounds + 1):
        for k in names[r % len(names):] + names[:r % len(names)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = paths[k]()
            torch.cuda.synchronize()
            if r:                                  # round 0 warms up
                ms[k].append((time.perf_counter() - t0) * 1e3 / frames)
            del out
    print(json.dumps({
        "config": sc.name, "width": w, "height": h, "frames": frames,
        "rounds": rounds, "ms_per_frame": ms,
        "median_ms": {k: statistics.median(v) for k, v in ms.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
