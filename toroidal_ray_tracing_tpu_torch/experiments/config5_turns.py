"""Config 5's front door in two checkouts, in turns, each turn a fresh
process:

    python -m toroidal_ray_tracing_tpu_torch.experiments.config5_turns \\
        --parent DIR [--pairs 5] [--out PATH]

Each turn is a new Python process with `PYTHONPATH` set to one checkout
(`--parent DIR`, e.g. a `git archive` of another commit unpacked into a
gitignored directory, or this one) and no profiler in it. It runs
`run_scenario(5, backend="kernel")` (3840x2160, 2 spp, 8 fly-through
frames through `render_frames`; one warm-up call and 3 timed windows) and
counts the launches of each kernel a frame. It also times one jittered
sample's draw as that checkout makes it: the threefry kernel
(`ops.threefry_kernel.uniform`) where the checkout has it, else
`utils.prng.uniform` on the card where it has `utils.prng`, else a host
`torch.rand` with a seeded generator and its copy to the card; host clock
to a `torch.cuda.synchronize()`, median of 10 after a warm-up. Pair p runs
the parent first when p is even and this checkout first when p is odd.

Prints the card's name and power limit, one line a turn, then for each
side ms/frame and Mrays/s (median and quartiles over the turns' median
windows), the draw's ms and the launches a frame, and one JSON line with
every number (also written to `--out`). Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAG = "TURN "
DRAWS = 10

# The turn's body: it imports only what both checkouts have.
TURN = r"""
import json, statistics, sys, time
import torch
from toroidal_ray_tracing_tpu_torch.experiments import configs
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (LAUNCHES,
                                                               reset_launches)

sc = configs.SCENARIOS[5]
shape = (sc.width * sc.height, 2)
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
reset_launches()
_, st = configs.run_scenario(5, backend="kernel")
calls = (1 + configs.WINDOWS) * st["frames"]
print("TAG" + json.dumps(dict(
    draw=how, draw_ms=statistics.median(times[1:]),
    ms_per_frame=st["window_ms"][1] / st["frames"],
    window_ms=st["window_ms"], mrays_per_s=st["mrays_per_s"],
    rays_per_frame=st["rays_per_frame"],
    launches_per_frame={k: v / calls for k, v in LAUNCHES.items() if v})),
    flush=True)
""".replace("DRAWS", str(DRAWS)).replace("TAG", TAG)


def turn(checkout: str) -> dict:
    """One turn in a fresh process on `checkout`."""
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=checkout,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
    if proc.returncode or not lines:
        raise RuntimeError(f"turn on {checkout} failed (rc "
                           f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len(TAG):])


def spread(values) -> dict:
    """Median and quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sides = {"parent": os.path.abspath(args.parent), "change": ROOT}
    turns: dict = {k: [] for k in sides}
    for p in range(args.pairs):
        order = ["parent", "change"] if p % 2 == 0 else ["change", "parent"]
        for side in order:
            row = turn(sides[side])
            turns[side].append(row)
            print(f"pair {p} {side}: {row['ms_per_frame']:.2f} ms/frame, "
                  f"{row['mrays_per_s']:.1f} Mrays/s, draw "
                  f"{row['draw_ms']:.2f} ms ({row['draw']}), launches a "
                  f"frame {row['launches_per_frame']}", flush=True)
    summary = {}
    for side, rows in turns.items():
        summary[side] = {
            "ms_per_frame": spread([r["ms_per_frame"] for r in rows]),
            "mrays_per_s": spread([r["mrays_per_s"] for r in rows]),
            "draw_ms": spread([r["draw_ms"] for r in rows]),
            "draw": rows[0]["draw"],
            "launches_per_frame": rows[0]["launches_per_frame"],
            "rays_per_frame": rows[0]["rays_per_frame"]}
        s = summary[side]
        print(f"{side}: ms/frame {s['ms_per_frame']}, Mrays/s "
              f"{s['mrays_per_s']}, draw ms {s['draw_ms']}, launches a "
              f"frame {s['launches_per_frame']} ({smi})", flush=True)
    faster = sum(c["ms_per_frame"] < p["ms_per_frame"]
                 for p, c in zip(turns["parent"], turns["change"]))
    result = {"device": smi, "pairs": args.pairs, "change_faster": faster,
              "summary": summary, "turns": turns}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
