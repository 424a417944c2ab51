"""Ladder frames of two checkouts in turns, each turn a fresh process, then
one profiled frame of each in a fresh process of its own:

    python -m toroidal_ray_tracing_tpu_torch.experiments.config5_turns \\
        --parent DIR [--configs 5 ... capture] [--pairs 5] [--frames 20] \\
        [--out PATH]

A turn is a new Python process with `PYTHONPATH` set to one checkout
(`--parent DIR`, e.g. a `git archive` of another commit unpacked into a
gitignored directory, or this one) and no profiler in it. It builds the
config's scene, moves it to the card, renders frame 0 of the config at its
own size (`render(scene, camera_at(0), width, height, settings,
backend="kernel", spp=spp)`: config 5 is 3840x2160 with 2 spp, the others
1920x1080; `capture` is the capture cell, the cornellish scene through the
toroidal camera from (0, 1, 0) to (8, 0, 0), rho 4, depth 10, at
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

The profiled frame also files the device time outside the port's kernels
by the front-door stage that issued it (`StageTags`, a TorchFunctionMode:
each torch call made from Python runs in a profiler range named by the
stage of the innermost frame of the port's package on the stack; an op's
own device time goes to its range's stage):

  raygen       `cameras/` and R1's wrappers and twins
  state init   `new_state`, `fill_state_plain`, and the lines of a bounce
               loop's function before its `while`
  compaction   `span_order`, G1's wrapper and twin, and, in the loop, the
               `if` block that sets `nb` (the bucket shrink)
  unpermute    `unpermute_rows`, and the loop function's lines after the
               `while`
  frame end    `block_unswizzle`, F1's wrapper and twin, and the rest of
               `render/renderer.py` (the unswizzle, the spp accumulation,
               the stacking)
  visit order  `visit_order`, `tree_rank` and the visit-rank kernel V1's
               wrappers (`ops/visit_kernel.py`, `segment_ranks`)
  anchor       `batch_anchor`
  query folds  the torch ops of `ops/trace_kernel.py`'s `_query` and
               `occluded_kernel` (the tmax folds and occlusion masks
               between a query's kernels)
  loop         every other op: the kernel wrappers' tables and buffers,
               the loop's tmax and prefix copies

The loop's regions come from its syntax tree (`loop_regions`), so the
rule reads a checkout's own code as it stands; `span_lanes` is filed by
its caller. The stages add up to busy outside the port's kernels (an op
no frame of the package issued is "other").

Prints the card's name and power limit, one line a turn, a summary a
config, and one JSON line with every number (also written to `--out`).
Needs an NVIDIA GPU and nvcc. A turn imports only what both checkouts
have.
"""

from __future__ import annotations

import argparse
import ast
import functools
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
           "shade_hit", "shade_finish", "raygen", "span_gather",
           "frame_finish", "visit_rank")

STAGES = ("raygen", "state init", "compaction", "unpermute", "frame end",
          "visit order", "anchor", "query folds", "loop", "other")
MARK = "stage:"                   # the prefix of a stage's profiler range
PKG = "toroidal_ray_tracing_tpu_torch" + os.sep
BY_FUNCTION = {
    "raygen": ("raygen", "raygen_plain", "raygen_state",
               "raygen_state_plain"),
    "state init": ("new_state", "fill_state_plain", "init_state"),
    "compaction": ("span_order", "span_gather", "span_gather_plain"),
    "unpermute": ("unpermute_rows",),
    "frame end": ("block_unswizzle", "frame_finish", "frame_finish_plain"),
    "visit order": ("visit_order", "tree_rank", "visit_ranks",
                    "visit_ranks_plain", "visit_rank", "segment_ranks"),
    "anchor": ("batch_anchor",),
    "query folds": ("_query", "occluded_kernel"),
}


@functools.lru_cache(maxsize=None)
def loop_regions(path: str) -> dict:
    """{function: (first line, last line of its bounce loop (its first
    `while`), [(first, last line) of each `if` in the loop whose own body
    sets nb])} for the functions of the file at path that hold a loop."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        loop = next((n for n in ast.walk(fn) if isinstance(n, ast.While)),
                    None)
        if loop is None:
            continue
        shrinks = [(n.lineno, n.end_lineno) for n in ast.walk(loop)
                   if isinstance(n, ast.If) and any(
                       isinstance(st, ast.Assign) and any(
                           isinstance(t, ast.Name) and t.id == "nb"
                           for t in st.targets) for st in n.body)]
        out[fn.name] = (loop.lineno, loop.end_lineno, shrinks)
    return out


def stage_here(frame) -> str:
    """The stage of the torch call made from `frame`: that of the innermost
    frame of the port's package on the stack (module docstring)."""
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        func = f.f_code.co_name
        if (PKG not in path or func == "span_lanes"
                or "experiments" + os.sep in path):
            f = f.f_back
            continue
        rel = path.split(PKG, 1)[1].replace(os.sep, "/")
        for stage, funcs in BY_FUNCTION.items():
            if func in funcs:
                return stage
        if rel.startswith("cameras/"):
            return "raygen"
        if rel == "render/renderer.py":
            return "loop" if func == "_setup" else "frame end"
        region = (loop_regions(path).get(func)
                  if rel == "trace/wavefront.py" else None)
        if region is None:
            return "loop"
        first, last, shrinks = region
        line = f.f_lineno
        if line < first:
            return "state init"
        if line > last:
            return "unpermute"
        if any(a <= line <= b for a, b in shrinks):
            return "compaction"
        return "loop"
    return "other"


class StageTags(torch.overrides.TorchFunctionMode):
    """Runs every torch call made from Python in a profiler range named by
    its stage, so each op's device time can be filed under it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        stage = stage_here(sys._getframe(1))
        with torch.profiler.record_function(MARK + stage):
            return func(*args, **(kwargs or {}))


def stage_split(events, device_time: bool = True) -> dict:
    """{stage: {ms, device_events, ops}}: each CPU op's own device time
    (host time with device_time False) under its innermost stage range."""
    stages = {s: dict(ms=0.0, device_events=0, ops=0) for s in STAGES}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                or e.name.startswith(MARK)):
            continue
        ms = (e.self_device_time_total if device_time
              else e.self_cpu_time_total) / 1e3
        if ms <= 0 and not e.kernels:
            continue
        p = e
        while p is not None and not p.name.startswith(MARK):
            p = p.cpu_parent
        row = stages[p.name[len(MARK):] if p is not None else "other"]
        row["ms"] += ms
        row["device_events"] += len(e.kernels)
        row["ops"] += 1
    return stages


TURN = r"""
import importlib.util, json, re, statistics, sys, time
import torch
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (LAUNCHES,
                                                               reset_launches)

num, frames, profile = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
kernels, image_path = set(sys.argv[4].split(",")), sys.argv[5]
spec = importlib.util.spec_from_file_location("turns_stages", sys.argv[6])
stages = importlib.util.module_from_spec(spec)
spec.loader.exec_module(stages)
if num == "capture":
    from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)
    scene = build_scene(procedural.scene_cornellish()).to("cuda")
    cam = ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0))
    st, w, h, spp = RenderSettings.default(rho=4.0), 1920, 1080, 1
else:
    sc = SCENARIOS[int(num)]
    w, h, spp = sc.width, sc.height, sc.spp
    scene = sc.build().to("cuda")
    cam, st = sc.camera_at(0), sc.settings()

def frame():
    out = render(scene, cam, w, h, st, backend="kernel", spp=spp,
                 device="cuda")
    torch.cuda.synchronize()
    return out

for _ in range(3):
    out = frame()
row = dict(config=num, width=w, height=h, spp=spp,
           rays=out["rays_traced"])
if profile:
    from torch.profiler import ProfilerActivity, profile as prof_
    ours = re.compile(r"(\w+)(?:<[^>]*>)?\(")
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof, \
            stages.StageTags():
        out = frame()
    torch.save(out["image"].cpu(), image_path)
    # (a stage range's own span on the device timeline is no device work)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(stages.MARK)]
    mine = {}
    for e in dev:
        m = ours.search(e.name.replace("(anonymous namespace)", ""))
        if m and m.group(1) in kernels:
            r = mine.setdefault(m.group(1), [0.0, 0])
            r[0] += e.time_range.elapsed_us() / 1e3
            r[1] += 1
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    row.update(device_busy_ms=busy if dev else None, cuda_events=len(dev),
               kernels_ms={k: v[0] for k, v in mine.items()},
               kernel_calls={k: v[1] for k, v in mine.items()},
               outside_kernels_ms=(busy - sum(v[0] for v in mine.values())
                                   if dev else None),
               stages=stages.stage_split(prof.events()))
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
    if spp > 1:
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


def turn(checkout: str, num: str, frames: int, profile: bool,
         image_path: str = "") -> dict:
    """One turn in a fresh process on `checkout` (a profiled one saves its
    frame's image to image_path)."""
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run(
        [sys.executable, "-c", TURN, num, str(frames),
         "1" if profile else "0", ",".join(KERNELS), image_path,
         os.path.abspath(__file__)],
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
    ap.add_argument("--configs", nargs="+", default=["5"],
                    help="config numbers, or capture")
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
        frames = max(args.frames // 4, 3) if num == "5" else args.frames
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
            print(f"config {num} {side}: outside the kernels by stage, ms "
                  f"(device events): " + ", ".join(
                      f"{k} {v['ms']:.3f} ({v['device_events']})"
                      for k, v in prof["stages"].items()), flush=True)
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
        result["configs"][num] = cell
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
