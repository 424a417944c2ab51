"""Where a compacted frame's time goes on the host: one frame rendered on
the card with live-ray compaction (`trace.wavefront.COMPACT_FACTORS` at
its default) and without it (`()`), in turns, then one frame each way
under torch.profiler:

    python -m toroidal_ray_tracing_tpu_torch.experiments.compaction_host
        [--cell 7] [--res 1920x1080] [--pairs 10] [--top 20]

`--cell` is a ladder config number (its scene, camera and settings) or
`capture` (the capture cell of chip_smoke: cornellish, toroidal eye
(0, 1, 0) -> (8, 0, 0), rho 4, depth 10). The scene is built and moved to
the card once; each frame is `render(..., backend="kernel",
device="cuda")` timed on the host clock to a `torch.cuda.synchronize()`,
after a warm-up each way. Prints the card's name and power limit, each
way's ms/frame (median and quartiles over the pairs), each way's
profiled frame (host ms in the profiler, CUDA events, device busy), the
same turns again after the profiler has run in the process (chip_smoke
times its later phases after profiling), the `--top` ops whose self CPU
time differs most between the ways (ms and calls each way), then one
JSON line. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.trace import wavefront


def _cell(name: str):
    """(scene on the card, camera, settings) of a ladder config or the
    capture cell."""
    if name == "capture":
        from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
        from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                          build_scene,
                                                          procedural)

        return (build_scene(procedural.scene_cornellish()).to("cuda"),
                ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
                RenderSettings.default(rho=4.0))
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS

    sc = SCENARIOS[int(name)]
    return sc.build().to("cuda"), sc.camera, sc.settings()


def _profiled(frame):
    """One frame under torch.profiler: (host ms the profiler saw, CUDA
    events, device busy ms, {op: [self CPU ms, calls]})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        host = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = {a.key: [a.self_cpu_time_total / 1e3, a.count]
           for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CPU}
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return host, len(dev), busy, ops


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="7")
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compaction_host: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    w, h = (int(x) for x in args.res.split("x"))
    scene, cam, st = _cell(args.cell)
    ways = {"compacted": wavefront.COMPACT_FACTORS, "uncompacted": ()}

    def frame():
        render(scene, cam, w, h, st, backend="kernel", device="cuda")
        torch.cuda.synchronize()

    def turns():
        times = {way: [] for way in ways}
        for i in range(args.pairs):
            for way in (ways if i % 2 == 0 else reversed(list(ways))):
                wavefront.COMPACT_FACTORS = ways[way]
                t0 = time.perf_counter()
                frame()
                times[way].append((time.perf_counter() - t0) * 1e3)
        return times

    try:
        for f in ways.values():
            wavefront.COMPACT_FACTORS = f
            frame()
        times = turns()
        prof = {}
        for way, f in ways.items():
            wavefront.COMPACT_FACTORS = f
            prof[way] = _profiled(frame)
        after = turns()
    finally:
        wavefront.COMPACT_FACTORS = ways["compacted"]
    out = dict(card=card, cell=args.cell, width=w, height=h, ways={})

    def quartiles(ms):
        q1, _, q3 = statistics.quantiles(ms, n=4)
        return statistics.median(ms), q1, q3

    for way in ways:
        med, q1, q3 = quartiles(times[way])
        amed, aq1, aq3 = quartiles(after[way])
        host, events, busy, _ = prof[way]
        out["ways"][way] = dict(ms=times[way], ms_median=med, ms_q1=q1,
                                ms_q3=q3, profiled_host_ms=host,
                                cuda_events=events, device_busy_ms=busy,
                                after_profiler_ms=after[way],
                                after_profiler_median=amed)
        print(f"{way}: {med:.2f} ms/frame (quartiles {q1:.2f}-{q3:.2f}, "
              f"{args.pairs} frames); profiled frame {host:.2f} ms on the "
              f"host, {events} CUDA events, device busy {busy:.2f} ms; "
              f"after the profiler {amed:.2f} ms/frame (quartiles "
              f"{aq1:.2f}-{aq3:.2f})", flush=True)
    a, b = prof["compacted"][3], prof["uncompacted"][3]
    keys = sorted(set(a) | set(b), key=lambda k: -abs(
        a.get(k, [0.0, 0])[0] - b.get(k, [0.0, 0])[0]))[:args.top]
    print("op: self CPU ms (calls), compacted / uncompacted", flush=True)
    diff = []
    for k in keys:
        ca, cb = a.get(k, [0.0, 0]), b.get(k, [0.0, 0])
        diff.append(dict(op=k, compacted=ca, uncompacted=cb))
        print(f"  {k}: {ca[0]:.3f} ({ca[1]}) / {cb[0]:.3f} ({cb[1]})",
              flush=True)
    out["ops"] = diff
    out["self_cpu_ms_total"] = {way: sum(v[0] for v in prof[way][3].values())
                                for way in ways}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
