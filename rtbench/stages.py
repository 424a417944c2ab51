"""The device's idle time and launches of a profiled host window, put down
to the program's stages: the `trt.*` spans the program records inside its
`utils.profiling.recording` block (`trt.door.*`, `trt.raygen`, `trt.loop`,
`trt.segment.*`, `trt.finish`), on the device trace's clock.

Each idle interval of the window (`profile.Profile.gaps`) is cut at the
spans' edges; each piece goes to the innermost span covering it, or to
`OUTSIDE` (the harness, between calls). A device operation goes to the
innermost span at its runtime call. Per frame, these give the loop's idle
ms (pieces inside `trt.loop`), the front doors' (inside a `trt.door.*`
span but outside `trt.loop`) and the host reads a frame (the program's
`COUNTERS` over the window).

No metric reads these yet: the harness's host window would have to run
inside `recording` (PERF.md §7). Until then

    python3 -m rtbench.stages --workload <cell> --seed <n>

makes the cell's traced run (`run.run`, `--trace 1`) with `recording`
entered beside the host window's byte record, which opens and closes with
that window, and prints one JSON line: the run's metrics, the counters,
the three numbers, the idle and the device operations a frame by stage,
and each port kernel launched outside the stages `STAGES` gives it.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys

from rtbench import profile

PREFIX = "trt."
OUTSIDE = "outside"
LOOP = ("trt.loop", "trt.segment")
DOOR = ("trt.door.", "trt.raygen", "trt.finish")
# the stages that launch each of the program's kernels (the closest-hit
# kernels run both queries: the closest hit and the shadow any-hit)
QUERY = ("trt.segment.query", "trt.segment.shadow")
STAGES = {
    "visit_rank": ("trt.segment.ranks",),
    "loose_hit": QUERY, "tri_closest_hit": QUERY,
    "tri_closest_hit_stream": QUERY, "tri_closest_hit_stream_grouped": QUERY,
    "torus_closest_hit": QUERY, "torus_closest_hit_small": QUERY,
    "shade_hit": ("trt.segment.shade",), "quad_gather": ("trt.segment.shade",),
    "shade_finish": ("trt.segment.finish",),
    "span_gather": ("trt.segment.compact",),
    "raygen": ("trt.raygen",), "threefry_uniform": ("trt.raygen",),
    "frame_finish": ("trt.finish",),
}


def program_spans(prof) -> list:
    """The window's program spans, (start, end, name) in seconds."""
    return [(float(s), float(t), n) for n, s, t in
            zip(prof.host_names, prof.host_start, prof.host_end)
            if n.startswith(PREFIX)]


def innermost(spans: list, xs: list) -> list:
    """For each of the ascending points `xs`, the name of the innermost span
    covering it (the latest started of those open, of two started at once
    the shorter), None where none."""
    starts = sorted(range(len(spans)),
                    key=lambda i: (spans[i][0], -spans[i][1]))
    ends = sorted(range(len(spans)), key=lambda i: spans[i][1])
    opened, closed, out = [], set(), []
    a = b = 0
    for x in xs:
        while a < len(starts) and spans[starts[a]][0] <= x:
            opened.append(starts[a])
            a += 1
        while b < len(ends) and spans[ends[b]][1] < x:
            closed.add(ends[b])
            b += 1
        while opened and opened[-1] in closed:
            opened.pop()
        out.append(spans[opened[-1]][2] if opened else None)
    return out


def idle_by_stage(prof) -> dict:
    """{stage: idle seconds} of the window, {} where it holds no program
    span."""
    spans = program_spans(prof)
    if not spans:
        return {}
    edges = sorted({x for s, t, _ in spans for x in (s, t)})
    pieces = []
    for a, b in prof.gaps():
        cuts = [a, *edges[bisect.bisect_right(edges, a):
                          bisect.bisect_left(edges, b)], b]
        pieces.extend((u, v) for u, v in zip(cuts, cuts[1:]) if v > u)
    out: dict = {}
    names = innermost(spans, [0.5 * (u + v) for u, v in pieces])
    for (u, v), name in zip(pieces, names):
        key = name or OUTSIDE
        out[key] = out.get(key, 0.0) + (v - u)
    return out


def _idle_ms(prof, program: dict, prefixes: tuple):
    frames = program.get("frames")
    if prof is None or not frames:
        return None
    by = idle_by_stage(prof)
    if not by:
        return None
    return 1e3 * sum(v for k, v in by.items() if k.startswith(prefixes)) \
        / frames


def loop_idle_ms(prof, program: dict):
    """Device idle ms a frame while the host was inside `trt.loop`."""
    return _idle_ms(prof, program, LOOP)


def frontdoor_idle_ms(prof, program: dict):
    """Device idle ms a frame inside a `trt.door.*` span, outside
    `trt.loop`: set-up, raygen, F1, output allocation."""
    return _idle_ms(prof, program, DOOR)


def host_reads_per_frame(program: dict):
    """The program's host reads over its finished frames."""
    frames = program.get("frames")
    if not frames or "host_reads" not in program:
        return None
    return program["host_reads"] / frames


def device_ops_by_stage(events: list, prof) -> dict:
    """{stage: {device operation: count}} of the window's device events,
    each at the innermost program span around its runtime call (matched by
    correlation id), `OUTSIDE` where none. A program kernel is named by
    its base name; what PyTorch launched (`profile.is_library`) by the
    innermost ATen operation around the call, else its own name."""
    launched = {e["args"]["correlation"]: e["ts"] * 1e-6 for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    ops = sorted((launched[e["args"]["correlation"]],
                  profile.base_name(e["name"]) if e["cat"] == "kernel"
                  else e["name"].split(" (")[0],
                  profile.is_library(e["cat"], e["name"]))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in profile.DEVICE_CATS
                 and e.get("args", {}).get("correlation") in launched
                 and prof.t0 <= launched[e["args"]["correlation"]] <= prof.t1)
    at = [x for x, _, _ in ops]
    aten = [(float(s), float(t), n) for n, s, t in
            zip(prof.host_names, prof.host_start, prof.host_end)
            if n.startswith("aten::")]
    out: dict = {}
    for (_, op, library), stage, by in zip(
            ops, innermost(program_spans(prof), at), innermost(aten, at)):
        name = (by or op) if library else op
        row = out.setdefault(stage or OUTSIDE, {})
        row[name] = row.get(name, 0) + 1
    return out


def misplaced(by_stage: dict) -> dict:
    """{kernel: {stage: launches}} of the program's kernels launched outside
    the stages `STAGES` gives them."""
    out: dict = {}
    for stage, ops in by_stage.items():
        for op, count in ops.items():
            if op in STAGES and stage not in STAGES[op]:
                out.setdefault(op, {})[stage] = count
    return out


def stage_run(cell: str, seed: int, device="cuda",
              root: str | None = None) -> tuple:
    """The cell's traced run with the program's `recording` around its host
    window; returns (the stage line, the run's log)."""
    from rtbench import kernel_bytes, manifest, run
    from toroidal_ray_tracing_tpu_torch.utils.profiling import recording

    root = root or manifest.ROOT
    program: dict = {}
    real = kernel_bytes.record_calls

    @contextlib.contextmanager
    def host_window(out):
        with recording(program), real(out):
            yield out

    kernel_bytes.record_calls = host_window
    try:
        result, log = run.run(cell, seed, 0.0, 1, device=device, root=root)
    finally:
        kernel_bytes.record_calls = real
    with open(os.path.join(root, "out", cell, "trace_host.json")) as f:
        events = json.load(f)["traceEvents"]
    prof = profile.Profile(events)
    frames = program.get("frames") or 0
    by_ops = device_ops_by_stage(events, prof)
    per = (lambda v: v / frames) if frames else (lambda v: None)
    return {
        "workload": cell, "seed": seed, "correct": result["correct"],
        "device": result["device"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "program": program,
        "loop.idle_ms": loop_idle_ms(prof, program),
        "frontdoor.idle_ms": frontdoor_idle_ms(prof, program),
        "loop.host_reads_per_frame": host_reads_per_frame(program),
        "host_window_ms_per_frame": per(1e3 * prof.window_s),
        "idle_ms_per_frame": {k: per(1e3 * v) for k, v in sorted(
            idle_by_stage(prof).items())},
        "device_ops_per_frame": {s: {k: per(v) for k, v in sorted(
            ops.items())} for s, ops in sorted(by_ops.items())},
        "misplaced": misplaced(by_ops)}, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    line, log = stage_run(args.workload, args.seed)
    for text in log:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
