"""Frame timing and profiler traces (the port of the JAX package's
`utils/profiling.py`).

The reference's instrumentation is an ImGui FPS readout and a commented-out
per-power-state FPS logger (VKT/ray_tracing__before/main.cpp:287,88-110).
Here:

* `FrameTimer` — per-frame wall times and Mrays/s from the renderer's
  traceRayEXT-equivalent ray counts (the `io.Framerate` analog). On a CUDA
  device each `frame()` window ends in `torch.cuda.synchronize()`, so it
  times completed device work, not the enqueue.
* `trace_to(log_dir)` — `torch.profiler` over the enclosed block, CPU and
  (on a CUDA device) CUDA activities, written as a Chrome/Perfetto trace
  `trace.json` into `log_dir` (the NSight-capture analog).
* `record_segments(out)` — each segment the bounce loop traces in the
  enclosed block, as [lanes traced, live spans among them, its hit-kernel
  calls]: what live-ray compaction did (it reads the live mask, so it
  synchronizes once a segment; leave it out of timed runs), and a
  `HitCall` for each launch of K1, K2, K3, K5 or K6 its queries made;
  K2's on the card with the work its counters counted.
* `span(name)` — the program's stage spans (`trt.door.*`, `trt.raygen`,
  `trt.loop`, `trt.segment.*`, `trt.finish`), each a
  `torch.profiler.record_function` inside a `recording` block and a shared
  no-op outside one, so a profiler run inside `recording` shows them as
  user annotations on the device trace's clock.
* `COUNTERS` — frames F1 finished, the card path's device-to-host
  reads, and the bounce loop's segment plans built and segments run from
  one, always counted; `recording(out)` turns the spans on for its block
  and writes each counter's change over it into `out`.

The JAX module's `enable_compile_cache` (XLA's persistent compilation
cache) has no counterpart: nothing here compiles per shape, and the CUDA
kernels build once into `toroidal_ray_tracing_tpu_torch/build/`, keyed by a
hash of their sources and flags.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch

# Always counted, as `ops.kernel_common.LAUNCHES` is: "frames", the frames
# F1 finished (its last sample of each; the banded path and
# `render_sharded` run no F1 and count none); "host_reads", each
# device-to-host read the bounce loop makes (a segment's stop test, the
# ray total), counted at the read; "plan_builds", the segment plans built
# (`ops.segment_plan`); "plan_segments", the segments run from one (every
# kernel-backend loop's; the torch backend counts none).
COUNTERS = {"frames": 0, "host_reads": 0, "plan_builds": 0,
            "plan_segments": 0}

_recording = False
_OFF = contextlib.nullcontext()   # every span outside `recording`


class HitCall(NamedTuple):
    """One launch of a hit kernel (on CPU tensors: one call of its twin),
    with what sets the bytes its contract moves."""

    kernel: str       # the kernel's name on the device
    lanes: int        # rays in
    attrs: bool       # the attribute rows written
    tmax_out: bool    # the next kernel's tmax written
    occ_out: bool     # the occlusion byte written
    occ_or: bool      # ... read first and ORed into
    nodes: int        # tree nodes (K3: none)
    ranked: int       # boxes the visit rank orders: K1's clusters (1
    #                   without box test), K5/K6's superblocks, K2's chunks
    boxes: int        # K5/K6's cluster boxes, which a superblock's walk tests
    tori: int         # K2's padded torus rows, K3's tori
    box_tests: int | None = None   # K2's (ray, box) slab tests and (ray,
    quartics: int | None = None    # torus) quartics, as its counters count
    #                   them on the card; None where nothing was counted


# The hit-kernel calls of the open `record_segments` block's latest
# segment: the kernels' wrappers append a `HitCall` for each launch while
# it is a list; None outside such a block (and before its first segment).
HIT_CALLS = None
# The open block's counted calls: (call list, position, (2,) int64 counters)
_COUNTED = None


def record_call(call: HitCall, device=None):
    """Append `call` to the open block's latest segment (`HIT_CALLS`,
    which must be a list). Given a CUDA `device`, return a fresh (2,) int64
    counters tensor for the launch to add its work to, which the block
    reads at its exit into the call's `box_tests` and `quartics`; else
    None."""
    HIT_CALLS.append(call)
    if device is None or device.type != "cuda":
        return None
    work = torch.zeros((2,), dtype=torch.int64, device=device)
    _COUNTED.append((HIT_CALLS, len(HIT_CALLS) - 1, work))
    return work


def span(name: str):
    """A stage span named `name` around a `with` block: a
    `torch.profiler.record_function` inside `recording`, else one shared
    no-op (no record_function, clock read or allocation)."""
    if not _recording:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def recording(out: dict):
    """Turn the program's spans on inside the block (wrap a
    `torch.profiler.profile` run in it, or put it inside one, for them to
    land in its trace) and, on exit, write into `out` each counter's change
    over the block (`COUNTERS`). Blocks nest."""
    global _recording
    before = dict(COUNTERS)
    outer, _recording = _recording, True
    try:
        yield out
    finally:
        _recording = outer
        out.update({k: v - before[k] for k, v in COUNTERS.items()})


class FrameTimer:
    """Accumulates frame wall times and ray counts.

    >>> ft = FrameTimer()                 # device="cuda"
    >>> with ft.frame():
    ...     out = render(...)
    ...     ft.add_rays(out["rays_traced"])
    >>> ft.summary()
    """

    def __init__(self, device="cuda"):
        from toroidal_ray_tracing_tpu_torch.render.renderer import \
            check_device

        self.device = check_device(device)
        self.times: list = []
        self.rays: list = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - t0)

    def add_rays(self, n):
        self.rays.append(float(n))

    def summary(self, skip_first: bool = True) -> dict:
        """skip_first drops the warm-up frame (the kernels' build and the
        scene's first copy to the device)."""
        ts = self.times[1:] if skip_first and len(self.times) > 1 else self.times
        rs = self.rays[1:] if skip_first and len(self.rays) > 1 else self.rays
        if not ts:
            return {}
        total = sum(ts)
        out = {
            "frames": len(ts),
            "mean_ms": 1000.0 * total / len(ts),
            "fps": len(ts) / total,
        }
        if rs and total > 0:
            out["mrays_per_s"] = sum(rs) / total / 1e6
        return out


@contextlib.contextmanager
def trace_to(log_dir: str, device="cuda"):
    """Profile the enclosed block with torch.profiler and write
    `log_dir/trace.json`. Yields the profiler (for `key_averages()`)."""
    from toroidal_ray_tracing_tpu_torch.render.renderer import check_device

    device = check_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def record_segments(out: list):
    """Append [lanes traced, live spans among them, hit-kernel calls] to
    `out` for every segment `trace.wavefront.trace_rays` traces inside the
    block (a span is `COMPACT_SPAN` lanes; a partial last span counts).
    The calls are a list of `HitCall`, one a launch, from the segment's
    closest query on: every launch after a segment's entry is appended
    belongs to it (its any-hit query's too). A K2 launch on the card
    counts its work (`record_call`); at the block's exit one read, one
    sync, fills in every such call's counts."""
    global HIT_CALLS, _COUNTED
    from toroidal_ray_tracing_tpu_torch.trace import wavefront

    real = wavefront.closest_hit
    outer, outer_counted = HIT_CALLS, _COUNTED
    counted = _COUNTED = []

    def recorded(*a, **k):
        global HIT_CALLS
        live = wavefront.live_spans(k["tmax"] > 0)
        entry = [int(k["tmax"].shape[0]), int(live.sum()), []]
        out.append(entry)
        HIT_CALLS = entry[2]
        return real(*a, **k)

    wavefront.closest_hit = recorded
    try:
        yield out
    finally:
        wavefront.closest_hit = real
        HIT_CALLS, _COUNTED = outer, outer_counted
        if counted:
            work = torch.stack([w for _, _, w in counted]).tolist()
            for (calls, k, _), (box, prim) in zip(counted, work):
                calls[k] = calls[k]._replace(box_tests=box, quartics=prim)
