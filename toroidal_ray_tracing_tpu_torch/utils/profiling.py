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
  enclosed block, as [lanes traced, live spans among them]: what live-ray
  compaction did (it reads the live mask, so it synchronizes once a
  segment; leave it out of timed runs).

The JAX module's `enable_compile_cache` (XLA's persistent compilation
cache) has no counterpart: nothing here compiles per shape, and the CUDA
kernels build once into `toroidal_ray_tracing_tpu_torch/build/`, keyed by a
hash of their sources and flags.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from toroidal_ray_tracing_tpu_torch.render.renderer import check_device


class FrameTimer:
    """Accumulates frame wall times and ray counts.

    >>> ft = FrameTimer()                 # device="cuda"
    >>> with ft.frame():
    ...     out = render(...)
    ...     ft.add_rays(out["rays_traced"])
    >>> ft.summary()
    """

    def __init__(self, device="cuda"):
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
    """Append [lanes traced, live spans among them] to `out` for every
    segment `trace.wavefront.trace_rays` traces inside the block (a span
    is `COMPACT_SPAN` lanes; a partial last span counts)."""
    from toroidal_ray_tracing_tpu_torch.trace import wavefront

    real = wavefront.closest_hit

    def recorded(*a, **k):
        live = wavefront.live_spans(k["tmax"] > 0)
        out.append([int(k["tmax"].shape[0]), int(live.sum())])
        return real(*a, **k)

    wavefront.closest_hit = recorded
    try:
        yield out
    finally:
        wavefront.closest_hit = real
