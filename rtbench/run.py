"""Run one cell of the benchmark once and print its result line.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed from the process's start as `setup_s`): imports, the card,
the configuration's scene built and copied there, the kernel library
loaded (built by nvcc on the first run in a checkout), and each front door
of the traffic warmed up. Then:

* `--trace 0`: the measured window. One closed-loop client issues the
  traffic's calls, each timed on the host clock from issue to a
  synchronize after it, until `--seconds` have passed; the window ends
  when the last call started inside it completes. Prints the cell's
  end-to-end metrics: frames_per_s (frames completed over the window),
  latency_ms_p95 (over every call) and setup_s.
* `--trace 1`: three sub-windows of `trace_calls` calls each. The
  device's: under torch.profiler recording CUDA activity alone, after one
  call under the profiler that the trace leaves out (the profiler's own
  start); it gives the device's busy time, idle share and operations. The
  host's: profiled with the host's operations too, for what the host did
  in each idle gap (recording them slows the host 10-17%), and with each
  hit-kernel call's bytes recorded, paired with this window's launches.
  The counted one: the bounce loop's segments recorded. Prints the
  per-layer metrics (`metrics/`), the device's busy time and the
  breakdown. The full traces are written to `rtbench/out/<cell>/
  trace.json` and `trace_host.json`. Only the counted calls offer their
  answers to the check.

Either way a seeded sample of the answers of the window's calls is then
compared with the plain reference (`check`), after the peak memory is
read and the program's state freed; `correct` says whether each compared
number is within its limit (the cell's workload file), and each is printed
beside its limit as the last lines on standard error and under `checks`,
the result's last key. The run fails (exit code not 0, no result line)
without a CUDA card, with fewer cards than the cell asks for, or when JAX
or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "out", "cache")
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")

import torch  # noqa: E402

from rtbench import (check, frontdoor, kernel_bytes, manifest,  # noqa: E402
                     profile, scenedata)
from rtbench.traffic import generator  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "toroidal_ray_tracing_tpu")


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader (`metrics/<name>.py`) reads."""

    build_s: float
    frames: int = 0                 # frames of the traced run's calls
    rays: int = 0                   # their rays_traced
    segments: list = dataclasses.field(default_factory=list)
    profile: object = None          # profile.Profile of the device's window
    profile_frames: int = 0
    host_profile: object = None     # the same of the host's window
    kernel_calls: dict = dataclasses.field(default_factory=dict)  # host's
    peak_bytes_per_s: float | None = None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit_w(device):
    """The card's power limit (nvidia-smi), None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


class Client:
    """The closed-loop client: issues the schedule's calls one at a time,
    each timed from issue to the synchronize after it, and offers every
    call's answers to the check's reservoir."""

    def __init__(self, port, stream, reservoir, take=None):
        self.port, self.stream, self.reservoir = port, stream, reservoir
        self.take = take
        self.offering = True     # off: no answers taken (profiled calls)
        self.latencies, self.frames, self.rays = [], 0, 0
        self.attempted = self.failed = 0
        self.errors = []

    def one(self, span: bool = False):
        c = next(self.stream)
        self.attempted += 1
        spanned = (torch.profiler.record_function(
            f"{profile.CALL_SPAN}.{c.door}") if span
            else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with spanned:
                out, rays = self.port.call(c)
                self.port.sync()
        except RuntimeError as e:
            self.failed += 1
            self.errors.append(f"call {c.index} ({c.door}): {e}")
            return time.perf_counter()
        done = time.perf_counter()
        self.latencies.append(done - t0)
        self.frames += c.frames
        self.rays += rays
        answers = frontdoor.frame_outputs(c, out) if self.offering \
            else None
        if answers:
            self.reservoir.offer(c.door, lambda: self.take(c, answers))
        return done


def _p95(values: list) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run(cell: str, seed: int, seconds: float, trace: int, device="cuda",
        root: str = manifest.ROOT, t_start: float | None = None):
    """One run of `cell`; returns (result dict, [stderr lines])."""
    t_start = T0 if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    wl = manifest.workload(cell, root)
    cfg = manifest.config(wl["config"], root)
    tr = manifest.traffic(wl["traffic"], root)
    log = []

    # set-up: the scene, the kernel library and each door's first calls
    port = frontdoor.Port(cfg, device)
    calls = generator.warmup(tr, seed, port.spp)
    warm = Client(port, iter(calls), check.Sample(0, None))
    for _ in calls:
        warm.one()
    if warm.failed:
        raise RuntimeError("warm-up failed: " + "; ".join(warm.errors))
    setup_s = time.perf_counter() - t_start

    sample = tr["sample"]
    reservoir = check.Sample(int(sample["calls"]),
                             generator.rng(seed, generator.RESERVOIR))
    pixels = generator.rng(seed, generator.PIXELS)
    client = Client(port, generator.calls(tr, seed, port.spp), reservoir,
                    lambda c, answers: check.take(
                        c, answers, pixels, cfg["width"], cfg["height"],
                        int(sample["pixels"])))
    ctx = Context(build_s=port.build_s)
    metrics = {}
    if trace:
        out_dir = os.path.join(root, "out", cell)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        host_path = os.path.join(out_dir, "trace_host.json")
        act = torch.profiler.ProfilerActivity
        gpu = device.type == "cuda"
        n = int(tr["trace_calls"])
        # the profiled calls take no answers (the check's gathers would
        # be device work in the trace); the counted ones do
        client.offering = False
        with torch.profiler.profile(
                activities=[act.CUDA] if gpu else [act.CPU],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            client.one(span=not gpu)
            prof.step()
            frames0 = client.frames
            for _ in range(n):
                client.one(span=not gpu)
            prof.step()
        ctx.profile_frames = client.frames - frames0
        with torch.profiler.profile(
                activities=[act.CPU] + ([act.CUDA] if gpu else [])) as prof, \
                kernel_bytes.record_calls(ctx.kernel_calls):
            for _ in range(n):
                client.one(span=True)
        prof.export_chrome_trace(host_path)
        client.offering = True
        from toroidal_ray_tracing_tpu_torch.utils.profiling import (
            record_segments)
        with record_segments(ctx.segments):
            for _ in range(n):
                client.one()
        ctx.frames, ctx.rays = client.frames, client.rays
    else:
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            t_end = client.one()
        window = t_end - t0
        metrics = {
            "frames_per_s": {"value": client.frames / window,
                             "unit": "frames/s"},
            "latency_ms_p95": {"value": 1e3 * _p95(client.latencies),
                               "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        lat = sorted(client.latencies)
        log.append(f"window {window:.3f} s: {client.attempted} calls, "
                   f"{client.frames} frames, {client.failed} failed; "
                   f"latency p50 {1e3 * statistics.median(lat):.3f} ms, "
                   f"p95 {metrics['latency_ms_p95']['value']:.3f} ms over "
                   f"{len(lat)} samples ({len(lat) // 20} beyond it)")
    log.append(f"setup {setup_s:.3f} s (scene {port.build_s:.3f} s)")
    dev = device_info(device)

    if trace:
        ctx.profile = profile.Profile.load(path)
        ctx.host_profile = profile.Profile.load(host_path)
        kind = dev["kind"]
        peak = manifest.peaks(root).get(kind)
        ctx.peak_bytes_per_s = peak["hbm_bytes_per_s"] if peak else None
        for mod in manifest.readers(root):
            value = mod.read(ctx)
            if value is not None:
                metrics[mod.NAME] = {"value": value, "unit": mod.UNIT}
        dev["busy_s"] = ctx.profile.busy_s
        dev["window_s"] = ctx.profile.window_s
        if device.type == "cuda":
            dev["power_limit_w"] = power_limit_w(device)
        log.append(f"profiled {tr['trace_calls']} calls, "
                   f"{ctx.profile_frames} frames: busy "
                   f"{ctx.profile.busy_s:.4f} s of {ctx.profile.window_s:.4f}"
                   f" s, {len(ctx.profile.device)} device operations; "
                   f"traces {path}, {host_path}")

    # the check: the program's state freed, then the reference on the
    # sample's pixels
    items = [it for kept in reservoir.items for it in kept]
    answered = reservoir.seen
    attempted, failed, errors = client.attempted, client.failed, client.errors
    del reservoir, client, port, warm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from rtbench.reference import scene as ref_scene

    t0 = time.perf_counter()
    tables = ref_scene.tables(scenedata.models(cfg["scene"]), device)
    refs = check.reference_answers(items, cfg, tables)
    nums = check.numbers(items, refs)
    correct, checks = check.verdict(nums, wl["limits"])
    log.append(f"check: {len(items)} frames of {answered} answering calls, "
               f"{sum(len(it[2]) for it in items)} pixels, reference "
               f"{time.perf_counter() - t0:.2f} s")
    result = {"correct": bool(correct and answered and not failed),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": ctx.profile.device_ops(),
                               "idle_gaps": ctx.host_profile.idle_gaps()}
    log.extend(errors)
    log.extend(f"check {k} {v['value']!r} limit {v['limit']!r}"
               for k, v in checks.items())
    result["checks"] = checks
    return result, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = int(manifest.workload(args.workload).get("chips", 1))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"rtbench: needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result, log = run(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
