"""The port's stage spans and counters (`utils.profiling`: `span`,
`COUNTERS`, `recording`) on the CPU, through the kernel backend's plain
twins and the torch backend at tiny sizes.

Off by default: outside `recording` no span enters
`torch.profiler.record_function`. Inside it, a CPU profiler's trace holds
the `trt.*` spans as user annotations, nested door -> loop -> segment ->
stage, and `COUNTERS` count each host read and each finished frame
exactly. Recording changes no output bit.
"""

import json

import pytest
import torch

from toroidal_ray_tracing_tpu_torch import (PinholeCamera, render,
                                            render_frames, render_sequence)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.utils import profiling

# 64 x 64 rays: enough for the kernel backend to compact (n / 2 >= 2048)
W = H = 64
CAMS = [PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        PinholeCamera(eye=(-8.0, 4.0, 6.0), center=(0.0, 0.5, 0.0))]
BACKENDS = ("kernel", "torch")

# (front door, its arguments, frames it finishes)
CALLS = {
    "render.spp1": ("render", dict(spp=1), 1),
    "render.spp2": ("render", dict(spp=2, seed=3), 1),
    "sequence.fpb1": ("render_sequence", dict(frames_per_batch=1), 2),
    "sequence.fpb2": ("render_sequence", dict(frames_per_batch=2), 2),
    "frames": ("render_frames", dict(), 2),
}
DOOR_STAGES = {"trt.door.setup", "trt.raygen", "trt.loop", "trt.finish"}
SEGMENT_STAGES = {
    "kernel": {"trt.segment.ranks", "trt.segment.query",
               "trt.segment.shade", "trt.segment.shadow",
               "trt.segment.finish", "trt.segment.read",
               "trt.segment.compact"},
    "torch": {"trt.segment.query", "trt.segment.finish",
              "trt.segment.read"},
}


@pytest.fixture(scope="module")
def scene():
    return build_scene(procedural.scene_multi_torus(analytic=True))


def settings():
    return RenderSettings.default(max_depth=3)


def call(scene, name, backend):
    door, kw, _ = CALLS[name]
    if door == "render":
        return render(scene, CAMS[0], W, H, settings(), backend=backend,
                      device="cpu", **kw)
    fn = render_sequence if door == "render_sequence" else render_frames
    return fn(scene, CAMS, W, H, settings(), backend=backend, device="cpu",
              **kw)


def traced_call(scene, name, backend, tmp_path):
    """The call under `recording` and a CPU profiler: (outputs, counter
    changes, the trace's trt.* spans as (start, end, name) by start)."""
    got = {}
    with profiling.recording(got), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call(scene, name, backend)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith("trt.")),
                   key=lambda s: (s[0], -s[1]))
    return out, got, spans


def parents(spans):
    """[(name, the innermost span enclosing it, or None)]."""
    out, stack = [], []
    for s, t, name in spans:
        while stack and not (stack[-1][0] <= s and t <= stack[-1][1]):
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, t, name))
    return out


def outputs(out):
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["render.spp2", "sequence.fpb2", "frames"])
def test_spans_are_off_outside_recording(scene, name, backend, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    out = call(scene, name, backend)
    assert out["rays_traced"] > 0
    assert profiling.span("trt.loop") is profiling.span("trt.segment")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_spans_nest_door_loop_segment_stage(scene, name, backend, tmp_path):
    door = "trt.door." + CALLS[name][0]
    _, _, spans = traced_call(scene, name, backend, tmp_path)
    tree = parents(spans)
    assert [n for n, p in tree if p is None] == [door]
    seen = set()
    for child, parent in tree:
        seen.add(child)
        if child in DOOR_STAGES:
            assert parent == door, (child, parent)
        elif child == "trt.segment" or child == "trt.loop.read":
            assert parent == "trt.loop", (child, parent)
        elif child.startswith("trt.segment."):
            assert parent == "trt.segment", (child, parent)
        else:
            assert child == door, child
    segment = {n for n in seen if n.startswith("trt.segment.")}
    assert segment == SEGMENT_STAGES[backend]
    assert DOOR_STAGES <= seen and "trt.loop.read" in seen


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_counters_count_each_read_and_frame(scene, name, backend, tmp_path):
    _, got, spans = traced_call(scene, name, backend, tmp_path)
    names = [n for _, _, n in spans]
    # a host read a segment (its stop test) and one a loop (the ray total)
    assert got["host_reads"] == names.count("trt.segment") + \
        names.count("trt.loop")
    assert names.count("trt.segment.read") == names.count("trt.segment")
    assert names.count("trt.loop.read") == names.count("trt.loop")
    assert got["frames"] == CALLS[name][2]
    # F1 runs once a sample of each frame
    assert names.count("trt.finish") == CALLS[name][2] * \
        CALLS[name][1].get("spp", 1)


def test_counters_count_outside_recording(scene):
    before = dict(profiling.COUNTERS)
    call(scene, "sequence.fpb1", "kernel")
    assert profiling.COUNTERS["frames"] - before["frames"] == 2
    assert profiling.COUNTERS["host_reads"] - before["host_reads"] >= 4


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["render.spp2", "sequence.fpb2", "frames"])
def test_recording_changes_no_output(scene, name, backend, tmp_path):
    off = call(scene, name, backend)
    on, _, _ = traced_call(scene, name, backend, tmp_path)
    assert off["rays_traced"] == on["rays_traced"]
    a, b = outputs(off), outputs(on)
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_recording_nests_and_reports_each_block(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", {"frames": 5, "host_reads": 7})
    outer, inner = {}, {}
    with profiling.recording(outer):
        profiling.COUNTERS["host_reads"] += 2
        with profiling.recording(inner):
            profiling.COUNTERS["frames"] += 1
            assert profiling.span("trt.loop") is not profiling._OFF
        assert profiling.span("trt.loop") is not profiling._OFF
    assert profiling.span("trt.loop") is profiling._OFF
    assert inner == {"frames": 1, "host_reads": 0}
    assert outer == {"frames": 1, "host_reads": 2}


def test_recording_ends_on_an_error():
    got = {}
    with pytest.raises(ValueError):
        with profiling.recording(got):
            raise ValueError("inside")
    assert profiling.span("trt.loop") is profiling._OFF
    assert got == {"frames": 0, "host_reads": 0, "plan_builds": 0,
                   "plan_segments": 0}
