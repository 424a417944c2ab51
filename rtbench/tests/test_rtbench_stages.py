"""The stage reduction (`rtbench.stages`) on hand-made traces: idle pieces
to the innermost program span, device operations to the span around their
launch, and no value where the window recorded nothing."""

import pytest

from rtbench import profile, stages


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


# one call 0-400 us: device busy 0-50, 150-200 and 350-400; the loop's
# segment 60-300 holds a query 60-120 and a read 200-300; set-up 0-40
TRACE = [ev("user_annotation", "rtbench.call.render", 0, 400),
         ev("user_annotation", "trt.door.render", 10, 380),
         ev("user_annotation", "trt.door.setup", 10, 30),
         ev("user_annotation", "trt.loop", 55, 300),
         ev("user_annotation", "trt.segment", 60, 240),
         ev("user_annotation", "trt.segment.query", 60, 60),
         ev("user_annotation", "trt.segment.read", 200, 100),
         ev("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=1),
         ev("cuda_runtime", "cudaLaunchKernel", 100, 2, correlation=2),
         ev("cpu_op", "aten::zero_", 245, 10),
         ev("cuda_runtime", "cudaMemsetAsync", 250, 2, correlation=3),
         ev("cuda_runtime", "cudaLaunchKernel", 380, 2, correlation=4),
         ev("kernel", "raygen", 0, 50, correlation=1),
         ev("kernel", "(anonymous namespace)::tri_closest_hit(float*)",
            150, 50, correlation=2),
         ev("gpu_memset", "Memset (Device)", 350, 10, correlation=3),
         ev("kernel", "frame_finish", 360, 40, correlation=4)]


def test_an_idle_interval_is_cut_at_each_span_it_crosses():
    prof = profile.Profile(TRACE)
    got = stages.idle_by_stage(prof)
    # the gap 50-150 (after the set-up's end at 40) crosses the door
    # (50-55), the loop (55-60), the query (60-120) and the segment
    # (120-150); the gap 200-350 crosses the read (200-300) and the loop
    # (300-350)
    assert got == pytest.approx({
        "trt.door.render": 5e-6, "trt.loop": 5e-6 + 50e-6,
        "trt.segment.query": 60e-6, "trt.segment": 30e-6,
        "trt.segment.read": 100e-6})
    program = {"frames": 2, "host_reads": 3}
    assert stages.loop_idle_ms(prof, program) == pytest.approx(
        (5 + 50 + 60 + 30 + 100) * 1e-3 / 2)
    assert stages.frontdoor_idle_ms(prof, program) == pytest.approx(
        5e-3 / 2)


def test_idle_outside_every_span_is_the_harness():
    prof = profile.Profile(
        [ev("user_annotation", "rtbench.call.render", 0, 100),
         ev("user_annotation", "trt.door.render", 20, 60),
         ev("cuda_runtime", "cudaLaunchKernel", 30, 2),
         ev("kernel", "raygen", 40, 20)])
    got = stages.idle_by_stage(prof)
    assert got == pytest.approx({stages.OUTSIDE: 40e-6,
                                 "trt.door.render": 40e-6})
    assert stages.loop_idle_ms(prof, {"frames": 1}) == 0.0


def test_a_window_without_program_spans_gives_no_value():
    prof = profile.Profile(
        [ev("user_annotation", "rtbench.call.render", 0, 100),
         ev("cpu_op", "aten::empty", 10, 5),
         ev("kernel", "raygen", 40, 20)])
    assert stages.idle_by_stage(prof) == {}
    assert stages.loop_idle_ms(prof, {"frames": 4}) is None
    assert stages.frontdoor_idle_ms(prof, {"frames": 4}) is None


@pytest.mark.parametrize("program", [{}, {"frames": 0, "host_reads": 5},
                                     {"frames": 3}])
def test_no_host_reads_a_frame_without_frames_and_reads(program):
    assert stages.host_reads_per_frame(program) is None


@pytest.mark.parametrize("program", [{}, {"frames": 0, "host_reads": 5}])
def test_no_idle_a_frame_without_frames(program):
    prof = profile.Profile(TRACE)
    assert stages.loop_idle_ms(prof, program) is None
    assert stages.frontdoor_idle_ms(prof, program) is None


def test_host_reads_a_frame():
    assert stages.host_reads_per_frame({"frames": 4, "host_reads": 10}) \
        == 2.5


def test_device_operations_go_to_the_span_around_their_launch():
    # (the memset is PyTorch's: it takes the name of the ATen operation
    # around its launch)
    prof = profile.Profile(TRACE)
    got = stages.device_ops_by_stage(TRACE, prof)
    assert got == {"trt.door.setup": {"raygen": 1},
                   "trt.segment.query": {"tri_closest_hit": 1},
                   "trt.segment.read": {"aten::zero_": 1},
                   "trt.door.render": {"frame_finish": 1}}
    # raygen belongs in trt.raygen, F1 in trt.finish; K1 is in its stage
    assert stages.misplaced(got) == {
        "raygen": {"trt.door.setup": 1},
        "frame_finish": {"trt.door.render": 1}}


def test_a_stage_run_records_spans_in_the_host_window_alone(tiny_root):
    import json
    import os

    from rtbench import kernel_bytes

    cell = "flythrough4k.orbit8"
    real = kernel_bytes.record_calls
    line, _ = stages.stage_run(cell, 2**31 + 7, device="cpu", root=tiny_root)
    assert kernel_bytes.record_calls is real
    assert line["correct"]
    # one call of one frame, 2 samples of 3 segments and a total read each
    assert line["program"] == {"frames": 1, "host_reads": 8}
    assert line["loop.host_reads_per_frame"] == 8
    assert line["loop.idle_ms"] > 0 and line["frontdoor.idle_ms"] > 0
    out = os.path.join(tiny_root, "out", cell)
    for name, spans in (("trace.json", False), ("trace_host.json", True)):
        with open(os.path.join(out, name)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert ("trt.loop" in names) is spans, name
