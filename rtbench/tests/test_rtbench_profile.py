"""The trace reduction on a hand-made trace: window, busy union, gaps,
their host labels, kernel names and what PyTorch launched."""

import pytest

from rtbench import profile


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


DEVICE = [ev("kernel", "(anonymous namespace)::tri_closest_hit(float const*)",
             110, 40),
          ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(x)",
             140, 20),
          ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 200, 50),
          ev("kernel", "(anonymous namespace)::frame_finish", 300, 10)]


def test_a_cuda_trace_runs_from_its_first_runtime_call_to_its_last_sync():
    p = profile.Profile(DEVICE + [
        ev("cuda_runtime", "cudaLaunchKernel", 100, 5),
        ev("cuda_runtime", "cudaMemcpyAsync", 180, 80),
        ev("cuda_runtime", "cudaDeviceSynchronize", 305, 15)])
    assert (p.t0, p.t1) == pytest.approx((100e-6, 320e-6))
    assert p.busy_s == pytest.approx((50 + 50 + 10) * 1e-6)
    assert [(round(s * 1e6), round(t * 1e6)) for s, t in p.gaps()] == \
        [(100, 110), (160, 200), (250, 300), (310, 320)]
    assert p.kernel_seconds("tri_closest_hit") == (1, pytest.approx(40e-6))
    assert p.library_seconds() == pytest.approx(70e-6)
    assert [n for n, _ in p.device_ops()] == [
        "Memcpy DtoH", "tri_closest_hit",
        "at::native::vectorized_elementwise_kernel", "frame_finish"]


def test_call_spans_set_the_window_and_gaps_get_host_labels():
    p = profile.Profile(DEVICE + [
        ev("user_annotation", "rtbench.call.render", 90, 240),
        ev("cpu_op", "aten::empty", 255, 40),
        ev("cpu_op", "aten::where", 140, 18)])
    assert (p.t0, p.t1) == pytest.approx((90e-6, 330e-6))
    got = p.idle_gaps()
    assert [n for n, _ in got] == [
        "aten::empty", "after aten::where",
        "host (before the first operation)", "after aten::empty"]
    assert [s for _, s in got] == pytest.approx([50e-6, 40e-6, 20e-6, 20e-6])


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        profile.Profile(DEVICE)
