"""The result line's keys, the per-layer metrics of a traced run, the
check lines, a limit whose number is missing failing the run, the sample
of every front door, and no result without a card."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from rtbench import check, manifest, run

CELL = "flythrough4k.orbit8"


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_holds_exactly_its_keys(tiny_root, trace):
    res, log = run.run(CELL, 2**31 + 3, 0.01, trace, device="cpu",
                       root=tiny_root, t_start=time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    if trace:
        allowed = {m.NAME for m in manifest.readers(tiny_root)}
        assert set(res["metrics"]) <= allowed
        assert {"host_scene.build_s", "loop.rays_per_frame",
                "loop.live_lane_pct"} <= set(res["metrics"])
        assert {"busy_s", "window_s"} <= set(res["device"])
        for part in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][part]) <= 10
    else:
        assert set(res["metrics"]) == {"frames_per_s", "latency_ms_p95",
                                       "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    tail = log[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"
    json.dumps(res)


@pytest.mark.parametrize("cell,door,keys", [
    ("capture.gtruth_batch4", "render_frames",
     ("hit_positions", "ray_origins", "ray_dirs")),
    ("capture.step60", "render", ("hit_position", "ray_origin", "ray_dir")),
    ("flythrough4k.orbit8", "render_sequence", ("images",))])
def test_answers_a_door_stops_returning_fail_the_run(tiny_root, monkeypatch,
                                                     cell, door, keys):
    from toroidal_ray_tracing_tpu_torch.render import renderer

    real = getattr(renderer, door)

    def without(*a, **k):
        out = real(*a, **k)
        for key in keys:
            out.pop(key, None)
        return out

    monkeypatch.setattr(renderer, door, without)
    res, log = run.run(cell, 2**31 + 5, 0.01, 0, device="cpu",
                       root=tiny_root, t_start=time.perf_counter())
    assert not res["correct"]
    limits = manifest.workload(cell, tiny_root)["limits"]
    assert set(res["checks"]) == set(limits)
    missing = [k for k, c in res["checks"].items() if c["value"] is None]
    assert missing, res["checks"]
    assert f"check {missing[0]} None limit {limits[missing[0]]!r}" in log


def test_a_missing_number_fails_its_limit():
    ok, checks = check.verdict({"a": 0.1}, {"a": 1.0, "b": 1.0})
    assert not ok and checks["b"] == {"value": None, "limit": 1.0}
    assert check.verdict({"a": 0.1, "b": 0.2}, {"a": 1.0, "b": 1.0})[0]
    assert not check.verdict({"a": 0.1, "c": 0.0}, {"a": 1.0})[0]


def test_every_front_door_is_sampled():
    # a door of one call in 60 is sampled as fully as the other
    sample = check.Sample(3, np.random.default_rng(1))
    for i in range(6000):
        door = "render" if i % 60 == 59 else "render_sequence"
        sample.offer(door, lambda i=i, door=door: (door, i))
    kept = sample.items
    assert sample.seen == 6000 and len(kept) == 6
    assert sorted(d for d, _ in kept).count("render") == 3
    assert len({i for _, i in kept}) == 6


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(run, "run", lambda *a, **k: called.append(a))
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and not called
    assert capsys.readouterr().out == ""


def test_too_few_cards_exit_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_jax_loaded_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", lambda *a, **k: ({"correct": True},
                                                     []))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "toroidal_ray_tracing_tpu_torch.x",
                        types.ModuleType("x"))
    assert not any(m.split(".")[0] == "toroidal_ray_tracing_tpu_torch"
                   for m in run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "toroidal_ray_tracing_tpu.render",
                        types.ModuleType("render"))
    assert "toroidal_ray_tracing_tpu.render" in run.forbidden_modules()


def test_the_result_is_the_last_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    canned = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {"a": {"value": 1, "limit": 2}}}
    monkeypatch.setattr(run, "run", lambda *a, **k: (
        canned, ["window", "check a 1 limit 2"]))
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == canned
    assert out.err.strip().splitlines()[-1] == "check a 1 limit 2"
