"""The harness finds every configuration, workload, traffic mix and metric
by name; BENCHMARK.json agrees with the files; names and units keep to the
allowed characters."""

import itertools
import json
import os
import re
import shutil

import pytest

from rtbench import manifest
from rtbench.traffic import generator

REPO = os.path.dirname(manifest.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_file_loads_by_name():
    for name in manifest.names("configs", ".json"):
        cfg = manifest.config(name)
        assert cfg["name"] == name
    for name in manifest.names("traffic", ".json"):
        tr = manifest.traffic(name)
        assert generator.warmup(tr, 1)
    for name in manifest.names("workloads", ".json"):
        wl = manifest.workload(name)
        manifest.config(wl["config"])
        manifest.traffic(wl["traffic"])
    for name in manifest.names("metrics", ".py"):
        mod = manifest.metric(name)
        assert mod.NAME == name


def test_benchmark_json_matches_the_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["rtbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        cfg = manifest.config(c["name"])
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    assert sorted(w["name"] for w in b["workloads"]) == \
        manifest.names("workloads", ".json")
    for w in b["workloads"]:
        wl = manifest.workload(w["name"])
        assert (w["config"], w["traffic"], w["chips"]) == \
            (wl["config"], wl["traffic"], wl["chips"])
        assert w["config"] in configs
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"frames_per_s", "latency_ms_p95", "setup_s"}
    assert sorted(m["name"] for m in b["per_layer"]) == \
        manifest.names("metrics", ".py")
    for m in b["per_layer"]:
        mod = manifest.metric(m["name"])
        assert (m["layer"], m["unit"], m["better"], m["source"],
                m["moves"]) == (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE,
                                mod.MOVES)
        assert m["moves"] in e2e


def test_names_and_units_use_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(b["configs"]) + len(b["workloads"])])) == \
        len(b["configs"]) + len(b["workloads"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in b["workloads"]] + \
            [m["layer"] for m in b["per_layer"]] + \
            [c["source"] for c in b["configs"]] + b["command"]:
        assert LINE.match(text), text
    for rel, _, files in os.walk(manifest.ROOT):
        for f in files:
            path = os.path.relpath(os.path.join(rel, f), REPO)
            assert re.match(r"^[A-Za-z0-9_./-]+$", path), path


@pytest.mark.parametrize("kind", ["workload", "metric"])
def test_a_new_file_is_picked_up_without_a_code_edit(tmp_path, kind):
    root = str(tmp_path / "rtbench")
    shutil.copytree(manifest.ROOT, root, ignore=shutil.ignore_patterns(
        "out", "__pycache__", "tests"))
    if kind == "workload":
        wl = manifest.workload("flythrough4k.orbit8")
        with open(os.path.join(root, "workloads",
                               "flythrough4k.other.json"), "w") as f:
            json.dump(dict(wl, traffic="orbit8"), f)
        assert "flythrough4k.other" in manifest.names("workloads", ".json",
                                                      root)
        assert manifest.workload("flythrough4k.other", root)["traffic"] == \
            "orbit8"
        tr = manifest.traffic(manifest.workload("flythrough4k.other",
                                                root)["traffic"], root)
        assert generator.warmup(tr, 5, spp=2)
    else:
        with open(os.path.join(root, "metrics", "extra.count.py"), "w") as f:
            f.write('NAME = "extra.count"\nLAYER = "device"\nUNIT = "ops"\n'
                    'BETTER = "lower"\nSOURCE = "device_trace"\n'
                    'MOVES = "frames_per_s"\n\n\n'
                    'def read(ctx):\n    return 1.0\n')
        got = [m.NAME for m in manifest.readers(root)]
        assert "extra.count" in got


def test_cells_read_the_metrics_they_list():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m.get("workloads") or cells) <= cells
    for cell in cells:
        # every cell reports a per-layer metric
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


def test_jitter_keys_are_drawn_only_for_jittered_samples():
    tr = manifest.traffic("orbit8")
    one = [c.seed for c in itertools.islice(generator.calls(tr, 9), 20)]
    two = [c.seed for c in itertools.islice(generator.calls(tr, 9, 2), 20)]
    assert set(one) == {0} and len(set(two)) == 20
