"""The port's measurement front doors: `experiments.configs.run_scenario`
and its CLI in all three modes (small `dataclasses.replace`d scenarios, as
tests/test_io_experiments.py runs the JAX ones), its ray counts against
the JAX `run_scenario`, the microbench, `utils.profiling`, the bench's
headline and ladder file, and their default CUDA device."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.experiments import configs as jax_configs
from toroidal_ray_tracing_tpu.scene.build import (
    build_texture_atlas as jax_atlas)
from toroidal_ray_tracing_tpu_torch import bench, render
from toroidal_ray_tracing_tpu_torch.experiments import configs, microbench
from toroidal_ray_tracing_tpu_torch.scene import procedural
from toroidal_ray_tracing_tpu_torch.utils.profiling import FrameTimer, trace_to

torch.set_num_threads(2)


def _small(module, monkeypatch, num, **changes):
    """Replace ladder config `num` of a configs module with a small copy
    for the test's duration."""
    sc = dataclasses.replace(module.SCENARIOS[num], **changes)
    monkeypatch.setitem(module.SCENARIOS, num, sc)
    return sc


def test_front_door_mode(monkeypatch, tmp_path):
    sc = _small(configs, monkeypatch, 3, width=32, height=24)
    out, stats = configs.run_scenario(3, out_dir=str(tmp_path), frames=2,
                                      device="cpu")
    assert stats["scenario"] == sc.name and stats["frames"] == 2
    assert stats["protocol"] == "front_door"
    assert tuple(out["images"].shape) == (2, 3, 24, 32)
    assert "hit_positions" in out                        # dumps on
    one = render(sc.build(), sc.camera, 32, 24, sc.settings(), device="cpu")
    assert stats["rays_per_frame"] == one["rays_traced"]
    assert torch.equal(out["images"][-1], one["image"].permute(2, 0, 1))
    lo, med, hi = stats["window_ms"]
    assert 0 < lo <= med <= hi
    assert stats["mrays_per_s"] == pytest.approx(
        2 * one["rays_traced"] / med / 1e3)
    assert (tmp_path / f"{sc.name}.png").exists()


def test_front_door_skips_dumps_past_the_pixel_cap(monkeypatch):
    _small(configs, monkeypatch, 1, width=16, height=16)
    monkeypatch.setattr(configs, "DUMPS_MAX_PIXELS", 16 * 16 * 2 - 1)
    out, _ = configs.run_scenario(1, frames=2, device="cpu")
    assert set(out) == {"images", "rays_traced"}


def test_sequence_mode(monkeypatch):
    sc = _small(configs, monkeypatch, 2, width=24, height=24)
    out, stats = configs.run_scenario(2, frames=1, sequence=True,
                                      device="cpu")
    assert out is None
    assert stats["protocol"] == "sequence" and stats["frames"] == 2
    cams = sc.cameras_seq(2)
    total = sum(render(sc.build(), c, 24, 24, sc.settings(),
                       device="cpu")["rays_traced"] for c in cams)
    assert stats["rays_per_frame"] == total / 2
    lo, med, hi = stats["window_ms"]
    assert 0 < lo <= med <= hi and stats["mrays_per_s"] > 0


def test_raster_mode(monkeypatch, tmp_path):
    _small(configs, monkeypatch, 7, width=64, height=36)
    out, stats = configs.run_scenario(7, out_dir=str(tmp_path), raster=True,
                                      device="cpu")
    assert stats["protocol"] == "raster"
    img = out["image"]
    assert tuple(img.shape) == (36, 64, 3) and float(img.std()) > 0.01
    assert (tmp_path / "config7_textured_raster.png").exists()


@pytest.mark.parametrize("num,sequence", [(1, False), (2, True)])
def test_rays_per_frame_equal_jax(monkeypatch, num, sequence):
    """The same small scenario through both packages' run_scenario: the
    same traceRayEXT-equivalent count per frame."""
    changes = dict(width=24, height=24)
    _small(configs, monkeypatch, num, **changes)
    _small(jax_configs, monkeypatch, num, **changes)
    _, got = configs.run_scenario(num, frames=2, sequence=sequence,
                                  device="cpu")
    _, want = jax_configs.run_scenario(num, frames=2, sequence=sequence)
    assert got["rays_per_frame"] == pytest.approx(want["rays_per_frame"],
                                                  rel=1e-3)


def test_cli(monkeypatch, tmp_path, capsys):
    sc = _small(configs, monkeypatch, 1, width=16, height=16)
    stats = configs.main(["--run", "1", "--frames", "2", "--device", "cpu",
                          "--backend", "kernel", "--out", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == stats and printed["scenario"] == sc.name
    assert (tmp_path / f"{sc.name}.png").exists()


def test_microbench_rows_on_cpu(capsys):
    rows = microbench.main(["--device", "cpu", "--rays", "4096", "--k", "1"])
    names = [name for name, _ in rows]
    assert len(names) == 8 and "texture sample (K4)" in names
    assert all(ms > 0 for _, ms in rows)
    assert '"rows_ms"' in capsys.readouterr().out


def test_microbench_atlas_is_the_jax_packages():
    """The texture rows sample the JAX microbench's atlas: the mip chain of
    np.random.default_rng(5)'s 512x512x3 uniform draw, bit for bit."""
    texels = np.random.default_rng(5).uniform(size=(512, 512, 3))
    want = jax_atlas([texels.astype(np.float32)])
    got = microbench.bench_atlas()
    for field in ("offsets", "sizes", "n_levels", "data4q"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape and a.itemsize == b.itemsize, field
        np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=field)


def test_profiling(tmp_path):
    sc = configs.SCENARIOS[1]
    scene = sc.build()
    ft = FrameTimer(device="cpu")
    with trace_to(str(tmp_path), device="cpu") as prof:
        for _ in range(3):
            with ft.frame():
                out = render(scene, sc.camera, 16, 16, sc.settings(),
                             device="cpu")
                ft.add_rays(out["rays_traced"])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert prof.key_averages()
    s = ft.summary()
    assert s["frames"] == 2 and s["mean_ms"] > 0 and s["fps"] > 0
    assert s["mrays_per_s"] == pytest.approx(
        2 * out["rays_traced"] / sum(ft.times[1:]) / 1e6)
    assert FrameTimer(device="cpu").summary() == {}


def test_ladder_file(monkeypatch, tmp_path):
    """bench's ladder at tiny sizes (config 8's mesh swapped for a small
    one): the JSON contract of tests/test_metrics_contract.py, plus the
    device and each row's window_ms."""
    for n, sc in list(configs.SCENARIOS.items()):
        changes = dict(width=16, height=8)
        if n == 8:
            changes["scene"] = lambda: procedural.scene_multi_torus(False)
        _small(configs, monkeypatch, n, **changes)
    monkeypatch.setattr(bench, "FRONT_FRAMES", {n: 2 for n in range(1, 9)})
    monkeypatch.setattr(bench, "SEQ_FRAMES", {n: 2 for n in range(1, 9)})
    path = tmp_path / "ladder.json"
    head = bench.headline(frames=2, device="cpu")
    assert 0.0 <= head["mfu"] <= 1.0 and head["cull_speedup"] >= 1.0
    bench.write_ladder(str(path), head, device="cpu")
    ladder = json.loads(path.read_text())

    assert "sequence" in ladder["protocol"]
    assert "mrays_per_s" in ladder["protocol"]
    assert ladder["headline_mrays_per_s_per_chip"] == head["value"] > 0
    assert 0.0 <= ladder["headline_mfu"] <= 1.0
    assert ladder["headline_cull_speedup"] >= 1.0
    assert ladder["device"] == "cpu"
    rows = ladder["ladder"]
    assert [r["scenario"] for r in rows] == [
        configs.SCENARIOS[n].name for n in range(1, 9)]
    for r in rows:
        assert {"scenario", "frames", "rays_per_frame",
                "mrays_per_s_sequence", "window_ms",
                "window_ms_sequence"} <= set(r)
        assert r["rays_per_frame"] > 0 and r["frames"] >= 1
        for key in ("mfu", "mfu_sequence"):
            assert 0.0 <= r[key] <= 1.0, (r["scenario"], key)
        assert r["cull_speedup"] >= 1.0, r["scenario"]
        for key in ("window_ms", "window_ms_sequence"):
            lo, med, hi = r[key]
            assert 0 < lo <= med <= hi
    # config 5 keeps its own 8 animated frames
    assert rows[4]["frames"] == 8


def test_default_device_is_cuda(monkeypatch):
    """Without a GPU the front doors raise: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        configs.run_scenario(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.main(["--rays", "2048"])
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameTimer()


def test_ladder_default_path_is_ignored_by_git():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(bench.LADDER_PATH, root)
    assert rel == os.path.join("smoke_out", "ladder_h100.json")
    with open(os.path.join(root, ".gitignore")) as f:
        assert "smoke_out/" in f.read().split()
