"""Ladder config 8 (the 1.18M-triangle streamed mesh) as the benchmark's
data gives it (`rtbench/configs/config8.json`), on the CPU:

* the config's scene data is the ladder's `SCENARIOS[8]` scene, and the
  program builds the same tables from both;
* the port's kernel backend takes the streamed route (K5's twin) on the
  config's scene, cut to 64 x 64 quads (a cut at which the build still
  leaves the floor as the loose tail S1 tests, as at the full size) with
  `TRI_STREAM_MIN` below its rows, and its `render_sequence` frames of two
  turntable views agree with the plain reference (`rtbench.reference`)
  within the cell's limits;
* `utils.profiling.record_segments` lists each segment's hit-kernel calls
  (the stream walk's with their lanes and flags), records nothing outside
  its block, and leaves the output's bits as they were.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import check, frontdoor, manifest, scenedata
from rtbench.reference import render_pixels
from rtbench.reference import scene as ref_scene
from rtbench.traffic import generator
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel
from toroidal_ray_tracing_tpu_torch.scene.build import build_scene
from toroidal_ray_tracing_tpu_torch.utils import profiling

W, H = 32, 24
SEG = 64
CELL = "config8.hires_orbit"
STREAM = ("tri_closest_hit_stream", "tri_closest_hit_stream_grouped")


def config(seg=None):
    """config8.json, its mesh cut to seg x seg quads (None: as it is)."""
    cfg = manifest.config("config8")
    if seg:
        for m in cfg["scene"]["models"]:
            if m["type"] == "torus_mesh":
                m["seg_major"] = m["seg_minor"] = seg
    return cfg


def test_the_config_scene_data_is_the_ladders():
    """Every model's arrays, material and transform, at the full 768 x 768
    quads."""
    cfg = config()
    assert (cfg["width"], cfg["height"], cfg["max_depth"], cfg["spp"]) == \
        (SCENARIOS[8].width, SCENARIOS[8].height, SCENARIOS[8].max_depth, 1)
    got = frontdoor.scene_def(scenedata.models(cfg["scene"]))
    want = SCENARIOS[8].scene()
    assert sum(m.num_triangles for m in got.models) == 1_179_650
    assert len(got.models) == len(want.models) == 2
    for a, b in zip(got.models, want.models):
        for f in ("positions", "normals", "uvs", "indices", "mat_index",
                  "colors"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        (ma,), (mb,) = a.materials, b.materials
        for f in scenedata.MATERIAL_FIELDS:
            assert np.array_equal(np.asarray(ma[f], np.float32),
                                  np.asarray(mb[f], np.float32)), f
    for a, b in zip(got.instances, want.instances):
        assert a.obj_index == b.obj_index
        assert np.array_equal(a.transform, b.transform)


def test_the_config_builds_the_ladders_tables():
    got = build_scene(frontdoor.scene_def(scenedata.models(
        config(SEG)["scene"])), use_native=False)
    want = build_scene(SCENARIOS[8].scene(seg=SEG), use_native=False)
    assert got.cluster_size == want.cluster_size
    assert got.loose_tris == want.loose_tris
    for part in ("triangles", "tori", "materials"):
        a, b = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                (part, f.name)


@pytest.fixture(scope="module")
def stream_port():
    """The cut config's scene on the CPU, with the cell's two first views
    of a seed (the traffic's turntable)."""
    cfg = dict(config(SEG), width=W, height=H)
    port = frontdoor.Port(cfg, "cpu")
    views = generator.views(manifest.traffic("hires_orbit"), 2**31 + 7)[:2]
    return cfg, port, [cam for cam, _ in views]


def _frames(port, views):
    return [port.renderer.render_sequence(
        port.scene, [frontdoor.camera(v)], W, H, port.settings,
        backend="kernel", spp=1, seed=0, device="cpu")["images"][0]
        for v in views]


def test_the_stream_route_agrees_with_the_reference(stream_port,
                                                     monkeypatch):
    cfg, port, views = stream_port
    assert port.scene.triangles.count > 1024 and port.scene.loose_tris
    monkeypatch.setattr(trace_kernel, "TRI_STREAM_MIN", 1024)
    segments = []
    with profiling.record_segments(segments):
        images = _frames(port, views)
    kernels = {c.kernel for s in segments for c in s[2]}
    assert kernels and kernels <= set(STREAM), kernels

    tables = ref_scene.tables(scenedata.models(cfg["scene"]), "cpu")
    settings = dict(cfg["settings"], max_depth=cfg["max_depth"])
    ys, xs = np.divmod(np.arange(W * H), W)
    items, refs = [], []
    for view, img in zip(views, images):
        ref = render_pixels(tables, view, 0.0, W, H, settings, xs, ys, 1, 0,
                            0)
        items.append((None, 0, xs, ys, {"image": img.reshape(-1, 3)}))
        refs.append({"image": ref["image"]})
    nums = check.numbers(items, refs)
    correct, checks = check.verdict(nums, manifest.workload(CELL)["limits"])
    assert correct, checks


def test_the_record_lists_each_segments_stream_calls(stream_port,
                                                      monkeypatch):
    cfg, port, views = stream_port
    monkeypatch.setattr(trace_kernel, "TRI_STREAM_MIN", 1024)
    bare = _frames(port, views)
    assert profiling.HIT_CALLS is None
    segments = []
    with profiling.record_segments(segments):
        recorded = _frames(port, views)
    assert profiling.HIT_CALLS is None
    for a, b in zip(bare, recorded):
        assert torch.equal(a, b)
    # matte surfaces: one segment a frame, its closest and any-hit queries
    assert len(segments) == 2
    tables = port.scene.kernel_tables
    mesh = next(v[2] for k, v in tables.items() if k[0] == "stream")
    for lanes, live, calls in segments:
        assert lanes >= W * H and live >= 1
        closest, shadow = calls
        for c in calls:
            assert c.kernel == "tri_closest_hit_stream" and c.lanes == lanes
            assert (c.nodes, c.ranked, c.boxes, c.tori) == (
                mesh.tree_lo.shape[0], mesh.sb_lo.shape[0],
                mesh.clo.shape[0], 0)
            assert not c.tmax_out        # no torus kernel after it
        # the closest query writes the attribute rows; the any-hit query
        # ORs into the occlusion byte S1 (the floor) wrote first
        assert closest.attrs and not closest.occ_out
        assert not shadow.attrs and shadow.occ_out and shadow.occ_or
    # nothing is recorded outside the block
    _frames(port, views[:1])
    assert [len(s[2]) for s in segments] == [2, 2]
