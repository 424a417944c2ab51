"""Ladder config 4 (the 1,024-torus instanced grid) as the benchmark's data
gives it (`rtbench/configs/config4.json`), on the CPU:

* the config's scene data is the ladder's `SCENARIOS[4]` scene written
  one model a torus (the benchmark's scene data has no instances), and the
  program builds the same K2 tables from both: transforms, radii, torus
  and chunk boxes, the tree, each torus row's material values; only the
  material table's length differs (1,025 equal rows against 2);
* the port's kernel backend takes K2's gated chunks (16 tori a chunk) on
  all 1,024 tori, and its `render_frames` frames of two turntable views
  (one batch, with dumps) agree with the plain reference
  (`rtbench.reference`) on every pixel within the cell's four limits;
* `utils.profiling.record_segments` lists each segment's K2 calls with
  their lanes, 1,024 torus rows and 64 ranked chunks, their work counts
  None on the CPU (only the card counts), records nothing outside its
  block, and leaves the outputs' bits as they were.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import check, frontdoor, manifest, scenedata
from rtbench.reference import scene as ref_scene
from rtbench.traffic import generator
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops import torus_kernel, trace_kernel
from toroidal_ray_tracing_tpu_torch.scene.build import build_scene
from toroidal_ray_tracing_tpu_torch.scene.types import Torus
from toroidal_ray_tracing_tpu_torch.utils import profiling

W, H = 48, 27
CELL = "config4.grid_batch4"
K = 1024


def test_the_config_scene_data_is_the_ladders():
    """Every torus's radii, material and world transform, and the floor's
    arrays, against the ladder's one model and its 1,023 instances."""
    cfg = manifest.config("config4")
    assert (cfg["width"], cfg["height"], cfg["max_depth"], cfg["spp"]) == \
        (SCENARIOS[4].width, SCENARIOS[4].height, SCENARIOS[4].max_depth, 1)
    got = frontdoor.scene_def(scenedata.models(cfg["scene"]))
    want = SCENARIOS[4].scene()
    assert len(got.models) == len(got.instances) == K + 1
    assert len(want.models) == 2 and len(want.instances) == K + 1
    for a, b in zip(got.instances, want.instances):
        ma, mb = got.models[a.obj_index], want.models[b.obj_index]
        assert type(ma) is type(mb)
        assert np.array_equal(a.transform, b.transform)
        (mat_a,), (mat_b,) = ma.materials, mb.materials
        for f in scenedata.MATERIAL_FIELDS:
            assert np.array_equal(np.asarray(mat_a[f], np.float32),
                                  np.asarray(mat_b[f], np.float32)), f
        if isinstance(ma, Torus):
            assert (ma.major_radius, ma.minor_radius) == \
                (mb.major_radius, mb.minor_radius)
        else:
            for f in ("positions", "normals", "uvs", "indices",
                      "mat_index", "colors"):
                x, y = getattr(ma, f), getattr(mb, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f


def _tables(scene):
    t = scene.tori
    return torus_kernel.torus_tables(
        t.world_to_obj, t.major_radius, t.minor_radius,
        trace_kernel._material_rows(scene, t.mat_id).contiguous())


def test_the_config_builds_the_ladders_k2_tables():
    got = build_scene(frontdoor.scene_def(scenedata.models(
        manifest.config("config4")["scene"])), use_native=False)
    want = build_scene(SCENARIOS[4].scene(), use_native=False)
    # the torus rows, bit for bit, but their material index: one material
    # row a model here, one for the ladder's instanced torus
    for f in dataclasses.fields(got.tori):
        if f.name != "mat_id":
            assert torch.equal(getattr(got.tori, f.name),
                               getattr(want.tori, f.name)), f.name
    for f in dataclasses.fields(got.triangles):
        if f.name != "mat_id":
            assert torch.equal(getattr(got.triangles, f.name),
                               getattr(want.triangles, f.name)), f.name
    assert got.materials.illum.shape == (K + 1,)
    assert want.materials.illum.shape == (2,)
    for part in ("tori", "triangles"):
        a = trace_kernel._material_rows(got, getattr(got, part).mat_id)
        b = trace_kernel._material_rows(want, getattr(want, part).mat_id)
        assert torch.equal(a, b), part
    # K2's tables: gated chunks of 16, 64 chunk boxes, a tree over 1,024
    # torus boxes, the material rows
    a, b = _tables(got), _tables(want)
    assert (a.K, a.chunk, a.depth) == (b.K, b.chunk, b.depth) == \
        (K, torus_kernel.GATED_TORUS_CHUNK, b.depth)
    assert a.clo.shape == (K // a.chunk, 3)
    assert a.tree_lo.shape == (2 * K - 1, 3)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.fixture(scope="module")
def grid_port():
    """The config's scene on the CPU at W x H, with the cell's two first
    views of a seed (the traffic's turntable) as one `render_frames` call
    of one batch, with dumps."""
    cfg = dict(manifest.config("config4"), width=W, height=H)
    port = frontdoor.Port(cfg, "cpu")
    views = generator.views(manifest.traffic("grid_batch4"), 2**31 + 5)[:2]
    call = generator.Call(0, "render_frames",
                          tuple(cam for cam, _ in views), 0.0, 0,
                          (("dumps", True), ("frames_per_batch", 2)))
    return cfg, port, call


def _frames(port, call):
    return port.renderer.render_frames(
        port.scene, [frontdoor.camera(c) for c in call.cameras], W, H,
        port.settings, backend="kernel", spp=1, seed=0, device="cpu",
        **dict(call.door_args))


def test_the_gated_k2_route_agrees_with_the_reference(grid_port):
    cfg, port, call = grid_port
    segments = []
    with profiling.record_segments(segments):
        out = _frames(port, call)
    calls = [c for s in segments for c in s[2]]
    assert calls and {c.kernel for c in calls} == {"torus_closest_hit"}
    tables = [v for k, v in port.scene.kernel_tables.items()
              if k[0] == "torus"]
    assert tables and all(t[-1].chunk == torus_kernel.GATED_TORUS_CHUNK
                          for t in tables)

    answers = frontdoor.frame_outputs(call, out)
    assert [sorted(a) for a in answers] == \
        [sorted(frontdoor.OUTPUT_KEYS)] * 2
    items = check.take(call, answers, np.random.default_rng(0), W, H, W * H)
    assert all(len(it[2]) == W * H for it in items)
    refs = check.reference_answers(
        items, cfg, ref_scene.tables(scenedata.models(cfg["scene"]), "cpu"))
    nums = check.numbers(items, refs)
    correct, checks = check.verdict(nums, manifest.workload(CELL)["limits"])
    assert correct, checks
    # the frames show the grid: most pixels' first hits are on a torus or
    # the floor, not the sky
    hits = torch.cat([it[4]["hit_position"] for it in items])
    assert float((hits.abs().sum(dim=-1) > 0).float().mean()) > 0.5


def test_the_record_lists_each_segments_k2_calls(grid_port):
    cfg, port, call = grid_port
    bare = _frames(port, call)
    assert profiling.HIT_CALLS is None
    segments = []
    with profiling.record_segments(segments):
        recorded = _frames(port, call)
    assert profiling.HIT_CALLS is None
    for key in ("images", "hit_positions", "ray_origins", "ray_dirs"):
        assert torch.equal(bare[key], recorded[key]), key
    # matte surfaces: one segment for the batch's two frames, its closest
    # and any-hit queries each one K2 launch over every lane
    assert len(segments) == 1
    (lanes, live, calls), = segments
    assert lanes >= 2 * W * H and live >= 1
    closest, shadow = calls
    for c in calls:
        assert c.kernel == "torus_closest_hit" and c.lanes == lanes
        assert (c.tori, c.ranked, c.nodes, c.boxes) == (
            K, K // torus_kernel.GATED_TORUS_CHUNK, 2 * K - 1, 0)
        # the CPU twin counts nothing
        assert c.box_tests is None and c.quartics is None
    assert closest.attrs and not closest.occ_out
    assert not shadow.attrs and shadow.occ_out and shadow.occ_or
    # nothing is recorded outside the block
    _frames(port, call)
    assert [len(s[2]) for s in segments] == [2]
