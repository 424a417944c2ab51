"""The bounce loop's segment plan (`ops.segment_plan`) on the CPU, through
the kernels' plain twins, which write into the plan's workspace.

(a) A front door's frame through the plan is bit-equal to the wrappers'
    default route (`wavefront.segment_plan` patched to give no plan):
    image, dumps, rays_traced, on the capture's scene layout (tessellated
    tori over a mirror floor) in a toroidal frame to depth 10 compacting
    into every bucket (S1, K1, V1); on analytic tori over a mirror plane
    with K2 on the larger buckets and K3 on the smaller (the route's
    threshold patched down to the test's sizes); on a mesh over the
    stream threshold (K5, the threshold patched down); and on a textured
    scene (K4, K1, K3 with K = 1).
(b) Each wrapper that takes the rays' row stride gives the same answer
    on a strided prefix of a state as on its contiguous copy, with its
    own outputs or a plan's (`Planned`); element-strided rows are refused.
(c) The plan's lifecycle: over several calls of one scene and size it is
    built once and `plan_segments` counts every segment; other lanes
    replace it; the banded path, `trace_rays` (the sharded path's entry),
    a geometry slice and the torch backend run no segment from it.
(d) Every C entry point's parameters against `kernel_common._SIGNATURES`;
    host settings uploaded once per device and values; the shading
    constants kept per settings tensors and numbers.
"""

import dataclasses
import glob
import os
import re

import pytest
import torch

from toroidal_ray_tracing_tpu_torch import (PinholeCamera, ToroidalCamera,
                                            render, render_frames,
                                            render_sequence)
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import segment_plan as sp
from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk
from toroidal_ray_tracing_tpu_torch.ops.loose_kernel import loose_hit
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import (
    torus_closest_hit_chunked, torus_closest_hit_small)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import tri_closest_hit
from toroidal_ray_tracing_tpu_torch.ops.tri_stream import (
    tri_closest_hit_stream)
from toroidal_ray_tracing_tpu_torch.render import renderer
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.scene.types import SceneDef
from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf
from toroidal_ray_tracing_tpu_torch.trace.intersect import geom_from_scene
from toroidal_ray_tracing_tpu_torch.utils import math3d, profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))


def capture_like():
    """The capture's layout (config 6): two mirror and two matte tori,
    tessellated 16 x 8, over a mirror floor."""
    p = procedural
    s = SceneDef()

    def mk(R, r, m):
        return p.torus_mesh(R, r, seg_major=16, seg_minor=8, material=m)

    s.add_model(mk(1.6, 0.5, p.mirror()), math3d.translation((0.0, 0.8, 0.0)))
    s.add_model(mk(1.2, 0.4, p.matte((0.9, 0.25, 0.2))),
                math3d.compose(math3d.translation((-3.5, 0.6, 1.5)),
                               math3d.rotation_x(90.0)))
    s.add_model(mk(1.0, 0.35, p.matte((0.2, 0.4, 0.9))),
                math3d.compose(math3d.translation((3.2, 0.5, -1.0)),
                               math3d.rotation_z(90.0)))
    s.add_model(mk(0.8, 0.3, p.mirror((0.7, 0.8, 0.9))),
                math3d.translation((1.5, 0.4, 3.0)))
    s.add_model(p.plane(14.0, material=p.mirror((0.6, 0.6, 0.6),
                                                (0.25, 0.25, 0.28))))
    return s


# name: (scene, camera, width, height, settings, the kernels it must launch
# through the plan)
CASES = {
    "capture_depth10": (
        lambda: procedural.scene_multi_torus(analytic=False),
        ToroidalCamera(eye=(0.0, 1.5, 0.0), center=(8.0, 0.0, 0.0)),
        64, 64, dict(max_depth=10, rho=4.0), {"s1", "k1", "v1"}),
    "tori_k2_k3": (lambda: procedural.scene_multi_torus(analytic=True), PIN,
                   96, 96, dict(max_depth=3), {"s1", "k2", "k3", "v1"}),
    "stream_k5": (lambda: procedural.scene_multi_torus(analytic=False), PIN,
                  64, 48, dict(max_depth=2), {"s1", "k5", "v1"}),
    "textured_k4": (procedural.scene_textured_mesh, PIN, 64, 48,
                    dict(max_depth=3), {"k1", "k3", "k4", "v1"}),
}
_SCENES: dict = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = build_scene(CASES[name][0]())
    return _SCENES[name]


def _routes(name, monkeypatch):
    """The case's route patches: buckets of n, n / 2 and n / 4 lanes down
    to 1,024 (the capture), K3 below 4,096 padded rays (tori), the stream
    kernels above 1,024 triangles (K5)."""
    if name == "capture_depth10":
        monkeypatch.setattr(wf, "COMPACT_FACTORS", (2, 4))
        monkeypatch.setattr(wf, "COMPACT_MIN", 1024)
    if name == "tori_k2_k3":
        small = (lambda n_batch, K: K <= 8 and n_batch <= 4096)
        monkeypatch.setattr(tk, "use_small_kernel", small)
        monkeypatch.setattr(sp, "use_small_kernel", small)
    if name == "stream_k5":
        monkeypatch.setattr(tk, "TRI_STREAM_MIN", 1024)


def _spy(monkeypatch, seen):
    """Record which kernels run (their wrappers) and each segment's lanes."""
    import toroidal_ray_tracing_tpu_torch.ops.torus_kernel as tok

    def wrap(mod, attr, key):
        real = getattr(mod, attr)

        def spied(*a, **k):
            seen["kernels"].add(key)
            return real(*a, **k)

        monkeypatch.setattr(mod, attr, spied)

    wrap(tk, "loose_hit", "s1")
    wrap(tk, "tri_closest_hit", "k1")
    wrap(tk, "tri_closest_hit_stream", "k5")
    wrap(tok, "torus_closest_hit_chunked", "k2")
    wrap(tok, "torus_closest_hit_small", "k3")
    wrap(wf, "quad_gather", "k4")
    wrap(vk, "visit_ranks", "v1")
    wrap(tk, "visit_ranks", "v1")
    real = wf.closest_hit

    def query(scene, o, d, tmax=None, **kw):
        seen["lanes"].append(int(tmax.shape[0]))
        return real(scene, o, d, tmax=tmax, **kw)

    monkeypatch.setattr(wf, "closest_hit", query)


def _frame(name, monkeypatch, planned: bool):
    _, cam, w, h, st, _ = CASES[name]
    scene = _scene(name)
    seen = {"kernels": set(), "lanes": []}
    with monkeypatch.context() as m:
        _routes(name, m)
        _spy(m, seen)
        if not planned:
            m.setattr(wf, "segment_plan", lambda *a, **k: None)
        before = dict(profiling.COUNTERS)
        out = render(scene, cam, w, h, RenderSettings.default(**st),
                     backend="kernel", device="cpu")
        got = {k: profiling.COUNTERS[k] - before[k]
               for k in ("plan_segments", "plan_builds")}
    return out, seen, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_route_is_bit_equal_to_the_default_route(name, monkeypatch):
    """(a) The same frame through the plan and through the wrappers'
    default route: every output bit, the ray count, the segments and
    their lanes; the plan's kernels are the case's, and on the capture
    layout its segments trace every bucket."""
    plain, seen0, got0 = _frame(name, monkeypatch, planned=False)
    planned, seen1, got1 = _frame(name, monkeypatch, planned=True)
    assert got0["plan_segments"] == 0
    assert got1["plan_segments"] == len(seen1["lanes"]) > 0
    assert seen1["lanes"] == seen0["lanes"]
    assert seen1["kernels"] == seen0["kernels"] >= CASES[name][5], (
        name, seen1["kernels"])
    assert planned["rays_traced"] == plain["rays_traced"] > 0
    for k in ("image", "hit_position", "ray_origin", "ray_dir"):
        assert torch.equal(planned[k], plain[k]), (name, k)
    if name == "capture_depth10":
        # every bucket: 4,096, 2,048 and 1,024 lanes
        assert sorted(set(seen1["lanes"])) == [1024, 2048, 4096]


def test_batched_front_doors_are_bit_equal_through_the_plan(monkeypatch):
    """(a) Two frames a batch (`render_frames`, channel-major, with dumps)
    and a sequence, each through the plan and the default route."""
    scene = _scene("tori_k2_k3")
    cams = [PIN, PinholeCamera(eye=(-8.0, 4.0, 6.0), center=(0.0, 0.5, 0.0))]
    st = RenderSettings.default(max_depth=4)

    def both():
        return (render_frames(scene, cams, 64, 48, st, backend="kernel",
                              device="cpu", frames_per_batch=2),
                render_sequence(scene, cams, 64, 48, st, backend="kernel",
                                device="cpu", frames_per_batch=1))

    planned = both()
    with monkeypatch.context() as m:
        m.setattr(wf, "segment_plan", lambda *a, **k: None)
        plain = both()
    for a, b in zip(planned, plain):
        assert a["rays_traced"] == b["rays_traced"] > 0
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k]), k


# ---------------------------------------------------------------------------
# (b) strided rows
# ---------------------------------------------------------------------------


def _state_rays(n_lanes, nb, seed=0):
    """A (15, n_lanes) state whose first nb lanes hold pinhole rays toward
    the scenes' middle (every 5th lane dead: tmax 0), and the prefix's
    strided rows with their contiguous copies."""
    g = torch.Generator().manual_seed(seed)
    state = torch.zeros((15, n_lanes))
    eye = torch.tensor([7.0, 4.5, 7.0])[:, None]
    target = torch.randn((3, nb), generator=g) * 1.5
    d = target - eye
    state[0:3, :nb] = eye
    state[3:6, :nb] = d / d.norm(dim=0, keepdim=True)
    tmax = torch.full((nb,), 1.0e4)
    tmax[::5] = 0.0
    o, dd = state[0:3, :nb], state[3:6, :nb]
    assert o.stride() == (n_lanes, 1) and not o.is_contiguous()
    return o, dd, o.contiguous(), dd.contiguous(), tmax


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _equal(x, y)


def _planned_like(got):
    return kc.Planned([torch.empty_like(t) for t in got])


@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "any"])
def test_strided_rows_give_the_contiguous_answer(occlusion):
    """(b) S1, K1, K5, K2, K3 and S2 on a strided prefix of a state and on
    its contiguous copy, with their own outputs and a plan's: the same
    bits, the folds too."""
    nb = 1000
    o, d, oc, dc, tmax = _state_rays(1536, nb)
    tori = build_scene(procedural.scene_multi_torus(analytic=True))
    mesh = build_scene(capture_like())
    stream = build_scene(procedural.scene_multi_torus(analytic=False))
    calls = []
    gt = geom_from_scene(tori)
    route_t = tk._route(tori, gt, 2048)
    calls.append(lambda o_, d_, **k: loose_hit(
        o_, d_, tmax, gt.woop_o, gt.woop_d, route_t.tri.base, route_t.tri.L,
        route_t.tri.base, occlusion, **k))
    tables = route_t.tor
    calls.append(lambda o_, d_, **k: torus_closest_hit_chunked(
        o_, d_, tmax, tables, want_attrs=not occlusion, occlusion=occlusion,
        **k))
    calls.append(lambda o_, d_, **k: torus_closest_hit_small(
        o_, d_, tmax, tables, want_attrs=not occlusion, occlusion=occlusion,
        **k))
    gm = geom_from_scene(mesh)
    plan_m = tk._tri_plan(mesh, gm)
    attrs = None if occlusion else tk._kept_attr_tables(mesh, plan_m)
    calls.append(lambda o_, d_, **k: tri_closest_hit(
        o_, d_, tmax, plan_m.mesh, attr_tables=attrs, occlusion=occlusion,
        **k))
    tk_min = tk.TRI_STREAM_MIN
    try:
        tk.TRI_STREAM_MIN = 1024
        gs = geom_from_scene(stream)
        plan_s = tk._tri_plan(stream, gs)
    finally:
        tk.TRI_STREAM_MIN = tk_min
    assert plan_s.stream
    calls.append(lambda o_, d_, **k: tri_closest_hit_stream(
        o_, d_, tmax, plan_s.mesh, occlusion=occlusion, **k))
    for call in calls:
        want = call(oc, dc)
        _equal(call(o, d), want)
        _equal(call(o, d, out=_planned_like(want)), want)
    if not occlusion:
        rows, _ = tk._query(mesh, gm, oc, dc, tmax, True, False, None)
        params = sk.shade_params(mesh, RenderSettings.default())
        want = sk.shade_hit(oc, dc, rows, params)
        for got in (sk.shade_hit(o, d, rows, params),
                    sk.shade_hit(o, d, rows, params, out=kc.Planned(
                        [torch.empty_like(t) for t in (
                            want.shadow_o, want.shadow_d, want.shadow_tmax,
                            want.block, want.flags)]))):
            for f in ("shadow_o", "shadow_d", "shadow_tmax", "block",
                      "flags"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_element_strided_rows_are_refused():
    """(b) A row stride is taken, an element stride is not; origins and
    dirs must share the row stride."""
    o, d, oc, dc, tmax = _state_rays(1536, 1000)
    assert kc.check_rays(o, d, tmax) == 1536
    assert kc.check_rays(oc, dc, tmax) == 1000
    with pytest.raises(ValueError):
        kc.check_rays(o, dc, tmax)
    wide = torch.zeros((3, 2000))
    with pytest.raises(ValueError):
        kc.check_rays(wide[:, ::2], wide[:, ::2], tmax)


# ---------------------------------------------------------------------------
# (c) lifecycle
# ---------------------------------------------------------------------------


def _count(fn):
    before = dict(profiling.COUNTERS)
    out = fn()
    return out, {k: profiling.COUNTERS[k] - before[k]
                 for k in ("plan_builds", "plan_segments")}


def test_plan_is_built_once_and_counts_every_segment(monkeypatch):
    """(c) Three sequence calls and a render of one scene and size: one
    plan, kept on the scene, every segment run from it; a call at other
    lanes replaces it (one plan on the scene, built for the new lanes)."""
    scene = build_scene(capture_like())
    st = RenderSettings.default(max_depth=4)
    segments = []
    real = wf.shade_finish
    monkeypatch.setattr(wf, "shade_finish",
                        lambda *a, **k: segments.append(1) or real(*a, **k))

    def calls():
        for _ in range(3):
            render_sequence(scene, [PIN], 64, 48, st, backend="kernel",
                            device="cpu")
        render(scene, PIN, 64, 48, st, backend="kernel", device="cpu")

    _, got = _count(calls)
    assert got == {"plan_builds": 1, "plan_segments": len(segments)}
    assert len(segments) >= 8
    plans = [k for k in scene.kernel_tables if k[0] == "segment_plan"]
    assert len(plans) == 1
    plan = scene.kernel_tables[plans[0]]
    assert plan.sizes == wf.bucket_sizes(64 * 48)
    _, got = _count(lambda: render(scene, PIN, 80, 48, st, backend="kernel",
                                   device="cpu"))
    assert got["plan_builds"] == 1 and got["plan_segments"] > 0
    plans = [k for k in scene.kernel_tables if k[0] == "segment_plan"]
    assert len(plans) == 1
    assert scene.kernel_tables[plans[0]].sizes == wf.bucket_sizes(80 * 48)


def test_plan_rebuilds_when_a_table_changes():
    """(c) A scene tensor changed in place rebuilds the kept tables, and
    with them the plan; the frame equals a fresh scene's."""
    scene = build_scene(procedural.scene_multi_torus(analytic=True))
    st = RenderSettings.default(max_depth=2)
    render(scene, PIN, 48, 48, st, backend="kernel", device="cpu")
    with torch.no_grad():
        scene.tori.minor_radius.mul_(1.25)
    fresh = dataclasses.replace(scene)
    fresh.kernel_tables = {}
    (out, got) = _count(lambda: render(scene, PIN, 48, 48, st,
                                       backend="kernel", device="cpu"))
    want = render(fresh, PIN, 48, 48, st, backend="kernel", device="cpu")
    assert got["plan_builds"] == 1
    assert torch.equal(out["image"], want["image"])


def test_other_routes_run_no_segment_from_a_plan():
    """(c) The torch backend, the banded path, `trace_rays` (the sharded
    path's and the banded bands' entry) and a loop on a geometry slice
    (what a sharded rank passes) keep their route: no plan segment."""
    scene = build_scene(capture_like())
    st = RenderSettings.default(max_depth=3)
    n = 64 * 48
    o = torch.tensor([[8.0], [5.0], [8.0]]).expand(3, n).contiguous()
    d = -o / o.norm(dim=0, keepdim=True)
    lanes = wf.lane_count(n, "kernel")

    def sliced():
        state, active = wf.new_state(lanes, o.device)
        wf.fill_state_plain(state, active, o, d, 0, lanes - n)
        return wf.trace_state(scene, st, state, active, n, "kernel",
                              geom=geom_from_scene(scene), planned=True)

    for fn in (lambda: render(scene, PIN, 64, 48, st, backend="torch",
                              device="cpu"),
               lambda: render(scene, PIN, 64, 48, st, backend="kernel",
                              device="cpu", tile_rows=16),
               lambda: wf.trace_rays(scene, st, o, d, backend="kernel"),
               sliced):
        _, got = _count(fn)
        assert got == {"plan_builds": 0, "plan_segments": 0}


# ---------------------------------------------------------------------------
# (d) entry points, settings, shading constants
# ---------------------------------------------------------------------------


def test_entry_point_signatures_match_the_sources():
    """(d) Every `extern "C"` entry point in csrc/*.cu takes the parameters
    `_SIGNATURES` declares, kind by kind (pointer, int, int64, float,
    uint32), the stream last."""
    src = "".join(open(f).read() for f in sorted(glob.glob(os.path.join(
        kc.CSRC, "*.cu"))))
    kinds = {kc._P: "p", kc._I: "i", kc._L: "l", kc._F: "f",
             kc.ctypes.c_uint32: "u"}

    def kind(param):
        if "*" in param:
            return "p"
        for prefix, k in (("long long", "l"), ("int64_t", "l"),
                          ("float", "f"), ("unsigned", "u"),
                          ("uint32_t", "u")):
            if param.startswith(prefix):
                return k
        return "i"

    found = {}
    for m in re.finditer(r'extern "C" int (trt_\w+)\((.*?)\)\s*\{', src,
                         re.S):
        found[m.group(1)] = "".join(kind(p.strip())
                                    for p in m.group(2).split(","))
    assert set(found) == set(kc._SIGNATURES)
    for name, sig in kc._SIGNATURES.items():
        assert found[name] == "".join(kinds[t] for t in sig), name


def test_settings_upload_once_per_device_and_values():
    """(d) Equal host settings share one device copy of their tensors (a
    meta device stands in for the card), kept in the dict handed in;
    other values replace it, and a tensor that needs a gradient, or a CPU
    render, takes none."""
    dev, kept = torch.device("meta"), {}
    a = renderer.settings_to(RenderSettings.default(), dev, kept)
    b = renderer.settings_to(RenderSettings.default(), dev, kept)
    assert a.clear_color.device == dev and list(kept) == [("settings", dev)]
    assert a.clear_color is b.clear_color
    assert a.light.position is b.light.position
    c = renderer.settings_to(RenderSettings.default(light_intensity=50.0),
                             dev, kept)
    assert c.light.position is a.light.position and c.light.intensity == 50.0
    e = renderer.settings_to(
        RenderSettings.default(light_position=(1.0, 2.0, 3.0)), dev, kept)
    assert e.light.position is not a.light.position and len(kept) == 1
    zero = RenderSettings.default(light_position=(0.0, 5.0, 0.0))
    neg = RenderSettings.default(light_position=(-0.0, 5.0, 0.0))
    assert (renderer.settings_to(zero, dev, kept).light.position
            is not renderer.settings_to(neg, dev, kept).light.position)
    g = RenderSettings.default()
    g.light.position.requires_grad_(True)
    plain = RenderSettings.default()
    assert renderer.settings_to(g, dev, kept).light.position is not \
        renderer.settings_to(plain, dev, kept).light.position
    host = RenderSettings.default()
    assert renderer.settings_to(host, torch.device("cpu"),
                                kept).clear_color is host.clear_color


def test_shading_constants_are_kept_per_settings():
    """(d) `kept_shade_params` is made once for the same settings tensors
    and numbers, again for another number or a tensor changed in place,
    and equals `shade_params` bit for bit."""
    scene = build_scene(procedural.scene_multi_torus(analytic=True))
    st = RenderSettings.default()
    p = sk.kept_shade_params(scene, st)
    assert sk.kept_shade_params(scene, st) is p
    assert torch.equal(p.consts, sk.shade_params(scene, st).consts)
    other = dataclasses.replace(st, pixel_spread=0.5)
    q = sk.kept_shade_params(scene, other)
    assert q is not p and q.pixel_spread == 0.5
    st.light.position.add_(1.0)
    r = sk.kept_shade_params(scene, st)
    assert r is not p
    assert torch.equal(r.consts, sk.shade_params(scene, st).consts)


def test_plan_checks_its_arguments_once():
    """(d) The plan runs the wrappers' checks when it is built: a state of
    the wrong dtype is refused there, and a planned call checks nothing
    (the wrapper's check functions are not called)."""
    scene = build_scene(procedural.scene_multi_torus(analytic=True))
    st = RenderSettings.default(max_depth=2)
    lanes = wf.lane_count(48 * 48, "kernel")
    sizes = wf.bucket_sizes(48 * 48)
    state, active = wf.new_state(lanes, torch.device("cpu"))
    params = sk.kept_shade_params(scene, st)
    with pytest.raises(TypeError):
        sp.segment_plan(scene, state.double(), active, sizes, params)
    render(scene, PIN, 48, 48, st, backend="kernel", device="cpu")
    checked = []
    import toroidal_ray_tracing_tpu_torch.ops.loose_kernel as lk
    real = lk.check_loose_hit
    lk.check_loose_hit = lambda *a, **k: checked.append(1) or real(*a, **k)
    try:
        render(scene, PIN, 48, 48, st, backend="kernel", device="cpu")
    finally:
        lk.check_loose_hit = real
    assert checked == []


def test_planned_queries_return_the_default_routes_parts(monkeypatch):
    """(a) Each planned query hands back the parts the default route's
    query returns (the any-hit query too: its hoist's base, the triangle
    and torus kernels' hits), bit for bit, on every segment."""
    scene = _scene("tori_k2_k3")
    got = {True: [], False: []}
    real = tk._query

    def query(scene_, geom, o, d, tmax, want_attrs, occlusion, ranks):
        rows, occ = real(scene_, geom, o, d, tmax, want_attrs, occlusion,
                         ranks)
        got[ranks.out is not None].append((occlusion, [
            None if p is None else [t.clone() for t in p]
            for p in (rows.base, rows.tri_hit, rows.tor_hit)],
            None if occ is None else occ.clone()))
        return rows, occ

    monkeypatch.setattr(tk, "_query", query)
    _routes("tori_k2_k3", monkeypatch)
    st = RenderSettings.default(max_depth=3)
    render(scene, PIN, 96, 96, st, backend="kernel", device="cpu")
    with monkeypatch.context() as m:
        m.setattr(wf, "segment_plan", lambda *a, **k: None)
        render(scene, PIN, 96, 96, st, backend="kernel", device="cpu")
    assert len(got[True]) == len(got[False]) > 0
    assert {occl for occl, _, _ in got[True]} == {False, True}
    for (o1, parts1, occ1), (o0, parts0, occ0) in zip(got[True],
                                                       got[False]):
        assert o1 == o0
        assert (occ1 is None) == (occ0 is None)
        if occ1 is not None:
            assert torch.equal(occ1, occ0)
        for p1, p0 in zip(parts1, parts0):
            assert (p1 is None) == (p0 is None)
            for a, b in zip(p1 or (), p0 or ()):
                assert torch.equal(a, b)
