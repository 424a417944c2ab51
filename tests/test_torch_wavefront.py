"""The port's live-ray compaction (`trace.wavefront.trace_rays` on
`backend="kernel"`) against the JAX package's compacted
`trace_rays(backend="pallas")` (its kernels in interpret mode on the CPU,
as tests/test_pallas.py runs them) and against itself uncompacted.

Every case feeds both packages the same float32 rays: the JAX package's
NumPy raygen, laid out block-major as `render` lays them out (a 128-ray
span is then a screen patch).

Bounds:
(a) port compacted against JAX compacted: image max |diff| < 5e-4
    (tests/test_golden.py's bound), or at most 4 pixels over 1e-3 where a
    mirror path flips (tests/test_pallas.py's rule); rays_traced exactly
    equal.
(b) port compacted against `COMPACT_FACTORS = ()` on the kernels' CPU
    twins: colors and first hits bit-equal (max |diff| 0), rays_traced
    exactly equal. A span's rays get the same results wherever it sits:
    the kernels' visit order starts from the mean origin of the whole
    batch, and the K2 / K3 route does not change below 2^20 rays.
(c) a spy on the bounce loop's `closest_hit`: every segment traces the
    smallest bucket holding all live spans, the same live rays as the
    uncompacted run, and the mirror scenes' late segments trace less.
(d) the span permutation and its inverse on random masks, against a
    NumPy restatement of the JAX package's (trace/wavefront.py:218-256).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import ToroidalCamera as JaxToroidal
from toroidal_ray_tracing_tpu.cameras import generate_rays as jax_rays
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu.scene.types import SceneDef, Torus
from toroidal_ray_tracing_tpu.trace.wavefront import (
    trace_rays as jax_trace_rays)
from toroidal_ray_tracing_tpu.utils import math3d
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import (pick_block,
                                                            pixel_coords)
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import round_up
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import use_small_kernel
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import RAY_TILE
from toroidal_ray_tracing_tpu_torch.scene import (scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = 128


def mini_config6():
    """Config 6's layout (scene_multi_torus with meshes: two mirror tori,
    two matte ones, a mirror floor) at 16 x 8 segments a torus."""
    p = jax_proc
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


# name: (scene, camera kind, eye, center, settings, width, height, whether
# a late segment traces a smaller bucket)
CASES = {
    "torus_plane": (lambda: jax_proc.scene_torus_plane(analytic=True), "pin",
                    (7.0, 4.0, 7.0), (0.0, 0.3, 0.0), dict(max_depth=3),
                    96, 96, False),
    "config3_multi_torus": (lambda: jax_proc.scene_multi_torus(analytic=True),
                            "pin", (8.0, 5.0, 8.0), (0.0, 0.5, 0.0),
                            dict(max_depth=3), 96, 96, True),
    "mini_config6": (mini_config6, "pin", (8.0, 5.0, 8.0), (0.0, 0.5, 0.0),
                     dict(max_depth=3), 96, 96, True),
    "capture_depth10": (jax_proc.scene_cornellish, "toroidal",
                        (0.0, 1.0, 0.0), (8.0, 0.0, 0.0), dict(rho=4.0),
                        128, 64, True),
}
# (b) also on a batch that is no whole number of spans (6,000 rays: the
# last span holds 112)
ODD = dict(CASES, capture_100x60=CASES["capture_depth10"][:5] + (100, 60,
                                                                 True))

_BUILT: dict = {}


def _case(name):
    """(JAX scene, JAX settings, port scene, port settings, (N, 3) origins,
    (N, 3) dirs), the rays block-major, built once per case."""
    if name not in _BUILT:
        sd, kind, eye, center, st_kw, w, h, _ = ODD[name]
        jscene = jax_build(sd())
        jst = JaxSettings.default(**st_kw)
        cam = (JaxPinhole if kind == "pin" else JaxToroidal)(eye=eye,
                                                             center=center)
        o, d = jax_rays(cam, w, h, jst, xp=np)
        px, py = pixel_coords(w, h, pick_block(w, h))
        order = (py.long() * w + px.long()).numpy()
        o = np.ascontiguousarray(o[order], np.float32)
        d = np.ascontiguousarray(d[order], np.float32)
        _BUILT[name] = (jscene, jst, scene_from_numpy(jscene),
                        settings_from_numpy(jst), o, d)
    return _BUILT[name]


def _port(name, factors=None, monkeypatch=None, spy=None):
    _, _, scene, st, o, d = _case(name)
    if factors is not None:
        monkeypatch.setattr(wf, "COMPACT_FACTORS", factors)
    if spy is not None:
        real = wf.closest_hit

        def counted(scene_, o_, d_, tmax=None, **kw):
            spy.append(tmax.clone())
            return real(scene_, o_, d_, tmax=tmax, **kw)

        monkeypatch.setattr(wf, "closest_hit", counted)
    hv, hp, n = wf.trace_rays(scene, st, torch.from_numpy(o.T.copy()),
                              torch.from_numpy(d.T.copy()), backend="kernel")
    if spy is not None:
        monkeypatch.setattr(wf, "closest_hit", real)
    return hv.T.numpy(), hp.T.numpy(), n


@pytest.mark.parametrize("name", sorted(CASES))
def test_compacted_matches_jax_pallas(name):
    """(a) The port's compacted kernel path against the JAX package's
    compacted pallas path, the same rays."""
    jscene, jst, _, _, o, d = _case(name)
    hv_j, _, n_j = jax_trace_rays(jscene, jst, o, d, backend="pallas")
    hv, _, n = _port(name)
    err = np.abs(hv - np.asarray(hv_j)).max(axis=-1)
    flips = int((err > 1e-3).sum())
    assert err.max() < 5e-4 or flips <= 4, (name, float(err.max()), flips)
    assert n == int(float(n_j)), (name, n, float(n_j))


@pytest.mark.parametrize("name", sorted(ODD))
def test_compacted_equals_uncompacted(name, monkeypatch):
    """(b) Compaction changes no bit of the colors or first hits, and no
    ray of the count."""
    hv, hp, n = _port(name)
    hv0, hp0, n0 = _port(name, (), monkeypatch)
    assert n == n0
    assert float(np.abs(hv - hv0).max()) == 0.0, name
    assert float(np.abs(hp - hp0).max()) == 0.0, name


@pytest.mark.parametrize("name", sorted(ODD))
def test_each_segment_traces_the_smallest_bucket(name, monkeypatch):
    """(c) Each segment's prefix is the smallest of `bucket_sizes` that
    holds every live span, holds the uncompacted run's live rays, and on
    the mirror scenes a late segment traces less than the whole batch."""
    full, packed = [], []
    _port(name, (), monkeypatch, spy=full)
    monkeypatch.undo()
    _port(name, None, monkeypatch, spy=packed)
    n = _case(name)[4].shape[0]
    sizes = wf.bucket_sizes(n)
    assert len(packed) == len(full)
    assert packed[0].shape[0] == sizes[0] and len(sizes) > 1
    for seg, (tf, tp) in enumerate(zip(full, packed)):
        live = int((tp > 0).view(-1, SPAN).any(dim=1).sum())
        want = min(s for s in sizes if s >= live * SPAN)
        assert tp.shape[0] == want, (name, seg, tp.shape[0], want)
        assert int((tp > 0).sum()) == int((tf > 0).sum()), (name, seg)
    shrank = any(t.shape[0] < sizes[0] for t in packed)
    assert shrank == ODD[name][-1], (name, [t.shape[0] for t in packed])


def test_bucket_sizes():
    """Buckets are ceil(n / f) in whole spans, only while n // f holds a
    2048-ray tile; the full bucket pads n to whole spans."""
    assert wf.COMPACT_FACTORS == (2, 4, 8)
    assert wf.bucket_sizes(1920 * 1080) == (2073600, 1036800, 518400,
                                            259200)
    assert wf.bucket_sizes(96 * 96) == (9216, 4608, 2304)
    assert wf.bucket_sizes(6000) == (6016, 3072)
    assert wf.bucket_sizes(4095) == (4095,)
    assert wf.bucket_sizes(2048) == (2048,)
    assert wf.bucket_sizes(9216, ()) == (9216,)
    assert all(s % SPAN == 0 for s in wf.bucket_sizes(1920 * 1080 + 1))


def test_compact_factors_from_the_environment():
    """TRT_COMPACT_FACTORS as the JAX package reads it: "" turns compaction
    off, a list sets the buckets."""
    code = ("from toroidal_ray_tracing_tpu_torch.trace import wavefront as w;"
            "print(w.COMPACT_FACTORS, w.bucket_sizes(9216))")
    got = []
    for value in ("", "2"):
        env = dict(os.environ, TRT_COMPACT_FACTORS=value, PYTHONPATH=ROOT)
        got.append(subprocess.run([sys.executable, "-c", code], env=env,
                                  cwd=ROOT, capture_output=True, text=True,
                                  check=True).stdout.strip())
    assert got == ["() (9216,)", "(2,) (9216, 4608)"]


def test_prefix_routes_as_the_tpu_launcher():
    """Config 3 at 1080p (4 tori): the whole batch routes to K2, every
    smaller bucket to K3 (n_batch <= 2^20), as the JAX package's prefixes
    do; config 7's torus (K = 1) takes K3 on every bucket."""
    sizes = wf.bucket_sizes(1920 * 1080)
    routes = [use_small_kernel(round_up(s, RAY_TILE), 4) for s in sizes]
    assert routes == [False, True, True, True]
    assert all(use_small_kernel(round_up(s, RAY_TILE), 1) for s in sizes)


def _np_pack(active, span_orig):
    """NumPy restatement of one bounce's permutation in the JAX package:
    live spans first, stable (wavefront.py:218-231)."""
    live = active.reshape(-1, SPAN).any(axis=1)
    perm = np.argsort(~live, kind="stable")
    return perm, span_orig[perm]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_permutation_matches_numpy(seed):
    """(d) Over four rounds on random masks (whole dead spans and sparse
    live rays): the port's order equals NumPy's stable argsort; packing
    only the live prefix (the suffix dead) equals the JAX package's
    permutation of every span; scattering each slot back to its span's
    lanes restores every lane, as the inverse of the composed order does
    (wavefront.py:251-256)."""
    rng = np.random.default_rng(seed)
    n_spans = 48
    n = n_spans * SPAN
    lane = np.arange(n)                     # each slot's original lane
    span_orig_np = np.arange(n_spans)
    span_orig = torch.arange(n_spans)
    state = torch.arange(n)
    prefix = n_spans
    active = rng.random(n) < 0.9
    for _ in range(4):
        # kill whole spans and single rays, in the current layout
        active &= np.repeat(rng.random(n_spans) < 0.7, SPAN)
        active &= rng.random(n) < 0.8
        perm, span_orig_np = _np_pack(active, span_orig_np)
        lane = lane.reshape(n_spans, SPAN)[perm].reshape(n)
        act = torch.from_numpy(active[:prefix * SPAN])
        assert not active[prefix * SPAN:].any()
        order = wf.span_order(wf.live_spans(act))
        # the prefix's order, the dead suffix left in place, is the
        # permutation of every span
        whole = torch.cat([order, torch.arange(prefix, n_spans)])
        np.testing.assert_array_equal(whole.numpy(), perm)
        idx = wf.span_lanes(order)
        state[:prefix * SPAN] = state[:prefix * SPAN][idx]
        span_orig[:prefix] = span_orig[order]
        active = active.reshape(n_spans, SPAN)[perm].reshape(n)
        np.testing.assert_array_equal(state.numpy(), lane)
        np.testing.assert_array_equal(span_orig.numpy(), span_orig_np)
        prefix = max(int(wf.live_spans(torch.from_numpy(active)).sum()), 1)
    # the port scatters each slot back to its span's lanes
    back = torch.empty_like(state).index_copy_(0, wf.span_lanes(span_orig),
                                               state)
    np.testing.assert_array_equal(back.numpy(), np.arange(n))
    inv = np.argsort(span_orig_np)
    np.testing.assert_array_equal(
        lane.reshape(n_spans, SPAN)[inv].reshape(n), np.arange(n))
