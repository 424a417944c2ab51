"""S2 on a closest-hit query's parts (`ops.shade_kernel.shade_hit` with
`closest_hit(..., merge=False)`), `ops.trace_kernel.merge_parts` and the
kernel backend's any-hit mask (`ops.trace_kernel.occluded_kernel`), through
the wrappers on CPU tensors (the plain twins), against the JAX package.

Four scene shapes at 64x32 pinhole rays (2,048, one TPU ray tile), every
7th lane dead (tmax 0): the loose hoist with the triangle kernel (S1 +
K1, config 6's shape), the hoist with the small torus kernel (S1 + K3,
config 3's), the triangle kernel with K3 on a textured mesh and no loose
rows (config 7's), and tori only (K3 alone).

(a) `merge_parts` on the JAX package's own parts (its `_loose_tri_hit`,
    `tri_closest_hit_pallas` and `torus_closest_hit_pallas` in interpret
    mode, chained as `closest_hit_pallas` chains them) equals
    `closest_hit_pallas`'s merged hit bit for bit, closest and any-hit.
(b) S2's twin on the port's parts -> K4 -> any-hit -> S3 against the JAX
    package's `shade` on `closest_hit_pallas`'s hit: colors within 1e-4
    of their size plus 1e-4, attenuation within 1e-6, first hits and next
    rays within 1e-4 (the two packages' kernels part in t by up to 1e-5
    relative, tests/test_torch_trace_kernel.py, and Phong's power grows
    that: 5.6e-5 seen on a torus), the active mask and the ray count
    equal.
(c) The parts route and the merged-base route (`base_rows` of
    `merge_parts`' hit, what a primitive-sharded query feeds S2): S2's
    outputs equal on the lanes where the contract defines them, and S3
    fed by each, with every undefined entry poisoned (NaN floats, -7
    ints), gives the same state, active mask, ray count, spans and count
    on every lane, bit for bit, as S3 fed by the unpoisoned twin.
(d) The any-hit mask formed from the parts equals the JAX package's
    `any_hit` (pallas) on the segment's shadow rays, and equals the merged
    route's `kind >= 0` bit for bit on every lane, dead lanes and lanes
    whose undefined shadow rays hold NaN or 1e30 included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import generate_rays as jax_rays
from toroidal_ray_tracing_tpu.ops import trace_kernel as jtk
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jp
from toroidal_ray_tracing_tpu.scene.types import SceneDef, Torus
from toroidal_ray_tracing_tpu.trace import intersect as jax_isect
from toroidal_ray_tracing_tpu.trace.shade import shade as jax_shade
from toroidal_ray_tracing_tpu.utils import math3d
from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import BIG
from toroidal_ray_tracing_tpu_torch.ops.tex_kernel import quad_gather
from toroidal_ray_tracing_tpu_torch.scene import (scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace.intersect import (AttrRows, any_hit,
                                                            closest_hit,
                                                            geom_from_scene)

torch.set_num_threads(2)

_O, _D, _HV, _AT, _HP = (slice(0, 3), slice(3, 6), slice(6, 9),
                         slice(9, 12), slice(12, 15))
W, H = 64, 32
SHAPES = ["s1_k1", "s1_k3", "k1_k3_tex", "tori"]


def _scene_def(shape):
    s = SceneDef()
    if shape == "s1_k3":                       # config 3: tori + mirror plane
        return jp.scene_multi_torus(analytic=True)
    if shape == "s1_k1":                       # a mesh over a loose floor
        s.add_model(jp.torus_mesh(1.2, 0.4, seg_major=24, seg_minor=12,
                                  material=jp.matte((0.8, 0.5, 0.3), illum=2,
                                                    shininess=24.0)),
                    math3d.translation((-1.6, 0.5, 0.6)))
        s.add_model(jp.cube(0.8, materials=[jp.mirror()]),
                    math3d.translation((-0.2, 0.4, -2.2)))
        s.add_model(jp.plane(12.0, material=jp.matte((0.7, 0.7, 0.7),
                                                     illum=3)))
        return s
    if shape == "k1_k3_tex":                   # config 7: textured mesh + K3
        tor = jp.torus_mesh(2.0, 0.7, seg_major=12, seg_minor=6,
                            material=jp.matte((1.0, 1.0, 1.0), illum=1,
                                              specular=(0.0, 0.0, 0.0),
                                              texture_id=0))
        tor.textures = [jp.checker_texture(32, 8)]
        s.add_model(tor, math3d.translation((-1.2, 0.5, 0.6)))
        s.add_model(Torus(1.5, 0.5, [jp.mirror()]),
                    math3d.translation((1.8, 0.4, -1.2)))
        return s
    s.add_model(Torus(1.7, 0.6, [jp.matte((0.9, 0.4, 0.2), illum=1)]),
                math3d.translation((-1.6, 0.4, 0.7)))
    s.add_model(Torus(1.4, 0.5, [jp.matte((0.3, 0.6, 0.9), illum=2,
                                          shininess=32.0)]),
                math3d.compose(math3d.translation((1.2, 0.5, 1.5)),
                               math3d.rotation_x(90.0)))
    s.add_model(Torus(1.5, 0.5, [jp.mirror()]),
                math3d.translation((1.6, 0.3, -1.8)))
    return s


_BUILT: dict = {}


def _scene(shape):
    """(JAX scene, port scene), built once; the shape's kernels checked."""
    if shape not in _BUILT:
        jscene = jax_build(_scene_def(shape))
        scene = scene_from_numpy(jscene)
        loose = {"s1_k1": 4, "s1_k3": 2, "k1_k3_tex": 0, "tori": 0}[shape]
        assert scene.loose_tris == loose, (shape, scene.loose_tris)
        _BUILT[shape] = (jscene, scene)
    return _BUILT[shape]


def _rays():
    """(3, N) float32 origins and directions, (N,) tmax with every 7th lane
    dead, from the JAX package's NumPy raygen."""
    cam = JaxPinhole(eye=(3.5, 2.5, 3.5), center=(0.0, 0.4, 0.0))
    o, d = jax_rays(cam, W, H, JaxSettings.default(), xp=np)
    tmax = np.full((W * H,), 1e4, np.float32)
    tmax[::7] = 0.0
    return (np.ascontiguousarray(o.T, np.float32),
            np.ascontiguousarray(d.T, np.float32), tmax)


def _settings():
    return JaxSettings.default(max_depth=3, pixel_spread=0.004)


def _t(x):
    return torch.from_numpy(np.array(x))


def _parts(scene, o, d, tmax):
    """The port's closest-hit query, unmerged (merge=False)."""
    hit = closest_hit(scene, _t(o), _t(d), tmax=_t(tmax), backend="kernel",
                      want_attrs=True, merge=False)
    assert hit.t is None
    return hit.attrs


def _jax_parts(jscene, o, d, tmax, occlusion):
    """The JAX package's query part by part, each kernel on the tmax
    `closest_hit_pallas` gives it: the parts as an `AttrRows`."""
    geom = jax_isect.geom_from_scene(jscene)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)
    has_tris = bool(np.any(np.asarray(jscene.triangles.valid)))
    has_tori = bool(np.any(np.asarray(jscene.tori.valid)))
    rows = AttrRows()
    t_best = jnp.full(jt.shape, BIG, jnp.float32)
    tri_tmax = jt
    if has_tris:
        T = geom.woop_o.shape[2]
        cs = jscene.cluster_size
        n_cl = geom.cluster_lo.shape[0]
        assert n_cl * cs == T
        clo, chi = geom.cluster_lo, geom.cluster_hi
        L = jscene.loose_tris
        n_tail = (L + cs - 1) // cs if L > 0 else 0
        if n_tail:
            base = T - n_tail * cs
            lt, lidx, lu, lv = jtk._loose_tri_hit(jo, jd, jt, geom.woop_o,
                                                  geom.woop_d, base, L)
            lhit = lt < BIG
            t_best = jnp.where(lhit, lt, t_best)
            rows.base = tuple(_t(a) for a in (
                t_best, jnp.where(lhit, 0, -1).astype(jnp.int32),
                jnp.where(lhit, base + lidx, 0).astype(jnp.int32),
                jnp.where(lhit, lu, 0.0), jnp.where(lhit, lv, 0.0)))
            far = jnp.full((n_tail, 3), jnp.float32(2.0e38))
            clo = jnp.concatenate([clo[:n_cl - n_tail], far], axis=0)
            chi = jnp.concatenate([chi[:n_cl - n_tail], far], axis=0)
            tri_tmax = (jnp.where(lhit, jnp.float32(0.0), jt) if occlusion
                        else jnp.minimum(jt, lt))
        if n_tail != n_cl:
            tt, ti, tu, tv = jtk.tri_closest_hit_pallas(
                jo, jd, tri_tmax, geom.woop_o, geom.woop_d, clo, chi, cs,
                occlusion=occlusion)[:4]
            rows.tri_hit = tuple(_t(a) for a in (tt, ti, tu, tv))
            t_best = jnp.where(tt < t_best, tt, t_best)
    if has_tori:
        if has_tris and occlusion:
            tor_tmax = jnp.where(t_best < BIG, jnp.float32(0.0), jt)
        elif has_tris:
            tor_tmax = jnp.minimum(jt, t_best)
        else:
            tor_tmax = jt
        kt, ki = jtk.torus_closest_hit_pallas(
            jo, jd, tor_tmax, geom.tor_w2o, geom.tor_major, geom.tor_minor,
            geom.tor_center, geom.tor_bound, occlusion=occlusion)[:2]
        rows.tor_hit = (_t(kt), _t(ki))
    return rows


# ---------------------------------------------------------------------------
# (a) merge_parts against the JAX package's merged hit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_merge_parts_equals_jax_merge(shape, occlusion):
    jscene, _ = _scene(shape)
    o, d, tmax = _rays()
    rows = _jax_parts(jscene, o, d, tmax, occlusion)
    want_parts = {"s1_k1": "bt-", "s1_k3": "b-q", "k1_k3_tex": "-tq",
                  "tori": "--q"}[shape]
    assert want_parts == "".join(
        c if p is not None else "-" for c, p in
        zip("btq", (rows.base, rows.tri_hit, rows.tor_hit)))
    got = tk.merge_parts(rows, W * H, torch.device("cpu"))
    ref = jtk.closest_hit_pallas(jscene, jax_isect.geom_from_scene(jscene),
                                 jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmax), occlusion=occlusion)
    for k in ("t", "kind", "prim", "u", "v"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    hit = got.kind.numpy() >= 0
    assert hit.sum() > 300 and (~hit).sum() > 200, int(hit.sum())
    assert not hit[::7].any()                     # dead lanes miss


def test_merge_parts_of_no_part_is_the_miss():
    hit = tk.merge_parts(AttrRows(), 5, torch.device("cpu"))
    assert (hit.t == BIG).all() and (hit.kind == -1).all()
    assert (hit.prim == 0).all() and (hit.u == 0).all() and (hit.v == 0).all()
    assert hit.attrs.base is None and hit.attrs.tri_kind is None


# ---------------------------------------------------------------------------
# (b) S2's twin on parts -> S3 against the JAX package's shade
# ---------------------------------------------------------------------------


def _segment(scene, st, o, d, tmax, rows, poison=False):
    """S2 on `rows`, K4, the any-hit, S3 at depth 0 from a fresh state:
    (S2's outputs, state, active, rays, spans, count). poison: every
    entry S2's contract leaves undefined NaN (floats) or -7 (ints) before
    the readers run."""
    n = o.shape[1]
    params = sk.shade_params(scene, st)
    oo, dd = _t(o), _t(d)
    sr = sk.shade_hit(oo, dd, rows, params)
    if poison:
        sr = _poisoned(sr, params.atlas is not None)
    quads = (quad_gather(scene.textures.data4q, *sr.tex)
             if sr.tex is not None else None)
    occ = any_hit(scene, sr.shadow_o, sr.shadow_d, sr.shadow_tmax,
                  backend="kernel")
    state = torch.empty((15, n))
    state[_O], state[_D] = oo, dd
    state[_HV], state[_AT], state[_HP] = 0.0, 1.0, 0.0
    active = _t(tmax > 0)
    rays = torch.zeros((), dtype=torch.int64)
    spans = torch.zeros((-(-n // 128),), dtype=torch.bool)
    count = torch.zeros((), dtype=torch.int32)
    sk.shade_finish(state, active, n, sr, occ, quads, params, 0, 3, rays,
                    spans, count)
    return sr, state, active, rays, spans, count


def _poisoned(sr, textured):
    """A copy of S2's outputs with every undefined entry poisoned."""
    out = dataclasses.replace(
        sr, shadow_o=sr.shadow_o.clone(), shadow_d=sr.shadow_d.clone(),
        block=sr.block.clone(),
        tex=tuple(x.clone() for x in sr.tex) if sr.tex else None)
    for _, x, lanes in sk.defined_entries(out, textured):
        x[..., ~lanes] = float("nan") if x.is_floating_point() else -7
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_s2_on_parts_matches_jax_shade(shape):
    jscene, scene = _scene(shape)
    jst = _settings()
    o, d, tmax = _rays()
    act = tmax > 0
    _, state, active, rays, _, _ = _segment(
        scene, settings_from_numpy(jst), o, d, tmax, _parts(scene, o, d,
                                                             tmax))
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jhit = jtk.closest_hit_pallas(jscene, jax_isect.geom_from_scene(jscene),
                                  jo, jd, jnp.asarray(tmax), want_attrs=True)
    ref = jax_shade(jscene, jst, jo, jd, jhit, backend="pallas")
    r = {k: np.asarray(v) for k, v in ref._asdict().items()}
    live = act[None, :]
    s = state.numpy()
    hv = np.where(live, r["hit_value"] * r["atten_factor"], 0.0)
    np.testing.assert_allclose(s[_HV], hv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s[_AT], np.where(live, r["atten_factor"],
                                                1.0), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s[_HP], np.where(live, r["hit_position"],
                                                0.0), rtol=1e-4, atol=1e-4)
    more = act & ~r["done"]
    np.testing.assert_array_equal(active.numpy(), more)
    np.testing.assert_allclose(s[_O][:, more], r["next_origin"][:, more],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s[_D][:, more], r["next_dir"][:, more],
                               rtol=1e-4, atol=1e-4)
    assert int(rays) == int(act.sum() + (act & r["shadow_rays"]).sum())
    hit = np.asarray(jhit.kind) >= 0
    assert (act & ~hit).sum() > 100 and (act & hit).sum() > 300
    if shape != "k1_k3_tex":
        assert more.any()                         # a mirror bounce


# ---------------------------------------------------------------------------
# (c) the parts route against the merged-base route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_parts_route_equals_merged_base_route(shape):
    _, scene = _scene(shape)
    st = settings_from_numpy(_settings())
    o, d, tmax = _rays()
    rows = _parts(scene, o, d, tmax)
    merged = sk.base_rows(tk.merge_parts(rows, W * H, torch.device("cpu")))
    assert merged.tri_hit is None and merged.tor_hit is None
    textured = scene.textures.data4q.shape[0] > 1
    assert textured == (shape == "k1_k3_tex")
    runs = [_segment(scene, st, o, d, tmax, r, poison=p)
            for r, p in ((rows, False), (merged, False), (rows, True),
                         (merged, True))]
    ref = runs[0]
    other = {k: v for k, v, _ in sk.defined_entries(runs[1][0], textured)}
    for name, x, lanes in sk.defined_entries(ref[0], textured):
        assert torch.equal(x[..., lanes], other[name][..., lanes]), name
    for run in runs[1:]:
        for a, b in zip(ref[1:], run[1:]):
            assert torch.equal(a, b)
    flags = ref[0].flags
    missed = (flags & sk.MISSED) > 0
    assert missed.any() and (~missed).any()
    assert (flags[missed] == sk.MISSED).all()     # a miss: MISSED alone
    assert (ref[0].shadow_tmax[missed] == 0).all()


# ---------------------------------------------------------------------------
# (d) the any-hit mask from the parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_any_hit_from_parts(shape):
    jscene, scene = _scene(shape)
    st = settings_from_numpy(_settings())
    o, d, tmax = _rays()
    sr = sk.shade_hit(_t(o), _t(d), _parts(scene, o, d, tmax),
                      sk.shade_params(scene, st))
    so, sd_, stm = sr.shadow_o, sr.shadow_d, sr.shadow_tmax
    got = any_hit(scene, so, sd_, stm, backend="kernel")
    ref = np.asarray(jax_isect.any_hit(jscene, jnp.asarray(so.numpy()),
                                       jnp.asarray(sd_.numpy()),
                                       jnp.asarray(stm.numpy()),
                                       backend="pallas"))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the merged route's kind >= 0, with the undefined lanes' rays poisoned
    off = stm == 0
    assert off.sum() > 100 and (~off).sum() > 100
    po, pd = so.clone(), sd_.clone()
    bad = off & (torch.arange(W * H) % 2 == 0)
    po[:, bad], pd[:, bad] = float("nan"), float("nan")
    po[:, off & ~bad], pd[:, off & ~bad] = 1e30, -1e30
    geom = geom_from_scene(scene)
    for oo, dd in ((so, sd_), (po, pd)):
        mask = tk.occluded_kernel(scene, geom, oo, dd, stm)
        old = tk.closest_hit_kernel(scene, geom, oo, dd, stm,
                                    occlusion=True).kind >= 0
        assert torch.equal(mask, old)
        assert not mask[off].any()
    assert got.any() and (~got[~off]).any()
