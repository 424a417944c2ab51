"""The kernel backend's segment kernels S1 (`ops.loose_kernel.loose_hit`),
S2 (`ops.shade_kernel.shade_hit`) and S3 (`shade_finish`), through their
wrappers on CPU tensors (the plain twins), against the JAX package and the
port's own torch shading.

(a) S1 against the JAX `_loose_tri_hit` (and its merge): config 3's mirror
    plane (L = 2) and a synthetic 16-row tail with duplicated rows (ties
    only the row decides), rays parallel to the plane and dead lanes, both
    modes. The port tests the rows in K1's order of operations and the JAX
    package as an einsum, so t agrees within rtol 1e-5 (atol 1e-4 where t
    is near 0), u and v within 1e-5; the hit mask and the winning row are
    equal, ties exactly. Its tables against `_loose_attr` on the same
    winners: the 21 rows within 1e-6 (the same products and sums).
(b) S2 -> K4 -> any-hit -> S3 against `trace.shade.shade` and the bounce
    loop's torch update on the same hit: colors, attenuation, first hits,
    next rays, the active mask, the ray count and the live spans bit for
    bit (max |diff| 0), over misses, dead lanes, illum 0-3, point and
    infinite lights, textured hits, pinhole and toroidal 360-degree rays,
    two segments.
(c) the same segment against the JAX package's `shade` on its pallas path
    (interpret mode) from the JAX kernels' hit: colors within 1e-6 plus
    1e-5 of their size (the infinite light's direction, normalized by XLA
    and by torch, may part by an ulp, and Phong's power, up to 64, grows
    that: 4.7e-6 relative seen), positions and directions within 1e-6
    (relative and absolute), masks and the ray count equal.
(d) whole `trace_rays(backend="kernel")` against the JAX package's
    compacted `trace_rays(backend="pallas")` on a small textured scene and
    the capture: image max |diff| < 5e-4 (tests/test_golden.py's bound)
    over the pixels within 1e-3, at most 4 pixels over 1e-3 where a
    mirror path takes the other triangle of a shared edge
    (tests/test_pallas.py's rule; the capture at 64x64 has 3, as before
    the segment kernels), rays_traced exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import ToroidalCamera as JaxToroidal
from toroidal_ray_tracing_tpu.cameras import generate_rays as jax_rays
from toroidal_ray_tracing_tpu.ops import trace_kernel as jtk
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jp
from toroidal_ray_tracing_tpu.scene.types import SceneDef, Torus
from toroidal_ray_tracing_tpu.trace import intersect as jax_isect
from toroidal_ray_tracing_tpu.trace.shade import shade as jax_shade
from toroidal_ray_tracing_tpu.trace.wavefront import (
    trace_rays as jax_trace_rays)
from toroidal_ray_tracing_tpu.utils import math3d
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import (pick_block,
                                                            pixel_coords)
from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import BIG
from toroidal_ray_tracing_tpu_torch.ops.loose_kernel import (loose_hit,
                                                             loose_hit_plain)
from toroidal_ray_tracing_tpu_torch.ops.tex_kernel import quad_gather
from toroidal_ray_tracing_tpu_torch.scene import (LIGHT_INFINITE,
                                                  scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf
from toroidal_ray_tracing_tpu_torch.trace.intersect import (AttrRows, Hit,
                                                            any_hit,
                                                            closest_hit)
from toroidal_ray_tracing_tpu_torch.trace.shade import shade

torch.set_num_threads(2)

_O, _D, _HV, _AT, _HP = (slice(0, 3), slice(3, 6), slice(6, 9),
                         slice(9, 12), slice(12, 15))


def _all_illums():
    """A small scene with every illum (0-3), tori and triangles, a
    textured mesh and a textured loose floor (L = 2)."""
    s = SceneDef()
    tor = jp.torus_mesh(1.2, 0.4, seg_major=12, seg_minor=6,
                        material=jp.matte((1.0, 1.0, 1.0), illum=1,
                                          specular=(0.0, 0.0, 0.0),
                                          texture_id=0))
    tor.textures = [jp.checker_texture(32, 8)]
    s.add_model(tor, math3d.translation((-1.6, 0.5, 0.6)))
    s.add_model(Torus(0.9, 0.3, [jp.mirror()]),
                math3d.translation((1.8, 0.4, -0.8)))
    s.add_model(Torus(0.7, 0.25, [jp.matte((0.3, 0.6, 0.9), illum=2,
                                           shininess=24.0)]),
                math3d.compose(math3d.translation((0.4, 0.35, 2.0)),
                               math3d.rotation_x(90.0)))
    s.add_model(jp.cube(0.8, materials=[jp.matte((0.9, 0.8, 0.2),
                                                 illum=0)]),
                math3d.translation((-0.2, 0.4, -2.2)))
    floor = jp.plane(12.0, material=jp.matte((1.0, 1.0, 1.0), illum=1,
                                             specular=(0.0, 0.0, 0.0),
                                             texture_id=0))
    floor.uvs = floor.uvs * 6.0
    floor.textures = [jp.checker_texture(16, 4, (0.45, 0.42, 0.4),
                                         (0.75, 0.73, 0.7))]
    s.add_model(floor)
    return s


_BUILT: dict = {}


def _scene(name):
    """(JAX scene, port scene), built once."""
    if name not in _BUILT:
        make = {"all_illums": _all_illums,
                "config3": lambda: jp.scene_multi_torus(analytic=True),
                "cornellish": jp.scene_cornellish}[name]
        jscene = jax_build(make())
        _BUILT[name] = (jscene, scene_from_numpy(jscene))
    return _BUILT[name]


def _rays(kind, w, h, settings, block=False):
    """(N, 3) float32 origins and directions from the JAX package's NumPy
    raygen: a pinhole view or the toroidal ring (360-degree rays)."""
    cam = (JaxPinhole(eye=(6.0, 4.0, 6.0), center=(0.0, 0.4, 0.0))
           if kind == "pin" else
           JaxToroidal(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)))
    o, d = jax_rays(cam, w, h, settings, xp=np)
    if block:
        px, py = pixel_coords(w, h, pick_block(w, h))
        order = (py.long() * w + px.long()).numpy()
        o, d = o[order], d[order]
    return (np.ascontiguousarray(o, np.float32),
            np.ascontiguousarray(d, np.float32))


def _settings(light):
    kw = dict(max_depth=3, pixel_spread=0.004)
    if light == "infinite":
        kw.update(light_type=LIGHT_INFINITE, light_position=(0.3, 1.0, 0.4))
    return JaxSettings.default(**kw)


# ---------------------------------------------------------------------------
# (a) S1
# ---------------------------------------------------------------------------


def _loose_cases():
    """(name, woop_o, woop_d, base, L, JAX attr tables) of config 3's
    mirror plane and of a synthetic 16-row tail: the 8 cornellish rows the
    test rays hit most, each twice, so each tie between twins is decided
    by the row alone."""
    jscene, _ = _scene("config3")
    T = jscene.triangles.woop_o.shape[2]
    L = int(jscene.loose_tris)
    cs = int(jscene.cluster_size)
    base = T - ((L + cs - 1) // cs) * cs
    geom = jax_isect.geom_from_scene(jscene)
    yield ("config3_plane",
           np.ascontiguousarray(jscene.triangles.woop_o, np.float32),
           np.ascontiguousarray(jscene.triangles.woop_d, np.float32), base, L,
           tuple(np.asarray(a) for a in jtk._tri_attr_tables(jscene, geom)))
    cscene, port = _scene("cornellish")
    o, d, _ = _loose_rays("synthetic16")
    hit = closest_hit(port, torch.from_numpy(o), torch.from_numpy(d),
                      backend="torch")
    prims = hit.prim[hit.kind == 0].numpy()
    pick = np.argsort(-np.bincount(prims), kind="stable")[:8]
    cols = np.repeat(pick, 2)
    cg = jax_isect.geom_from_scene(cscene)
    tabs = tuple(np.asarray(a)[:, cols]
                 for a in jtk._tri_attr_tables(cscene, cg))
    yield ("synthetic16",
           np.ascontiguousarray(np.asarray(cscene.triangles.woop_o)[:, :,
                                                                    cols]),
           np.ascontiguousarray(np.asarray(cscene.triangles.woop_d)[:, :,
                                                                    cols]),
           0, 16, tabs)


def _loose_rays(name):
    """Pinhole rays toward the tail (every 7th dead), plus rays parallel
    to the floor plane."""
    o, d = _rays("pin", 32, 32, JaxSettings.default())
    par = np.zeros((64, 3), np.float32)
    par[:, 0] = np.cos(np.linspace(0, 2 * np.pi, 64))
    par[:, 2] = np.sin(np.linspace(0, 2 * np.pi, 64))
    o = np.concatenate([o, np.tile(np.float32([[0.0, 0.0, 0.0]]), (64, 1)),
                        np.tile(np.float32([[0.0, 0.5, 0.0]]), (64, 1))])
    d = np.concatenate([d, par, par]).astype(np.float32)
    tmax = np.full((o.shape[0],), 1e4, np.float32)
    tmax[::7] = 0.0
    return o.T.copy(), d.T.copy(), tmax


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("case", ["config3_plane", "synthetic16"])
def test_loose_hit_matches_jax(case, occlusion):
    name, wo, wd, base, L, tabs = next(c for c in _loose_cases()
                                       if c[0] == case)
    o, d, tmax = _loose_rays(name)
    jt, jidx, ju, jv = (np.asarray(a) for a in jtk._loose_tri_hit(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(wo),
        jnp.asarray(wd), base, L))
    to = [torch.from_numpy(a) for a in (o, d, tmax, wo, wd)]
    got = loose_hit(*to, base, L, base + 5, occlusion)
    assert all(torch.equal(a, b) for a, b in zip(
        got, loose_hit_plain(*to, base, L, base + 5, occlusion)))
    t, kind, prim, u, v, tri_tmax = (a.numpy() for a in got)
    jhit = jt < BIG
    np.testing.assert_array_equal(kind >= 0, jhit)
    assert jhit.sum() > 50 and (~jhit).sum() > 50, int(jhit.sum())
    if name == "config3_plane":                   # parallel rays miss
        assert not jhit[o.shape[1] - 128:].any()
    assert not jhit[::7].any()                    # dead lanes miss
    np.testing.assert_array_equal(prim[jhit], base + 5 + jidx[jhit])
    assert (prim[~jhit] == 0).all() and (kind[~jhit] == -1).all()
    np.testing.assert_allclose(t[jhit], jt[jhit], rtol=1e-5, atol=1e-4)
    assert (t[~jhit] == BIG).all()
    np.testing.assert_allclose(u, np.where(jhit, ju, 0.0), atol=1e-5)
    np.testing.assert_allclose(v, np.where(jhit, jv, 0.0), atol=1e-5)
    want = (np.where(jhit, 0.0, tmax) if occlusion
            else np.minimum(tmax, jt))
    np.testing.assert_allclose(tri_tmax, want, rtol=1e-5, atol=1e-4)
    if name == "synthetic16":
        # twin rows: a winner is always the first of its pair
        assert (jidx[jhit] % 2 == 0).all()
        assert ((prim[jhit] - base - 5) % 2 == 0).all()


@pytest.mark.parametrize("case", ["config3_plane", "synthetic16"])
def test_loose_attr_rows_match_jax(case):
    """S2's interpolation of the loose winners' rows (`shade_attrs`)
    against the JAX `_loose_attr` on the JAX winners."""
    name, wo, wd, base, L, tabs = next(c for c in _loose_cases()
                                       if c[0] == case)
    o, d, tmax = _loose_rays(name)
    jt, jidx, ju, jv = jtk._loose_tri_hit(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(wo),
        jnp.asarray(wd), base, L)
    jhit = jt < BIG
    ref = np.asarray(jtk._loose_attr(tuple(jnp.asarray(a) for a in tabs),
                                     base, L, jidx, ju, jv, jhit))
    hit = np.asarray(jhit)
    kind = torch.from_numpy(np.where(hit, 0, -1).astype(np.int32))
    prim = torch.from_numpy((base + np.asarray(jidx)).astype(np.int32))
    loose = tuple(torch.from_numpy(a.copy()) for a in tabs)
    h = Hit(t=torch.from_numpy(np.array(jt)), kind=kind, prim=prim,
            u=torch.from_numpy(np.array(ju)),
            v=torch.from_numpy(np.array(jv)))
    a = sk.shade_attrs(h, AttrRows(loose=loose, loose_base=base, n_loose=L,
                                   tri_kind=kind, tri_prim=prim))
    got = torch.cat([a.pos, a.nrm, a.uv, a.ambient, a.diffuse, a.specular,
                     a.shininess[None], a.illum[None].float(),
                     a.texture_id[None].float(),
                     a.tex_density[None]]).numpy()
    np.testing.assert_allclose(got[:, hit], ref[:, hit], rtol=1e-6,
                               atol=1e-6)
    assert (got[:, ~hit] == 0).all()


def test_loose_hit_refuses_rows_it_cannot_take():
    o = torch.zeros((3, 4))
    wo, wd = torch.zeros((3, 4, 40)), torch.zeros((3, 3, 40))
    for base, L in ((0, 17), (0, 0), (30, 16)):
        with pytest.raises(ValueError):
            loose_hit(o, o, torch.zeros(4), wo, wd, base, L, 0)


# ---------------------------------------------------------------------------
# (b) S2 -> K4 -> any-hit -> S3 against shade() and the torch update
# ---------------------------------------------------------------------------


def _old_update(state, active, nb, sh, depth, max_depth, rays):
    """The bounce loop's torch update as `trace_rays` runs it on the torch
    backend (trace/wavefront.py)."""
    s = state[:, :nb]
    act = active[:nb]
    o, d, att, hv = s[_O], s[_D], s[_AT], s[_HV]
    live = act[None, :]
    torch.where(live, att * sh.atten_factor, att, out=att)
    torch.where(live, hv + sh.hit_value * att, hv, out=hv)
    if depth == 0:
        torch.where(live, sh.hit_position, s[_HP], out=s[_HP])
    rays += act.sum() + (act & sh.shadow_rays).sum()
    act = act & ~sh.done & (depth + 1 < max_depth)
    active[:nb] = act
    torch.where(act[None, :], sh.next_origin, o, out=o)
    torch.where(act[None, :], sh.next_dir, d, out=d)


def _start(o, d, seed):
    """The (15, n) state of a batch and an active mask with dead lanes."""
    n = o.shape[0]
    state = torch.empty((15, n))
    state[_O], state[_D] = torch.from_numpy(o.T), torch.from_numpy(d.T)
    state[_HV], state[_AT], state[_HP] = 0.0, 1.0, 0.0
    active = torch.from_numpy(np.random.default_rng(seed).random(n) > 0.1)
    return state, active


@pytest.mark.parametrize("light", ["point", "infinite"])
@pytest.mark.parametrize("cam", ["pin", "toroidal"])
def test_segment_twins_equal_shade(cam, light):
    jscene, scene = _scene("all_illums")
    st = settings_from_numpy(_settings(light))
    o, d = _rays(cam, 32, 32 if cam == "pin" else 16, _settings(light))
    state, active = _start(o, d, 0)
    ref_state, ref_active = state.clone(), active.clone()
    n = o.shape[0]
    params = sk.shade_params(scene, st)
    rays = torch.zeros((), dtype=torch.int64)
    ref_rays = torch.zeros((), dtype=torch.int64)
    spans = torch.empty((-(-n // 128),), dtype=torch.bool)
    seen = dict(miss=0, dead=0, tex=0, tor=0, illum=set())
    for depth in range(2):
        oo, dd = state[_O].contiguous(), state[_D].contiguous()
        tmax = torch.where(active, 1e4, 0.0)
        hit = closest_hit(scene, oo, dd, tmax=tmax, backend="kernel",
                          want_attrs=True)
        # the reference: shade() on the same hit with assembled attrs
        sa = Hit(hit.t, hit.kind, hit.prim, hit.u, hit.v,
                 attrs=sk.shade_attrs(hit, hit.attrs))
        sh = shade(scene, st, oo, dd, sa, backend="kernel")
        _old_update(ref_state, ref_active, n, sh, depth, 3, ref_rays)
        # the twins through the wrappers, S2 on the query's parts
        parts = closest_hit(scene, oo, dd, tmax=tmax, backend="kernel",
                            want_attrs=True, merge=False)
        sr = sk.shade_hit(oo, dd, parts.attrs, params)
        quads = quad_gather(scene.textures.data4q, *sr.tex)
        occ = any_hit(scene, sr.shadow_o, sr.shadow_d, sr.shadow_tmax,
                      backend="kernel")
        count = torch.zeros((), dtype=torch.int32)
        live_before = active.clone()
        sk.shade_finish(state, active, n, sr, occ, quads, params, depth, 3,
                        rays, spans, count)
        assert torch.equal(state, ref_state), (depth, float(
            (state - ref_state).abs().max()))
        assert torch.equal(active, ref_active) and int(rays) == int(ref_rays)
        want = torch.nn.functional.pad(active, (0, (-n) % 128)).view(
            -1, 128).any(dim=1)
        assert torch.equal(spans[:want.shape[0]], want)
        assert int(count) == int(want.sum())
        seen["miss"] += int(((hit.kind < 0) & live_before).sum())
        seen["dead"] += int((~live_before).sum())
        seen["tor"] += int((hit.kind == 1).sum())
        seen["tex"] += int(sr.tex[2].sum())
        seen["illum"] |= set(sa.attrs.illum[hit.kind >= 0].tolist())
    assert seen["miss"] and seen["dead"] and seen["tor"] and seen["tex"]
    if cam == "pin":
        assert seen["illum"] >= {0, 1, 2, 3}, seen


def test_segment_wrappers_check_their_inputs():
    _, scene = _scene("all_illums")
    st = settings_from_numpy(_settings("point"))
    o, d = _rays("pin", 8, 8, _settings("point"))
    oo, dd = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    hit = closest_hit(scene, oo, dd, backend="kernel", want_attrs=True)
    params = sk.shade_params(scene, st)
    with pytest.raises(ValueError):        # strided rays
        sk.shade_hit(torch.cat([oo, oo], 1)[:, ::2], dd, sk.base_rows(hit),
                     params)
    sr = sk.shade_hit(oo, dd, sk.base_rows(hit), params)
    state, active = _start(o, d, 1)
    occ = torch.zeros((64,), dtype=torch.bool)
    with pytest.raises(ValueError):        # a textured scene needs K4's words
        sk.shade_finish(state, active, 64, sr, occ, None, params, 0, 3,
                        torch.zeros((), dtype=torch.int64),
                        torch.empty((1,), dtype=torch.bool),
                        torch.zeros((), dtype=torch.int32))


# ---------------------------------------------------------------------------
# (c) against the JAX package's shade on its pallas path
# ---------------------------------------------------------------------------


def _rows_of(attrs, n):
    """The JAX kernels' ShadeAttrs as the port's raw rows (21 triangle, 15
    torus): S2 then assembles the same fields back."""
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in attrs._asdict()
         .items()}
    mat = torch.cat([a["ambient"], a["diffuse"], a["specular"],
                     a["shininess"][None], a["illum"][None].float(),
                     a["texture_id"][None].float()])
    return AttrRows(tri=torch.cat([a["pos"], a["nrm"], a["uv"], mat,
                                   a["tex_density"][None]]).contiguous(),
                    tor=torch.cat([a["nrm"], mat]).contiguous())


@pytest.mark.parametrize("light", ["point", "infinite"])
@pytest.mark.parametrize("cam", ["pin", "toroidal"])
def test_segment_twins_match_jax_shade(cam, light):
    jscene, scene = _scene("all_illums")
    jst = _settings(light)
    st = settings_from_numpy(jst)
    o, d = _rays(cam, 32, 32 if cam == "pin" else 16, jst)
    n = o.shape[0]
    state, active = _start(o, d, 2)
    act = active.numpy().copy()
    tmax = np.where(act, 1e4, 0.0).astype(np.float32)
    geom = jax_isect.geom_from_scene(jscene)
    jo, jd = jnp.asarray(o.T), jnp.asarray(d.T)
    jhit = jtk.closest_hit_pallas(jscene, geom, jo, jd, jnp.asarray(tmax),
                                  want_attrs=True)
    ref = jax_shade(jscene, jst, jo, jd, jhit, backend="pallas")
    hit = Hit(*(torch.from_numpy(np.array(getattr(jhit, k)))
                for k in ("t", "kind", "prim", "u", "v")),
              attrs=_rows_of(jhit.attrs, n))
    params = sk.shade_params(scene, st)
    oo, dd = state[_O].contiguous(), state[_D].contiguous()
    sr = sk.shade_hit(oo, dd, sk.base_rows(hit), params)
    quads = quad_gather(scene.textures.data4q, *sr.tex)
    occ = any_hit(scene, sr.shadow_o, sr.shadow_d, sr.shadow_tmax,
                  backend="kernel")
    rays = torch.zeros((), dtype=torch.int64)
    sk.shade_finish(state, active, n, sr, occ, quads, params, 0, 3, rays,
                    torch.empty((-(-n // 128),), dtype=torch.bool),
                    torch.zeros((), dtype=torch.int32))
    r = {k: np.asarray(v) for k, v in ref._asdict().items()}
    live = act[None, :]
    s = state.numpy()
    np.testing.assert_allclose(
        s[_HV], np.where(live, r["hit_value"] * r["atten_factor"], 0.0),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s[_AT], np.where(live, r["atten_factor"],
                                                1.0), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s[_HP], np.where(live, r["hit_position"],
                                                0.0), rtol=1e-6, atol=1e-6)
    more = act & ~r["done"]
    np.testing.assert_array_equal(active.numpy(), more)
    assert more.any() and (act & r["done"]).any()
    np.testing.assert_allclose(s[_O][:, more], r["next_origin"][:, more],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s[_D][:, more], r["next_dir"][:, more],
                               rtol=1e-6, atol=1e-6)
    assert int(rays) == int(act.sum() + (act & r["shadow_rays"]).sum())


# ---------------------------------------------------------------------------
# (d) whole frames against the JAX package's compacted pallas path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["textured", "capture"])
def test_trace_rays_matches_jax_pallas(case):
    if case == "textured":
        jscene, scene = _scene("all_illums")
        jst = _settings("point")
        o, d = _rays("pin", 64, 64, jst, block=True)
    else:
        jscene, scene = _scene("cornellish")
        jst = JaxSettings.default(rho=4.0)
        o, d = _rays("toroidal", 64, 64, jst, block=True)
    hv_j, _, n_j = jax_trace_rays(jscene, jst, o, d, backend="pallas")
    seg = []
    real = wf.closest_hit

    def spy(*a, **k):
        seg.append(k["tmax"].shape[0])
        return real(*a, **k)

    wf.closest_hit = spy
    try:
        hv, _, n = wf.trace_rays(scene, settings_from_numpy(jst),
                                 torch.from_numpy(o.T.copy()),
                                 torch.from_numpy(d.T.copy()),
                                 backend="kernel")
    finally:
        wf.closest_hit = real
    err = np.abs(hv.T.numpy() - np.asarray(hv_j)).max(axis=-1)
    flips = err > 1e-3
    assert err[~flips].max() < 5e-4 and flips.sum() <= 4, (
        case, float(err[~flips].max()), int(flips.sum()))
    assert n == int(float(n_j)), (case, n, float(n_j))
    assert min(seg) < seg[0], seg      # a late segment ran compacted
