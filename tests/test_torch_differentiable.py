"""The port's differentiable path (`trace_rays_fixed`, `closest_hit_diff`)
on the CPU, against itself and against the JAX package's
(`tests/test_differentiable.py`'s setup: one analytic torus, eye (6, 3,
6), depth 1, 24x24).

Bounds: images within atol 1e-6 of the while loop and 1e-5 of the JAX
package's; losses within rtol 1e-5 and gradients within rtol 1e-3 across
backends and against `jax.grad` (test_differentiable.py:136-138's
bounds); the light fit as the JAX test's (150 Adam steps at lr 5e-2,
final loss under 2% of the first, intensity within 12 of 120)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu.scene import to_device
from toroidal_ray_tracing_tpu.trace.wavefront import (
    trace_rays_fixed as jax_fixed)
from toroidal_ray_tracing_tpu_torch.scene import (scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace.intersect import (closest_hit,
                                                            closest_hit_diff)
from toroidal_ray_tracing_tpu_torch.trace.wavefront import (trace_rays,
                                                            trace_rays_fixed)

torch.set_num_threads(2)

F32 = np.float32
RES = 24


def _setup(scene_def, eye, depth, res=RES, center=None):
    jscene = jax_build(scene_def)
    cam = (JaxPinhole(eye=eye) if center is None
           else JaxPinhole(eye=eye, center=center))
    st = JaxSettings.default(max_depth=depth)
    o, d = cam.generate_rays(res, res, st, xp=np)
    o, d = np.asarray(o, F32), np.asarray(d, F32)
    return dict(jscene=to_device(jscene), jst=st, jo=jnp.asarray(o),
                jd=jnp.asarray(d), scene=scene_from_numpy(jscene),
                st=settings_from_numpy(st), o=torch.from_numpy(o),
                d=torch.from_numpy(d))


@pytest.fixture(scope="module")
def setup():
    return _setup(jax_proc.scene_single_torus(analytic=True),
                  (6.0, 3.0, 6.0), 1)


def _with(scene, diffuse=None, minor=None):
    """The port scene with every material's diffuse colour / every torus's
    minor radius broadcast from one tensor (as the JAX tests do)."""
    if diffuse is not None:
        mats = scene.materials
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            mats, diffuse=diffuse.expand(mats.diffuse.shape)))
    if minor is not None:
        tori = scene.tori
        scene = dataclasses.replace(scene, tori=dataclasses.replace(
            tori, minor_radius=minor.expand(tori.minor_radius.shape)))
    return scene


def _with_light(st, intensity, position):
    return dataclasses.replace(st, light=dataclasses.replace(
        st.light, intensity=intensity, position=position))


def test_fixed_matches_while(setup):
    s = setup
    hv, hp, _ = trace_rays(s["scene"], s["st"], s["o"].T.contiguous(),
                           s["d"].T.contiguous())
    hf, hpf = trace_rays_fixed(s["scene"], s["st"], s["o"], s["d"], 1)
    np.testing.assert_allclose(hv.T.numpy(), hf.numpy(), atol=1e-6)
    np.testing.assert_allclose(hp.T.numpy(), hpf.numpy(), atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("case", ["single_torus", "multi_torus_depth2"])
def test_fixed_matches_jax(setup, case, backend):
    """trace_rays_fixed's image and first hits equal the JAX package's
    (jnp) on the same inputs, on the JAX test's scene and on a mirror
    scene at depth 2."""
    s = setup if case == "single_torus" else _setup(
        jax_proc.scene_multi_torus(analytic=True), (8.0, 5.0, 8.0), 2,
        center=(0.0, 0.5, 0.0))
    depth = int(s["st"].max_depth)
    jh, jp = jax_fixed(s["jscene"], s["jst"], s["jo"], s["jd"], depth)
    with torch.no_grad():
        h, p = trace_rays_fixed(s["scene"], s["st"], s["o"], s["d"], depth,
                                backend=backend)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)


def test_gradient_wrt_material_color(setup):
    """d(loss)/d(diffuse) is finite and points the right way."""
    s = setup

    def render_with(diffuse):
        return trace_rays_fixed(_with(s["scene"], diffuse=diffuse), s["st"],
                                s["o"], s["d"], 1)[0]

    with torch.no_grad():
        target = render_with(torch.tensor([0.2, 0.7, 0.3]))
    diffuse = torch.tensor([0.8, 0.1, 0.1], requires_grad=True)
    torch.mean((render_with(diffuse) - target) ** 2).backward()
    g = diffuse.grad
    assert torch.isfinite(g).all()
    assert float(g[0]) > 0 and float(g[1]) < 0  # too red, not green enough


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_inverse_fit_light(setup, backend):
    """Recover the light's intensity and height from a target image by
    gradient descent through shading (torch.optim.Adam in place of
    optax.adam, same steps and rate)."""
    s = setup

    def render_with(params):
        intensity, ly = params[0], params[1]
        pos = torch.tensor([10.0, 1.0, 8.0]) * torch.stack(
            [torch.ones(()), ly, torch.ones(())])
        st = _with_light(s["st"], intensity, pos)
        return trace_rays_fixed(s["scene"], st, s["o"], s["d"], 1,
                                backend=backend)[0]

    with torch.no_grad():
        target = render_with(torch.tensor([120.0, 12.0]))

    def loss(theta):       # log-parametrization keeps scales comparable
        return torch.mean((render_with(torch.exp(theta)) - target) ** 2)

    theta = torch.log(torch.tensor([60.0, 6.0])).requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=5e-2)
    with torch.no_grad():
        l0 = float(loss(theta))
    for _ in range(150):
        opt.zero_grad()
        loss(theta).backward()
        opt.step()
    with torch.no_grad():
        l1 = float(loss(theta))
    fit = torch.exp(theta).detach().numpy()
    assert np.isfinite(l1)
    assert l1 < 0.02 * l0, (l0, l1)
    assert abs(fit[0] - 120.0) < 12.0, fit


def test_radius_gradient_is_finite(setup):
    """Gradients through the quartic intersection exist, are finite and
    nonzero."""
    s = setup
    r = torch.tensor(0.55, requires_grad=True)
    hv, _ = trace_rays_fixed(_with(s["scene"], minor=r), s["st"], s["o"],
                             s["d"], 1)
    hv.mean().backward()
    assert torch.isfinite(r.grad) and float(r.grad) != 0.0


@pytest.mark.parametrize("m", [0.5, 0.65])
def test_kernel_backend_gradients(setup, m):
    """backend="kernel" runs the kernels (their CPU twins here) for the
    primal and recomputes the backward pass on the torch path: loss and
    gradient equal the all-torch formulation's."""
    s = setup
    out = {}
    for backend in ("torch", "kernel"):
        r = torch.tensor(m, requires_grad=True)
        hv, _ = trace_rays_fixed(_with(s["scene"], minor=r), s["st"], s["o"],
                                 s["d"], 1, backend=backend)
        loss = hv.mean()
        loss.backward()
        out[backend] = (float(loss.detach()), float(r.grad))
    (lt, gt), (lk, gk) = out["torch"], out["kernel"]
    np.testing.assert_allclose(lk, lt, rtol=1e-5)
    assert gt != 0.0
    np.testing.assert_allclose(gk, gt, rtol=1e-3)


def _jax_loss(s, which, depth):
    """The JAX package's loss (image mean) as a function of one parameter."""
    scene, st = s["jscene"], s["jst"]

    def loss(x):
        sc, stt = scene, st
        if which == "diffuse":
            mats = sc.materials._replace(diffuse=jnp.broadcast_to(
                x, sc.materials.diffuse.shape))
            sc = dataclasses.replace(sc, materials=mats)
        elif which == "minor":
            tori = sc.tori._replace(minor_radius=jnp.broadcast_to(
                x, sc.tori.minor_radius.shape))
            sc = dataclasses.replace(sc, tori=tori)
        elif which == "intensity":
            stt = st._replace(light=st.light._replace(intensity=x))
        else:
            stt = st._replace(light=st.light._replace(position=x))
        hv, _ = jax_fixed(sc, stt, s["jo"], s["jd"], depth)
        return jnp.mean(hv)

    return loss


PARAMS = {"diffuse": np.asarray([0.6, 0.5, 0.4], F32),
          "minor": np.asarray(0.55, F32),
          "intensity": np.asarray(90.0, F32),
          "position": np.asarray([10.0, 15.0, 8.0], F32)}


def _match_jax(s, which, backend, depth):
    """The port's loss and autograd gradient against jax.grad's on the
    same seeded state: loss within rtol 1e-5, gradient finite and within
    rtol 1e-3."""
    x0 = PARAMS[which]
    jl, jg = jax.value_and_grad(_jax_loss(s, which, depth))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    scene, st = s["scene"], s["st"]
    if which == "diffuse":
        scene = _with(scene, diffuse=x)
    elif which == "minor":
        scene = _with(scene, minor=x)
    elif which == "intensity":
        st = _with_light(st, x, st.light.position)
    else:
        st = _with_light(st, st.light.intensity, x)
    hv, _ = trace_rays_fixed(scene, st, s["o"], s["d"], depth,
                             backend=backend)
    loss = hv.mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-3)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("which", sorted(PARAMS))
def test_gradients_match_jax(setup, which, backend):
    """d(image mean)/d(diffuse, minor radius, light intensity, light
    position): the port's autograd against jax.grad on the same seeded
    state."""
    _match_jax(setup, which, backend, 1)


@pytest.fixture(scope="module")
def textured():
    return _setup(jax_proc.scene_textured_mesh(), (8.0, 5.0, 8.0), 2,
                  res=16, center=(0.0, 0.5, 0.0))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("which", ["diffuse", "intensity", "position"])
def test_textured_two_bounce_gradients_match_jax(textured, which, backend):
    """End-to-end gradient parity through a 2-bounce textured render
    (trilinear mip sampling; K4's twin on the kernel backend): the texel
    words are integers, the blend weights carry the gradient."""
    _match_jax(textured, which, backend, 2)


def test_optimizer_updates_minor_radius_in_place(setup):
    """An optimizer that steps `tori.minor_radius` in place: each step's
    kernel-backend loss equals a freshly built scene's (the kernel tables
    kept on the scene follow the tensor's version)."""
    s = setup
    base = s["scene"]
    minor = base.tori.minor_radius.clone().requires_grad_(True)
    scene = dataclasses.replace(base, tori=dataclasses.replace(
        base.tori, minor_radius=minor))
    with torch.no_grad():
        target = trace_rays_fixed(_with(base, minor=torch.tensor(0.3)),
                                  s["st"], s["o"], s["d"], 1,
                                  backend="kernel")[0]
    opt = torch.optim.SGD([minor], lr=2.0)
    losses = []
    for _ in range(4):
        opt.zero_grad()
        hv, _ = trace_rays_fixed(scene, s["st"], s["o"], s["d"], 1,
                                 backend="kernel")
        loss = torch.mean((hv - target) ** 2)
        loss.backward()
        fresh = dataclasses.replace(base, tori=dataclasses.replace(
            base.tori, minor_radius=minor.detach().clone()))
        with torch.no_grad():
            hf, _ = trace_rays_fixed(fresh, s["st"], s["o"], s["d"], 1,
                                     backend="kernel")
        assert float(loss.detach()) == float(torch.mean((hf - target) ** 2))
        losses.append(float(loss.detach()))
        opt.step()
    assert len(set(losses)) == len(losses), losses   # the radius moved


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_shadowed_point_light_gradients_finite(backend, monkeypatch):
    """A torus casting a hard shadow on a plane under a point light: the
    light's gradients are finite, and the shadow query runs on inputs cut
    off from autograd (JAX's stop_gradient: visibility has no derivative,
    and no graph is built for the query)."""
    from toroidal_ray_tracing_tpu_torch.trace import shade as shade_mod

    s = _setup(jax_proc.scene_torus_plane(analytic=True), (7.0, 4.0, 7.0),
               1, center=(0.0, 0.5, 0.0))
    seen, occluded = [], []
    real = shade_mod.any_hit

    def spy(scene, origins, dirs, tmax, **kw):
        seen.append((origins.requires_grad, dirs.requires_grad,
                     tmax.requires_grad))
        mask = real(scene, origins, dirs, tmax, **kw)
        occluded.append(int(mask.sum()))
        return mask

    monkeypatch.setattr(shade_mod, "any_hit", spy)
    intensity = torch.tensor(100.0, requires_grad=True)
    pos = torch.tensor([1.0, 6.0, 1.0], requires_grad=True)
    st = _with_light(s["st"], intensity, pos)
    hv, _ = trace_rays_fixed(s["scene"], st, s["o"], s["d"], 1,
                             backend=backend)
    hv.mean().backward()
    assert torch.isfinite(intensity.grad) and torch.isfinite(pos.grad).all()
    assert float(intensity.grad) > 0.0
    assert occluded and occluded[0] > 5       # shadowed pixels exist
    assert seen == [(False, False, False)] * len(seen)


def test_closest_hit_diff_matches_closest_hit(setup):
    """closest_hit_diff's forward is the kernel query: t, kind, prim, u, v
    equal `closest_hit(backend="kernel")`."""
    s = setup
    o, d = s["o"].T.contiguous(), s["d"].T.contiguous()
    a = closest_hit_diff(s["scene"], o, d)
    b = closest_hit(s["scene"], o, d, backend="kernel")
    for k in ("t", "kind", "prim", "u", "v"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_kernel_tables_follow_versions_and_copies(monkeypatch):
    """The kernel tables kept on a scene: one entry per key, reused while
    its source tensors are the same and unchanged, rebuilt for a copy with
    tensors of its own (one shared `kernel_tables`) and after an in-place
    update, and the entries do not grow with the updates."""
    from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as port_tk
    from toroidal_ray_tracing_tpu_torch.scene import build_scene, procedural

    built = []
    real = port_tk.torus_tables
    monkeypatch.setattr(port_tk, "torus_tables",
                        lambda *a: built.append(1) or real(*a))
    scene = build_scene(procedural.scene_multi_torus(True))
    copy = dataclasses.replace(scene, tori=dataclasses.replace(
        scene.tori, minor_radius=scene.tori.minor_radius.clone()))
    copy.kernel_tables = scene.kernel_tables
    o = torch.tensor([[8.0, 5.0, 8.0]]).T.repeat(1, 64).contiguous()
    d = -o / torch.linalg.vector_norm(o, dim=0)
    for s in (scene, scene, copy, copy):
        closest_hit(s, o, d, backend="kernel")
    assert len(built) == 2
    for _ in range(3):
        with torch.no_grad():
            copy.tori.minor_radius.mul_(1.01)
        a = closest_hit(copy, o, d, backend="kernel")
        b = closest_hit(copy, o, d, backend="torch")
        assert torch.equal(a.kind, b.kind) and torch.equal(a.t, b.t)
    closest_hit(scene, o, d, backend="kernel")
    assert len(built) == 6
    assert list(scene.kernel_tables) == [("torus", scene.device)]
