"""The port's `render` on the CPU, both backends, against the JAX package's
`render` (jnp backend) on the same scene state, and against the checked-in
goldens.

Bounds: image RMSE < 1e-5 at 24x24 (tests/test_pallas.py's pallas-vs-jnp
bound); rays_traced exactly equal; hit_position / ray_origin / ray_dir
within atol 1e-5; goldens max |diff| < 5e-4 at 32x32 (tests/test_golden.py's
bound)."""

import gc
import os

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.render import render as jax_render
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch import (render, render_frames,
                                            render_sequence)
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as port_tk
from toroidal_ray_tracing_tpu_torch.scene import types as scene_types
from toroidal_ray_tracing_tpu_torch.ops import tri_stream as port_ts
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, Scene,
                                                  build_scene, procedural,
                                                  scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace import wavefront

torch.set_num_threads(2)

RES = 24
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# the five scenes of tests/test_pallas.py::test_pallas_matches_jnp, and
# config 7's textured scene (K4 on the kernel backend)
SCENES = {
    "multi_torus": (lambda p: p.scene_multi_torus(True), 2),
    "textured": (lambda p: p.scene_textured_mesh(), 2),
    "cornellish": (lambda p: p.scene_cornellish(), 2),
    "torus_plane": (lambda p: p.scene_torus_plane(True), 1),
    "instanced": (lambda p: p.scene_instanced_torus_grid(n=32), 2),
    "instanced_gated": (lambda p: p.scene_instanced_torus_grid(n=128), 2),
}


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax(name, backend):
    sd, depth = SCENES[name]
    jscene = jax_build(sd(jax_proc))
    jst = JaxSettings.default(max_depth=depth)
    eye, center = (8.0, 5.0, 8.0), (0.0, 0.5, 0.0)
    ref = jax_render(jscene, JaxPinhole(eye=eye, center=center), RES, RES,
                     jst)
    out = render(scene_from_numpy(jscene),
                 PinholeCamera(eye=eye, center=center), RES, RES,
                 settings_from_numpy(jst), backend=backend, device="cpu")
    assert out["image"].shape == (RES, RES, 3)
    err = rmse(out["image"].numpy(), ref["image"])
    assert err < 1e-5, f"{name}/{backend}: rmse {err}"
    assert out["rays_traced"] == int(float(ref["rays_traced"]))
    for key in ("hit_position", "ray_origin", "ray_dir"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("gate_boxes", [512, 8])
def test_streamed_mesh_render_matches_jax(gate_boxes, monkeypatch):
    """A small config 8: the 4,608-triangle torus mesh over its floor with
    TRI_STREAM_MIN patched low, so the kernel backend runs the stream
    twin (with 8 gate boxes: 4 clusters per superblock) against the JAX
    jnp render."""
    monkeypatch.setattr(port_tk, "TRI_STREAM_MIN", 1024)
    monkeypatch.setattr(port_ts, "STREAM_GATE_BOXES", gate_boxes)
    calls = []
    stream = port_tk.tri_closest_hit_stream
    monkeypatch.setattr(port_tk, "tri_closest_hit_stream",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    jscene = jax_build(jax_proc.scene_hires_mesh(seg=48))
    jst = JaxSettings.default(max_depth=2)
    eye, center = (6.0, 4.0, 6.0), (0.0, 0.6, 0.0)
    ref = jax_render(jscene, JaxPinhole(eye=eye, center=center), RES, RES,
                     jst)
    out = render(scene_from_numpy(jscene),
                 PinholeCamera(eye=eye, center=center), RES, RES,
                 settings_from_numpy(jst), backend="kernel", device="cpu")
    assert calls
    err = rmse(out["image"].numpy(), ref["image"])
    assert err < 1e-5, f"rmse {err}"
    assert out["rays_traced"] == int(float(ref["rays_traced"]))


# tests/test_golden.py's cases, built by the port's own scene build
GOLDEN_CASES = {
    "multi_torus_pinhole": (
        lambda: procedural.scene_multi_torus(True),
        PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=3)),
    "cornellish_toroidal": (
        procedural.scene_cornellish,
        ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
        dict(max_depth=2, rho=5.0)),
    "torus_plane_shadow": (
        lambda: procedural.scene_torus_plane(True),
        PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=1, light_position=(6.0, 10.0, 2.0))),
    "textured_mesh": (
        procedural.scene_textured_mesh,
        PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=3)),
}


@pytest.mark.parametrize("name,backend", (
    [(name, "torch") for name in sorted(GOLDEN_CASES)]
    + [(name, "kernel") for name in sorted(GOLDEN_CASES)]))
def test_golden(name, backend):
    sd, cam, kw = GOLDEN_CASES[name]
    want = np.load(os.path.join(GOLDEN, f"{name}.npz"))["image"]
    got = render(build_scene(sd()), cam, 32, 32,
                 RenderSettings.default(**kw), backend=backend,
                 device="cpu")["image"]
    err = np.abs(got.numpy() - want).max()
    assert err < 5e-4, f"{name}/{backend}: max pixel diff {err}"


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_max_depth_zero_traces_one_segment(backend):
    """The raygen loop is a do-while (rgen:75-108): max_depth=0 still
    traces the primary segment, exactly like max_depth=1."""
    scene = build_scene(procedural.scene_multi_torus(True))
    cam = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    a = render(scene, cam, 16, 16, RenderSettings.default(max_depth=0),
               backend=backend, device="cpu")
    b = render(scene, cam, 16, 16, RenderSettings.default(max_depth=1),
               backend=backend, device="cpu")
    assert a["rays_traced"] >= 16 * 16
    assert a["rays_traced"] == b["rays_traced"]
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)


def test_banded_and_spp_render():
    """tile_rows banding reproduces the full-frame image; spp > 1 adds
    seeded jittered samples (same seed, same image)."""
    scene = build_scene(procedural.scene_torus_plane(True))
    cam = PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0))
    st = RenderSettings.default(max_depth=2)
    full = render(scene, cam, 24, 16, st, device="cpu")
    banded = render(scene, cam, 24, 16, st, tile_rows=5, device="cpu")
    assert banded["rays_traced"] == full["rays_traced"]
    for key in ("image", "hit_position", "ray_origin", "ray_dir"):
        torch.testing.assert_close(banded[key], full[key], rtol=0, atol=1e-6)
    a = render(scene, cam, 24, 16, st, spp=3, seed=7, device="cpu")
    b = render(scene, cam, 24, 16, st, spp=3, seed=7, device="cpu")
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)
    assert a["rays_traced"] > full["rays_traced"]
    assert rmse(a["image"].numpy(), full["image"].numpy()) > 0


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("tile_rows", [None, 5])
def test_spp_render_matches_jax(tile_rows, backend):
    """spp = 2 draws the JAX package's jitter: `render`'s sample s from
    fold_in(PRNGKey(seed), s), its tile_rows bands' from the split chain.
    Config 3's scene at 24x16, depth 3, seed 3, against the JAX `render`
    (jnp): max |diff| < 5e-4 (tests/test_golden.py's bound), ray counts
    exact."""
    jscene = jax_build(jax_proc.scene_multi_torus(True))
    jst = JaxSettings.default(max_depth=3)
    eye, center = (8.0, 5.0, 8.0), (0.0, 0.5, 0.0)
    kw = dict(spp=2, seed=3, tile_rows=tile_rows)
    ref = jax_render(jscene, JaxPinhole(eye=eye, center=center), 24, 16,
                     jst, **kw)
    out = render(scene_from_numpy(jscene),
                 PinholeCamera(eye=eye, center=center), 24, 16,
                 settings_from_numpy(jst), backend=backend, device="cpu",
                 **kw)
    err = float(np.abs(out["image"].numpy() - np.asarray(ref["image"])).max())
    assert err < 5e-4, f"{tile_rows}/{backend}: max diff {err}"
    assert out["rays_traced"] == int(float(ref["rays_traced"]))


def test_kernel_render_and_bands_compact(monkeypatch):
    """backend="kernel" compacts live spans in `render` and in each of its
    tile_rows bands: config 3's mirror scene at 96x96 (9,216 rays; bands
    of 48 rows, 4,608 rays) traces its late segments on a smaller prefix,
    and equals the render with COMPACT_FACTORS = () bit for bit, bands to
    1e-6 as above, ray counts exact."""
    scene = build_scene(procedural.scene_multi_torus(True))
    cam = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    st = RenderSettings.default(max_depth=3)
    lanes = []
    real = wavefront.closest_hit

    def spy(*a, **k):
        lanes.append(a[1].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(wavefront, "closest_hit", spy)
    outs = {}
    for name, kw in (("full", {}), ("banded", dict(tile_rows=48))):
        outs[name] = render(scene, cam, 96, 96, st, backend="kernel",
                            device="cpu", **kw)
        outs[name + "_lanes"] = lanes[:]
        lanes.clear()
    monkeypatch.setattr(wavefront, "COMPACT_FACTORS", ())
    plain = render(scene, cam, 96, 96, st, backend="kernel", device="cpu")
    assert outs["full_lanes"][0] == 9216 and min(outs["full_lanes"]) < 9216
    assert max(outs["banded_lanes"]) == 4608
    assert min(outs["banded_lanes"]) < 4608
    assert set(lanes) == {9216}
    full, banded = outs["full"], outs["banded"]
    assert full["rays_traced"] == plain["rays_traced"] \
        == banded["rays_traced"]
    for key in ("image", "hit_position"):
        assert torch.equal(full[key], plain[key]), key
        torch.testing.assert_close(banded[key], full[key], rtol=0, atol=1e-6)


def test_entry_points_default_to_cuda():
    """render, render_sequence and render_frames run on the CUDA device
    unless asked for the CPU: with no GPU the default raises."""
    scene = build_scene(procedural.scene_torus_plane(True))
    cam = PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0))
    calls = (lambda: render(scene, cam, 8, 8)["image"],
             lambda: render_sequence(scene, [cam], 8, 8)["images"],
             lambda: render_frames(scene, [cam], 8, 8)["images"])
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = build_scene(procedural.scene_torus_plane(True))
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, PinholeCamera(), 8, 8, device="cuda")


def _count_copies(monkeypatch):
    """Patch the copy that `Scene.to` makes to count the copies; returns
    the list it appends to."""
    calls = []
    copy = scene_types._copy_scene
    monkeypatch.setattr(scene_types, "_copy_scene",
                        lambda scene, device: calls.append(device)
                        or copy(scene, device))
    return calls


def test_device_copy_cached_per_scene(monkeypatch):
    """A host scene is copied to a device once (the JAX package's
    `_as_device_scene`), copied again after one of its tensors changed in
    place, and the entry is evicted with the scene."""
    copies = _count_copies(monkeypatch)
    scene = build_scene(procedural.scene_torus_plane(True))
    meta = torch.device("meta")
    a = scene.to(meta)
    b = scene.to(meta)
    assert a is b and len(copies) == 1
    assert a.device == meta and a.kernel_tables is scene.kernel_tables
    assert scene.to("cpu") is scene
    key = (id(scene), meta)
    assert key in scene_types._derived
    with torch.no_grad():
        scene.tori.minor_radius.mul_(1.0)
    c = scene.to(meta)
    assert c is not a and len(copies) == 2 and c is scene.to(meta)
    del scene, a, b, c
    gc.collect()
    assert key not in scene_types._derived


def test_render_of_cpu_scene_copies_nothing(monkeypatch):
    copies = _count_copies(monkeypatch)
    scene = build_scene(procedural.scene_torus_plane(True))
    cam = PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0))
    for _ in range(2):
        render(scene, cam, 8, 8, backend="kernel", device="cpu")
    render_sequence(scene, [cam, cam], 8, 8, device="cpu")
    assert copies == []
