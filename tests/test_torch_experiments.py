"""The port's capture experiment against the JAX package's: the text dumps
byte-identical for equal arrays (native writer and np.savetxt), the
reference's loadPoints parse, the point-cloud splat, the rho sweep (dumps
within atol 1e-5 of JAX renders), the reprojection stats (within 1e-6), the
OBJ spec transforms, the end-to-end script and the PNG writer. Sizes stay at
16-24 px on the CPU."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import ToroidalCamera as JaxToroidal
from toroidal_ray_tracing_tpu.experiments import gtruth as jax_gtruth
from toroidal_ray_tracing_tpu.experiments import reproject as jax_reproject
from toroidal_ray_tracing_tpu.experiments import rho_sweep as jax_sweep
from toroidal_ray_tracing_tpu.experiments import scene_args as jax_scene_args
from toroidal_ray_tracing_tpu.experiments.configs import \
    SCENARIOS as JAX_SCENARIOS
from toroidal_ray_tracing_tpu.io import dumps as jax_dumps
from toroidal_ray_tracing_tpu.io import native as jax_native
from toroidal_ray_tracing_tpu.pointcloud import splat_points as jax_splat
from toroidal_ray_tracing_tpu.render import render as jax_render
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera)
from toroidal_ray_tracing_tpu_torch.experiments import (gtruth, reproject,
                                                        rho_sweep, scene_args,
                                                        toroidal_experiment)
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.io import dumps, native, png
from toroidal_ray_tracing_tpu_torch.pointcloud import splat_points
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, SceneDef,
                                                  procedural)

torch.set_num_threads(2)

F32 = np.float32
RES = 16
EYE_T, CTR_T = (0.0, 1.0, 0.0), (8.0, 0.0, 0.0)
EYE_P, CTR_P = (7.0, 4.0, 7.0), (0.0, 0.5, 0.0)


@pytest.fixture(params=["native", "savetxt"])
def writer(request, monkeypatch):
    """Both packages' dump writers on one path: the shared native library
    or np.savetxt."""
    if request.param == "native":
        assert native.available() and jax_native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    return request.param


def _image(seed, h=5, w=7):
    img = np.random.default_rng(seed).normal(0, 50, (h, w, 3)).astype(F32)
    img[0, 0] = (np.nan, np.inf, -np.inf)
    img[1, 2] = (0.0, -0.0, 1e-30)
    img[2, 3] = (1e30, -3.4028235e38, 123456789.0)
    return img


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_dumps_byte_identical(tmp_path, writer):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    pos, col, org, dirs = (_image(s) for s in range(4))
    pairs = [
        (dumps.write_rendered_position(a, 4.5, pos),
         jax_dumps.write_rendered_position(b, 4.5, pos)),
        (dumps.write_color_image(a, 10.0, col),
         jax_dumps.write_color_image(b, 10.0, col)),
        *zip(dumps.write_rendered_rays(a, org, dirs),
             jax_dumps.write_rendered_rays(b, org, dirs)),
        (dumps.write_gtruth(a, "toroidal", col),
         jax_dumps.write_gtruth(b, "toroidal", col)),
        (dumps.write_ptcloud_image(a, "toroidal", pos, tag="7.5"),
         jax_dumps.write_ptcloud_image(b, "toroidal", pos, tag="7.5")),
    ]
    for p, r in pairs:
        assert os.path.relpath(p, a) == os.path.relpath(r, b)
        assert _bytes(p) == _bytes(r), os.path.basename(p)


def test_position_color_realign_matches_jax(tmp_path):
    pos, col = _image(5), _image(6)
    dumps.write_rendered_position(str(tmp_path), 4.0, pos)
    dumps.write_color_image(str(tmp_path), 4.0, col)
    got = dumps.read_position_color(str(tmp_path), 4.0, 7, 5)
    want = jax_dumps.read_position_color(str(tmp_path), 4.0, 7, 5)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    dumps.write_color_image(str(tmp_path), 4.0, col[:2])
    with pytest.raises(ValueError):
        dumps.read_position_color(str(tmp_path), 4.0, 7, 5)


def test_rho_tag_and_npz(tmp_path):
    assert [dumps.rho_tag(r) for r in rho_sweep.rho_values()] == \
        [jax_dumps.rho_tag(r) for r in jax_sweep.rho_values()]
    out = {k: _image(i) for i, k in enumerate(rho_sweep.DUMP_KEYS)}
    path = dumps.save_render_npz(str(tmp_path / "r.npz"), out)
    back = dumps.load_render_npz(path)
    ref = jax_dumps.load_render_npz(path)
    for k in out:
        assert back[k].tobytes() == out[k].tobytes() == ref[k].tobytes()


def test_read_points_reference_semantics(tmp_path, writer):
    """tests/test_io_experiments.py's byte fixture: < 3 tokens -> whole row
    lowest; per-token "-nan" -> lowest; std::stof prefix parsing keeps
    inf/+nan and trailing garbage; one row per line, however long."""
    LOW = dumps.FLOAT_LOWEST
    p = tmp_path / "pts.txt"
    p.write_bytes(
        b"1.5 -2.25 3e2\n"
        b"-nan nan 1.0\n"
        b"0.1 0.2\n"
        b"junk 1.0 2.0\n"
        b"\n"
        b"7 8 9 extra tokens\n"
        b"1.0 2.0 3.0abc\n"
        b"inf -inf 4.5\n"
        b"1 2 3 " + b"x" * 600 + b"\n"
        b"4.0 5.0 6.0")
    expect = np.array([
        [1.5, -2.25, 300.0],
        [LOW, np.nan, 1.0],
        [LOW, LOW, LOW],
        [LOW, 1.0, 2.0],
        [LOW, LOW, LOW],
        [7.0, 8.0, 9.0],
        [1.0, 2.0, 3.0],
        [np.inf, -np.inf, 4.5],
        [1.0, 2.0, 3.0],
        [4.0, 5.0, 6.0]], np.float32)
    got = dumps.read_points(str(p))
    assert got.dtype == np.float32 and got.shape == expect.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expect))
    m = ~np.isnan(expect)
    np.testing.assert_array_equal(got[m], expect[m])
    assert got.tobytes() == jax_dumps.read_points(str(p)).tobytes()


def _cloud(n=400, seed=0):
    """Points in front of the pinhole, with sentinel rows and exact depth
    ties of different colors (the per-channel max-color rule)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, (n, 3)).astype(F32)
    col = rng.uniform(0.0, 1.0, (n, 3)).astype(F32)
    pos[:10] = dumps.FLOAT_LOWEST
    pos[10:20] = pos[20:30]
    col[10:20, 0] = 1.0 - col[20:30, 0]
    return pos, col


@pytest.mark.parametrize("point_size,fill", [(2.5, 0.0), (2.5, 9.0)])
def test_splat_matches_jax(point_size, fill):
    """24x24: cover masks equal; at most 1 of 576 pixels may differ, from
    the projection's float32 rounding. The port sums the projection's
    products in XLA's order, so none does here."""
    pos, col = _cloud()
    cam = PinholeCamera(eye=EYE_P, center=CTR_P)
    img, cover, n = splat_points(pos, col, cam, 24, 24, point_size=point_size,
                                 fill_holes=fill, return_cover=True,
                                 device="cpu")
    rimg, rcover, rn = jax_splat(pos, col, JaxPinhole(eye=EYE_P,
                                                      center=CTR_P),
                                 24, 24, point_size=point_size,
                                 fill_holes=fill, return_cover=True)
    assert n == rn == 390
    rimg, rcover = np.asarray(rimg), np.asarray(rcover)
    assert 0.1 < rcover.mean() < 1.0
    np.testing.assert_array_equal(cover.numpy(), rcover)
    off = int((img.numpy() != rimg).any(axis=2).sum())
    assert off <= 1, off
    assert img.numpy().tobytes() == rimg.tobytes()


def _sweep(tmp_path, backend, **kw):
    return rho_sweep.run_sweep(
        procedural.scene_torus_plane(), str(tmp_path),
        ToroidalCamera(eye=EYE_T, center=CTR_T), RES, RES,
        RenderSettings.default(max_depth=1), backend=backend, device="cpu",
        **kw)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_sweep_matches_jax(tmp_path, backend):
    files = _sweep(tmp_path, backend, save_npz=True)
    names = sorted(os.path.relpath(f, tmp_path) for f in files)
    want = sorted(
        [os.path.join("data", f"rendered{k}{jax_dumps.rho_tag(r)}.txt")
         for r in jax_sweep.rho_values() for k in ("Position", "Color")]
        + [os.path.join("data", "origins.txt"),
           os.path.join("data", "directions.txt")]
        + [f"render_rho{jax_dumps.rho_tag(r)}.npz"
           for r in jax_sweep.rho_values()])
    assert names == want
    jscene = jax_build(jax_proc.scene_torus_plane())
    cam = JaxToroidal(eye=EYE_T, center=CTR_T)
    for rho in (4.0, 10.0):
        st = JaxSettings.default(max_depth=1)._replace(rho=F32(rho))
        ref = jax_render(jscene, cam, RES, RES, st)
        got = dumps.load_render_npz(
            str(tmp_path / f"render_rho{dumps.rho_tag(rho)}.npz"))
        for k in rho_sweep.DUMP_KEYS:
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0,
                                       atol=1e-5, err_msg=f"{rho} {k}")
        # the text dumps are the JAX writer's for those arrays
        jdir = str(tmp_path / "jax")
        p = jax_dumps.write_rendered_position(jdir, rho, got["hit_position"])
        c = jax_dumps.write_color_image(jdir, rho, got["image"])
        for f in (p, c):
            assert _bytes(f) == _bytes(str(tmp_path / os.path.relpath(
                f, jdir)))


def _flips(a, b):
    """(pixels off by > 1e-3, RMSE over the other pixels) of two images."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    off = diff.max(axis=2) > 1e-3
    return int(off.sum()), float(np.sqrt(np.mean(diff[~off] ** 2)))


@pytest.mark.parametrize("depth", [3, 10])
def test_backends_on_deep_mirror_paths_flip_no_more_than_jax(depth):
    """The capture's settings (toroidal, rho 4) on config 6's mirror scene:
    the port's two backends flip no more pixels than the JAX package's
    jnp and Pallas paths do (a path bouncing between curved mirrors grows
    a last-ulp difference in shading arithmetic until it takes another
    surface), none at depth 3, and agree to RMSE 1e-4 elsewhere."""
    w, h = 8, 6
    eye, ctr = (0.0, 1.5, 0.0), (8.0, 0.0, 0.0)
    scene = SCENARIOS[6].build()
    st = RenderSettings.default(max_depth=depth, rho=4.0)
    port = [render(scene, ToroidalCamera(eye=eye, center=ctr), w, h, st,
                   backend=b, device="cpu")["image"].numpy()
            for b in ("kernel", "torch")]
    jscene = JAX_SCENARIOS[6].build()
    jst = JaxSettings.default(max_depth=depth)._replace(rho=F32(4.0))
    ref = [jax_render(jscene, JaxToroidal(eye=eye, center=ctr), w, h, jst,
                      backend=b)["image"] for b in ("pallas", "jnp")]
    off, rmse = _flips(*port)
    ref_off = _flips(*ref)[0]
    assert off <= ref_off and (depth > 3 or off == 0), (off, ref_off)
    assert rmse < 1e-4


def test_frames_per_step_dumps_equal(tmp_path):
    one = _sweep(tmp_path / "one", "kernel", save_rays=False)
    three = _sweep(tmp_path / "three", "kernel", save_rays=False,
                   frames_per_step=3)
    assert len(one) == len(three) == 26
    for a, b in zip(one, three):
        assert _bytes(a) == _bytes(b), os.path.basename(a)


def test_subject_follow_pins_instance0_to_eye(tmp_path, monkeypatch):
    """With camera_path and subject_follow, every frame renders a scene
    whose instance 0 (the subject cube) is centered on that frame's eye."""
    seen = []
    real = rho_sweep.render

    def spy(scene, camera, *a, **k):
        rows = scene.triangles.instance_id == 0
        v0, e1, e2 = (getattr(scene.triangles, f)[rows]
                      for f in ("v0", "e1", "e2"))
        pts = torch.cat([v0, v0 + e1, v0 + e2])
        mid = (pts.amin(0) + pts.amax(0)) / 2
        seen.append((mid.numpy(), np.asarray(camera.eye, F32)))
        return real(scene, camera, *a, **k)

    monkeypatch.setattr(rho_sweep, "render", spy)
    sd = SceneDef()
    sd.add_model(procedural.cube(1.0, per_face_mats=True))
    sd.add_model(procedural.plane(8.0, y=-1.0))

    def path(step):
        return ToroidalCamera(eye=(0.2 * step, 0.0, 0.1 * step),
                              center=(10.0, 0.0, 0.0))

    files = rho_sweep.run_sweep(sd, str(tmp_path), width=RES, height=RES,
                                settings=RenderSettings.default(max_depth=1),
                                subject_follow=True, save_rays=False,
                                camera_path=path, device="cpu")
    assert len(files) == 26 and len(seen) == 13
    for mid, eye in seen:
        np.testing.assert_allclose(mid, eye, atol=1e-5)
    p0, p1 = (dumps.read_points(f) for f in (files[0], files[-2]))
    assert not np.array_equal(p0, p1)


def test_reproject_all_matches_jax(tmp_path):
    """One port-written capture (with a port gTruth): the JAX and the port
    reprojections give the same stats."""
    cap = str(tmp_path)
    _sweep(tmp_path, "kernel", save_rays=False)
    gtruth.run_gtruth(procedural.scene_torus_plane(), cap, "tp",
                      PinholeCamera(eye=EYE_P, center=CTR_P), RES, RES,
                      RenderSettings.default(max_depth=1), device="cpu")
    ref = jax_reproject.run_reproject_all(
        cap, "tp", JaxPinhole(eye=EYE_P, center=CTR_P), RES, RES, RES, RES,
        save_png=False)
    got = reproject.run_reproject_all(
        cap, "tp", PinholeCamera(eye=EYE_P, center=CTR_P), RES, RES, RES,
        RES, device="cpu")
    assert [r["rho"] for r in got] == [r["rho"] for r in ref]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert g["n_points"] == r["n_points"]
        for k in ("rmse", "rmse_covered", "rmse_holes", "coverage"):
            assert abs(g[k] - r[k]) <= 1e-6, (g["rho"], k, g[k], r[k])
        txt, png_file = g["files"]
        assert os.path.basename(txt) == os.path.basename(r["files"][0])
        assert png_file == txt.replace(os.sep + "data", "")[:-4] + ".png"


@pytest.mark.parametrize("spec", ["m.obj", "d/m.obj@1,2,3",
                                  "m.obj@0.5,-1,2,0.25",
                                  "m@x.obj@0,-1,0,2,45",
                                  "m.obj@1,2,3,1,0"])
def test_parse_obj_spec_bit_equal(spec):
    path, xf = scene_args.parse_obj_spec(spec)
    rpath, rxf = jax_scene_args.parse_obj_spec(spec)
    assert path == rpath
    assert xf.dtype == rxf.dtype and xf.tobytes() == rxf.tobytes()


def test_parse_obj_spec_rejects_bad_transform():
    with pytest.raises(ValueError):
        scene_args.parse_obj_spec("m.obj@1,2")


def test_experiment_without_gtruth_prints_table(tmp_path, capsys):
    summary = toroidal_experiment.main([
        "--scene", "torus_plane", "--width", str(RES), "--height", str(RES),
        "--device", "cpu", "--no-gtruth",
        "--out", str(tmp_path)])
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.strip().startswith("4.0 ")]
    assert len(rows) == 1 and " - " in rows[0]
    assert len(summary["by_rho"]) == 13
    assert all(v["rmse"] is None for v in summary["by_rho"].values())


def test_png_writer_decodes(tmp_path):
    """The port's PNG and the JAX gTruth script's PIL PNG of one image
    decode to the same uint8 array."""
    img = np.random.default_rng(3).uniform(-0.2, 1.2, (5, 7, 3)).astype(F32)
    img[0, 0] = (0.0, 1.0, 0.5)
    path = png.save_png(str(tmp_path / "x.png"), img)
    jax_gtruth._save_png(str(tmp_path / "jax.png"), img)
    got = np.asarray(Image.open(path))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.dtype == np.uint8 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, want)


def test_experiment_entry_points_default_to_cuda(tmp_path):
    """run_sweep, run_gtruth and splat_points run on the CUDA device
    unless asked for the CPU: with no GPU the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pos, col = _cloud(40)
    calls = (
        lambda: rho_sweep.run_sweep(procedural.scene_torus_plane(),
                                    str(tmp_path), width=8, height=8),
        lambda: gtruth.run_gtruth(procedural.scene_torus_plane(),
                                  str(tmp_path), "tp", width=8, height=8),
        lambda: splat_points(pos, col, PinholeCamera(), 8, 8))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
