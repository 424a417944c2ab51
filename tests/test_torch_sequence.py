"""The port's `render_sequence` and `render_frames` on the CPU, both
backends, against the JAX package's front doors (jnp backend) and against
the port's per-frame `render`, as tests/test_sequence.py checks the JAX
package.

Bounds: images RMSE < 1e-5 against JAX at 16x16 (tests/test_pallas.py's
pallas-vs-jnp bound), max |diff| < 1e-6 against per-frame renders (the
bound of tests/test_sequence.py); rays_traced exactly equal."""

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.render import render_frames as jax_frames
from toroidal_ray_tracing_tpu.render import render_sequence as jax_sequence
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch import (PinholeCamera, render,
                                            render_frames, render_sequence)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                  build_scene, procedural,
                                                  scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.render import renderer
from toroidal_ray_tracing_tpu_torch.trace import wavefront
from toroidal_ray_tracing_tpu_torch.utils import prng

torch.set_num_threads(2)

RES = 16
POSES = [((3.5 - f, 2.0, 3.5), (0.0, 0.8, 0.0)) for f in range(3)]


@pytest.fixture(scope="module")
def setup():
    jscene = jax_build(jax_proc.scene_cornellish())
    jst = JaxSettings.default(max_depth=2)
    cams = [PinholeCamera(eye=e, center=c) for e, c in POSES]
    return jscene, jst, scene_from_numpy(jscene), settings_from_numpy(jst), \
        cams


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _per_frame(scene, st, cams, backend, **kw):
    return [render(scene, cam, RES, RES, st, backend=backend, device="cpu",
                   **kw) for cam in cams]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_sequence_matches_jax_and_per_frame(setup, backend):
    jscene, jst, scene, st, cams = setup
    ref = jax_sequence(jscene, [JaxPinhole(eye=e, center=c) for e, c in POSES],
                       RES, RES, jst)
    seq = render_sequence(scene, cams, RES, RES, st, backend=backend,
                          device="cpu")
    assert seq["images"].shape == (len(cams), RES, RES, 3)
    assert rmse(seq["images"].numpy(), ref["images"]) < 1e-5
    assert seq["rays_traced"] == int(float(ref["rays_traced"]))
    frames = _per_frame(scene, st, cams, backend)
    for f, out in enumerate(frames):
        err = float((seq["images"][f] - out["image"]).abs().max())
        assert err < 1e-6, f"frame {f}: {err}"
    assert seq["rays_traced"] == sum(o["rays_traced"] for o in frames)
    # frames_per_batch=1 (one wavefront per frame) gives the same result
    one = render_sequence(scene, cams, RES, RES, st, backend=backend,
                          frames_per_batch=1, device="cpu")
    assert float((one["images"] - seq["images"]).abs().max()) < 1e-6
    assert one["rays_traced"] == seq["rays_traced"]
    lite = render_sequence(scene, cams, RES, RES, st, backend=backend,
                           keep_images=False, device="cpu")
    assert "images" not in lite
    assert lite["rays_traced"] == seq["rays_traced"]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_frames_match_jax_and_per_frame(setup, backend):
    jscene, jst, scene, st, cams = setup
    ref = jax_frames(jscene, [JaxPinhole(eye=e, center=c) for e, c in POSES],
                     RES, RES, jst)
    batch = render_frames(scene, cams, RES, RES, st, backend=backend,
                          device="cpu")
    keys = (("images", "image"), ("hit_positions", "hit_position"),
            ("ray_origins", "ray_origin"), ("ray_dirs", "ray_dir"))
    for bkey, _ in keys:
        assert batch[bkey].shape == (len(cams), 3, RES, RES), bkey
        assert rmse(batch[bkey].numpy(), ref[bkey]) < 1e-5, bkey
    assert batch["rays_traced"] == int(float(ref["rays_traced"]))
    frames = _per_frame(scene, st, cams, backend)
    for f, out in enumerate(frames):
        for bkey, rkey in keys:
            got = batch[bkey][f].permute(1, 2, 0)
            err = float((got - out[rkey]).abs().max())
            assert err < 1e-6, f"frame {f} {bkey}: {err}"
    assert batch["rays_traced"] == sum(o["rays_traced"] for o in frames)
    lite = render_frames(scene, cams, RES, RES, st, backend=backend,
                         dumps=False, device="cpu")
    assert set(lite) == {"images", "rays_traced"}
    torch.testing.assert_close(lite["images"], batch["images"], rtol=0,
                               atol=0)
    solo = render_frames(scene, cams, RES, RES, st, backend=backend,
                         frames_per_batch=1, device="cpu")
    assert float((solo["images"] - batch["images"]).abs().max()) < 1e-6
    assert solo["rays_traced"] == batch["rays_traced"]


@pytest.mark.parametrize("front", ["render_sequence", "render_frames"])
def test_compacted_batch_equals_per_frame(front, monkeypatch):
    """backend="kernel" compacts one wavefront of several frames as it
    compacts each frame's own: config 3's mirror scene, 3 frames at 64x64
    (12,288 rays a batch, 4,096 a frame), late segments on a smaller
    prefix in both, every frame within 1e-6 of its `render` (the file's
    bound), ray counts exact."""
    scene = build_scene(procedural.scene_multi_torus(True))
    st = RenderSettings.default(max_depth=3)
    cams = [PinholeCamera(eye=(8.0 - f, 5.0, 8.0), center=(0.0, 0.5, 0.0))
            for f in range(3)]
    lanes = []
    real = wavefront.closest_hit

    def spy(*a, **k):
        lanes.append(a[1].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(wavefront, "closest_hit", spy)
    fn = render_sequence if front == "render_sequence" else render_frames
    batch = fn(scene, cams, 64, 64, st, backend="kernel", device="cpu")
    assert lanes[0] == 3 * 4096 and min(lanes) < lanes[0], lanes
    lanes.clear()
    frames = [render(scene, cam, 64, 64, st, backend="kernel", device="cpu")
              for cam in cams]
    assert min(lanes) < 4096, lanes
    for f, one in enumerate(frames):
        got = batch["images"][f]
        if front == "render_frames":
            got = got.permute(1, 2, 0)
        err = float((got - one["image"]).abs().max())
        assert err < 1e-6, f"frame {f}: {err}"
    assert batch["rays_traced"] == sum(o["rays_traced"] for o in frames)


def _keyed_frame(scene, st, cam, spp, sample_key):
    """One frame through render's own sample loop, sample s's jitter drawn
    from sample_key(s)."""
    scene, st, device = renderer._setup(scene, st, cam, RES, RES, "cpu")
    (image, *_), _ = renderer._spp_frame(scene, st, cam, RES, RES, "torch",
                                         spp, sample_key, device)
    return image


def test_spp_jitter_is_seeded(setup):
    """spp > 1 averages jittered samples after the centered one, sample s
    of frame f drawn from the JAX package's key fold_in(PRNGKey(seed),
    f * spp + s): frame 0 equals render(spp, seed), frame f the frame whose
    jitter comes from that key (not render(spp, seed + f)); the same seed
    gives the same images, another seed other images."""
    _, _, scene, st, cams = setup
    kw = dict(spp=2, seed=3, device="cpu")
    a = render_frames(scene, cams[:2], RES, RES, st, **kw)
    b = render_sequence(scene, cams[:2], RES, RES, st, **kw)
    root = prng.prng_key(3)
    for f in range(2):
        one = _keyed_frame(scene, st, cams[f], 2,
                           lambda s, f=f: prng.fold_in(root, f * 2 + s))
        if f == 0:
            torch.testing.assert_close(
                render(scene, cams[0], RES, RES, st, **kw)["image"], one,
                rtol=0, atol=0)
        else:
            old_rule = render(scene, cams[f], RES, RES, st, spp=2,
                              seed=3 + f, device="cpu")["image"]
            assert float((old_rule - one).abs().max()) > 0
        torch.testing.assert_close(a["images"][f].permute(1, 2, 0), one,
                                   rtol=0, atol=0)
        torch.testing.assert_close(b["images"][f], one, rtol=0, atol=0)
    again = render_sequence(scene, cams[:2], RES, RES, st, **kw)
    torch.testing.assert_close(again["images"], b["images"], rtol=0, atol=0)
    other = render_sequence(scene, cams[:2], RES, RES, st, spp=2, seed=4,
                            device="cpu")
    assert float((other["images"] - b["images"]).abs().max()) > 0
    base = render_sequence(scene, cams[:2], RES, RES, st, device="cpu")
    assert b["rays_traced"] > 1.5 * base["rays_traced"]
    with pytest.raises(ValueError):
        render_sequence(scene, cams[:2], RES, RES, st, spp=2,
                        frames_per_batch=2, device="cpu")


FLAGSHIP_POSES = [((8.0 - f, 5.0, 8.0), (0.0, 0.5, 0.0)) for f in range(3)]


@pytest.fixture(scope="module")
def flagship():
    jscene = jax_build(jax_proc.scene_multi_torus(True))
    jst = JaxSettings.default(max_depth=3)
    return jscene, jst, scene_from_numpy(jscene), settings_from_numpy(jst)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("front", ["render_sequence", "render_frames"])
def test_spp_frames_match_jax(flagship, front, backend):
    """spp = 2 over 3 cameras with seed 3 draws the JAX front doors'
    jitter (fold_in(PRNGKey(seed), f * spp + s)): config 3's scene at
    24x16, depth 3, max |diff| < 5e-4 (tests/test_golden.py's bound)
    against the JAX package's jnp backend, ray counts exact."""
    jscene, jst, scene, st = flagship
    fns = {"render_sequence": (jax_sequence, render_sequence),
           "render_frames": (jax_frames, render_frames)}
    jfn, fn = fns[front]
    jcams = [JaxPinhole(eye=e, center=c) for e, c in FLAGSHIP_POSES]
    cams = [PinholeCamera(eye=e, center=c) for e, c in FLAGSHIP_POSES]
    ref = jfn(jscene, jcams, 24, 16, jst, spp=2, seed=3)
    out = fn(scene, cams, 24, 16, st, backend=backend, spp=2, seed=3,
             device="cpu")
    want = np.asarray(ref["images"])
    assert tuple(out["images"].shape) == want.shape
    err = float(np.abs(out["images"].numpy() - want).max())
    assert err < 5e-4, f"{front}/{backend}: max diff {err}"
    assert out["rays_traced"] == int(float(ref["rays_traced"]))
