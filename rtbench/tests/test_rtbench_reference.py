"""The plain reference against the program's plain backend
(`backend="torch"`) at tiny sizes on the CPU: the same rays, the same
jitter draw, and all but silhouette pixels alike."""

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import frontdoor, manifest, scenedata
from rtbench.reference import raygen, render_pixels
from rtbench.reference import scene as ref_scene

W, H = 32, 18


def config(name, seg=None):
    cfg = manifest.config(name)
    if seg:
        for m in cfg["scene"]["models"]:
            if m["type"] == "torus_mesh":
                m["seg_major"], m["seg_minor"] = seg
    return dict(cfg, width=W, height=H)


@pytest.mark.parametrize("name, cam, rho", [
    ("flythrough4k", {"type": "pinhole", "eye": (10.0, 5.0, 0.0),
                      "center": (0.0, 0.5, 0.0)}, 0.0),
    ("capture", {"type": "toroidal", "eye": (0.0, 1.5, 0.0),
                 "center": (8.0, 0.0, 0.0)}, 6.5),
    ("capture", {"type": "pinhole", "eye": (8.0, 5.0, 8.0),
                 "center": (0.0, 0.5, 0.0)}, 4.0)])
def test_reference_matches_the_plain_backend(name, cam, rho):
    cfg = config(name, seg=(16, 8))
    port = frontdoor.Port(cfg, "cpu")
    st = dataclasses.replace(port.settings, rho=rho)
    out = port.renderer.render(port.scene, frontdoor.camera(cam), W, H, st,
                               backend="torch", spp=cfg["spp"], seed=9,
                               device="cpu")
    tables = ref_scene.tables(scenedata.models(cfg["scene"]), "cpu")
    ys, xs = np.divmod(np.arange(W * H), W)
    ref = render_pixels(tables, cam, rho, W, H,
                        dict(cfg["settings"], max_depth=cfg["max_depth"]),
                        xs, ys, cfg["spp"], 9, 0)
    for k in ("ray_origin", "ray_dir"):
        assert torch.equal(out[k].reshape(-1, 3), ref[k]), k
    img = (out["image"].reshape(-1, 3) - ref["image"]).abs().amax(-1)
    hit = (out["hit_position"].reshape(-1, 3) - ref["hit_position"]).norm(
        dim=-1)
    # silhouette and grazing-mirror pixels may take another surface
    assert float((img > 1e-3).float().mean()) <= 0.01
    assert float((hit > 1e-3).float().mean()) <= 0.01
    assert float(img[img <= 1e-3].pow(2).mean().sqrt()) < 1e-5


def test_the_jitter_draw_is_the_programs():
    from toroidal_ray_tracing_tpu_torch.utils import prng

    key = prng.fold_in(prng.prng_key(2**31 + 5), 1)
    n = 96 * 54
    want = prng.uniform(key, (n, 2), "cpu")
    idx = torch.tensor([0, 1, 77, n - 1])
    assert raygen.fold_in(raygen.prng_key(2**31 + 5), 1) == key
    assert torch.equal(raygen.uniform_at(key, idx), want[idx])


def test_trace_order_is_the_programs():
    from toroidal_ray_tracing_tpu_torch.ops.front_kernel import pixel_coords
    from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block

    for w, h in ((48, 27), (1920, 1080), (35, 7)):
        b = pick_block(w, h)
        assert raygen.block_size(w, h) == b
        px, py = pixel_coords(w, h, b)
        idx = raygen.trace_index(px.long(), py.long(), w, h)
        assert torch.equal(idx, torch.arange(w * h))


def test_the_config_scenes_are_the_ladders():
    """The capture's and the fly-through's scenes, built by the program from
    the config data, equal its procedural configs 6 and 3."""
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.scene.build import build_scene

    for name, num in (("capture", 6), ("flythrough4k", 3)):
        got = build_scene(frontdoor.scene_def(scenedata.models(
            manifest.config(name)["scene"])), use_native=False)
        want = build_scene(SCENARIOS[num].scene(), use_native=False)
        for part in ("triangles", "tori", "materials"):
            a, b = getattr(got, part), getattr(want, part)
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                    (name, part, f.name)
