"""The port's `refit_instance` (the per-frame subject-follow TLAS refit,
updateSubjectPosition, VKT/ray_tracing__before/hello_vulkan.cpp:963-986)
against the JAX package's, on tests/test_refit.py's two scenes: the refit
arrays bit-equal, the input untouched, the kernel tables emptied, and a
kernel-backend render of the refit scene equal (RMSE < 1e-5) to one of a
fresh build."""

import numpy as np
import pytest
import torch

from test_torch_build import _assert_same_scene, _port_leaves
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu.scene.build import refit_instance as jax_refit
from toroidal_ray_tracing_tpu.scene.types import SceneDef as JaxSceneDef
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, SceneDef,
                                                  build_scene, procedural)
from toroidal_ray_tracing_tpu_torch.scene.build import refit_instance
from toroidal_ray_tracing_tpu_torch.utils import math3d

torch.set_num_threads(2)

RES = 24


def _translated(p, SD, at):
    """tests/test_refit.py's `_scene`: subject cube at `at` (instance 0),
    a floor, and a torus."""
    sd = SD()
    sd.add_model(p.cube(1.0, per_face_mats=True),
                 transform=math3d.translation(at))
    sd.add_model(p.plane(8.0, y=-1.0))
    sd.models.append(p.Torus(1.5, 0.4, [p.matte((0.2, 0.4, 0.8))]))
    sd.add_instance(2, np.eye(4, dtype=np.float32))
    return sd


def _rotated(p, SD, xf):
    """tests/test_refit.py's rotation case: a cube, and a torus instance
    (slot 1) that the refit moves."""
    sd = SD()
    sd.add_model(p.cube(1.0))
    sd.models.append(p.Torus(1.2, 0.3, [p.matte((0.8, 0.3, 0.2))]))
    sd.add_instance(1, xf)
    return sd


XF_MOVED = math3d.translation((1.5, 0.5, -1.0))
XF_ROT = (math3d.translation((0.5, 0.2, 0.0))
          @ math3d.rotation_y(0.7)).astype(np.float32)
# name: (scene function, instance, old transform, new transform, depth,
#        camera eye)
CASES = {
    "translation": (lambda p, SD, xf: _translated(p, SD, xf[:3, 3]), 0,
                    np.eye(4, dtype=np.float32), XF_MOVED, 2,
                    (6.0, 4.0, 6.0)),
    "rotation_torus": (_rotated, 1, np.eye(4, dtype=np.float32), XF_ROT, 1,
                       (5.0, 3.0, 5.0)),
}


def _refit_pair(name):
    make, inst, xf1, xf2, _, _ = CASES[name]
    port = build_scene(make(procedural, SceneDef, xf1))
    ref = jax_build(make(jax_proc, JaxSceneDef, xf1))
    return port, refit_instance(port, inst, xf1, xf2), jax_refit(
        ref, inst, xf1, xf2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_refit_bit_equal(name):
    _, port, ref = _refit_pair(name)
    _assert_same_scene(port, ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_refit_leaves_input_unchanged(name):
    make, inst, xf1, xf2, _, _ = CASES[name]
    scene = build_scene(make(procedural, SceneDef, xf1))
    before = {k: v.copy() for k, v in _port_leaves(scene).items()}
    refit = refit_instance(scene, inst, xf1, xf2)
    after = _port_leaves(scene)
    for k, v in before.items():
        assert v.tobytes() == after[k].tobytes(), k
    moved = _port_leaves(refit)
    assert any(moved[k].tobytes() != v.tobytes() for k, v in before.items())


@pytest.mark.parametrize("name", sorted(CASES))
def test_refit_render_matches_fresh_build(name):
    """The kernel backend keeps per-scene tables (trees, Woop rows, boxes)
    in `kernel_tables`; a refit scene must start without them, so its
    render equals a fresh build's."""
    make, inst, xf1, xf2, depth, eye = CASES[name]
    cam = PinholeCamera(eye=eye)
    st = RenderSettings.default(max_depth=depth)
    scene = build_scene(make(procedural, SceneDef, xf1))
    before = render(scene, cam, RES, RES, st, backend="kernel",
                    device="cpu")["image"]
    assert scene.kernel_tables
    refit = refit_instance(scene, inst, xf1, xf2)
    assert refit.kernel_tables == {}
    assert scene.kernel_tables
    fresh = build_scene(make(procedural, SceneDef, xf2))
    a = render(refit, cam, RES, RES, st, backend="kernel",
               device="cpu")["image"]
    b = render(fresh, cam, RES, RES, st, backend="kernel",
               device="cpu")["image"]
    rmse = float((a - b).pow(2).mean().sqrt())
    assert rmse < 1e-5, rmse
    assert float((a - before).abs().max()) > 0.01   # it moved
