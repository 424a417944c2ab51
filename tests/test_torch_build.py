"""The PyTorch port's host scene build against the JAX package's build:
every array bit-equal, on the ladder scenes and the textured atlas."""

import dataclasses

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch.scene import build_scene, procedural
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy

torch.set_num_threads(2)

SCENES = {
    "multi_torus_analytic": lambda p: p.scene_multi_torus(True),
    "multi_torus_mesh": lambda p: p.scene_multi_torus(False),   # 23k tris
    "cornellish": lambda p: p.scene_cornellish(),
    "torus_plane": lambda p: p.scene_torus_plane(True),
    "instanced_128": lambda p: p.scene_instanced_torus_grid(n=128),
    "textured": lambda p: p.scene_textured_mesh(),
}


def _port_leaves(obj, prefix=""):
    """{dotted path: numpy array} of a port Scene (atlas words as uint32)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(_port_leaves(v, path + "."))
        elif isinstance(v, torch.Tensor):
            a = v.numpy()
            out[path] = a.view(np.uint32) if path == "textures.data4q" else a
    return out


def _ref_leaf(scene, path):
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return np.asarray(obj)


def _assert_same_scene(port, ref):
    leaves = _port_leaves(port)
    assert len(leaves) == 10 + 17 + 9 + 4 + 2
    for path, a in leaves.items():
        r = _ref_leaf(ref, path)
        assert a.dtype == r.dtype and a.shape == r.shape, path
        assert a.tobytes() == r.tobytes(), f"{path} differs"
    assert port.cluster_size == ref.cluster_size
    assert port.loose_tris == ref.loose_tris


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bit_equal(name):
    port = build_scene(SCENES[name](procedural))
    ref = jax_build(SCENES[name](jax_proc))
    _assert_same_scene(port, ref)


def test_build_morton_fallback_bit_equal():
    """Without the native SAH builder both builds Morton-chunk alike."""
    port = build_scene(procedural.scene_cornellish(), use_native=False)
    ref = jax_build(jax_proc.scene_cornellish(), use_native=False)
    _assert_same_scene(port, ref)


@pytest.mark.parametrize("name", ["cornellish", "textured"])
def test_scene_from_numpy_equals_port_build(name):
    """State carried across from the JAX scene equals the port's build."""
    port = build_scene(SCENES[name](procedural))
    carried = scene_from_numpy(jax_build(SCENES[name](jax_proc)))
    a, b = _port_leaves(port), _port_leaves(carried)
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].tobytes() == b[path].tobytes(), path
    assert (carried.cluster_size, carried.loose_tris) == \
        (port.cluster_size, port.loose_tris)


def test_scene_to_moves_every_tensor():
    scene = build_scene(procedural.scene_torus_plane(True))
    moved = scene.to("cpu")
    assert moved.cluster_size == scene.cluster_size
    for path, a in _port_leaves(moved).items():
        assert a.dtype in (np.float32, np.int32, np.uint32, np.bool_), path
