"""The port's OBJ + MTL loader, its native OBJ binding and its host BVH
against the JAX package's: every array bit-equal, through the native parser
and the Python one, and the scene built from a loaded mesh bit-equal to the
JAX build."""

import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_build import _assert_same_scene
from toroidal_ray_tracing_tpu.geom.bvh import build_bvh as jax_build_bvh
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene.obj_loader import load_obj as jax_load_obj
from toroidal_ray_tracing_tpu.scene.types import SceneDef as JaxSceneDef
from toroidal_ray_tracing_tpu_torch.geom.bvh import build_bvh
from toroidal_ray_tracing_tpu_torch.io import native
from toroidal_ray_tracing_tpu_torch.scene import SceneDef, build_scene
from toroidal_ray_tracing_tpu_torch.scene import obj_loader
from toroidal_ray_tracing_tpu_torch.utils import math3d

torch.set_num_threads(2)

# tests/test_obj_loader.py's OBJ and MTL, plus a 4x4 map_Kd texture on "red"
OBJ = """\
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
usemtl red
f 1/1/1 2/2/1 3/3/1
usemtl blue
f 1/1/1 3/3/1 4//1
f 1 2 3 4
f -5 -4 -3
"""

MTL = """\
newmtl red
Kd 1 0 0
Ka 0.1 0 0
Ks 0.5 0.5 0.5
Ns 32
illum 2
map_Kd tex.png
newmtl blue
Kd 0 0 1
illum 3
"""

MESH_FIELDS = ("positions", "normals", "colors", "uvs", "indices",
               "mat_index")


@pytest.fixture
def obj_path(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(MTL)
    tex = np.random.default_rng(0).integers(0, 256, (4, 4, 3), np.uint8)
    Image.fromarray(tex).save(tmp_path / "tex.png")
    return str(tmp_path / "test.obj")


def _assert_same_mesh(port, ref):
    for f in MESH_FIELDS:
        a, r = getattr(port, f), getattr(ref, f)
        assert a.dtype == r.dtype and a.shape == r.shape, f
        assert a.tobytes() == r.tobytes(), f"{f} differs"
    assert port.materials == ref.materials
    assert len(port.textures) == len(ref.textures) == 1
    for a, r in zip(port.textures, ref.textures):
        assert a.dtype == r.dtype and a.tobytes() == r.tobytes()


@pytest.mark.parametrize("use_native", [True, False])
def test_load_obj_bit_equal(obj_path, use_native):
    if use_native:
        assert native.available()
    port = obj_loader.load_obj(obj_path, use_native=use_native)
    ref = jax_load_obj(obj_path, use_native=use_native)
    _assert_same_mesh(port, ref)
    assert port.num_triangles == 5


def test_native_parse_matches_python_triangles(obj_path):
    """Both parsers give the same triangles (the packing order may
    differ), materials per triangle, and texture."""
    a = obj_loader.load_obj(obj_path, use_native=True)
    b = obj_loader._load_obj_python(obj_path)
    np.testing.assert_array_equal(a.positions[a.indices],
                                  b.positions[b.indices])
    np.testing.assert_array_equal(a.mat_index, b.mat_index)
    assert a.materials == b.materials


@pytest.mark.parametrize("use_native", [True, False])
def test_build_of_loaded_mesh_bit_equal(obj_path, use_native):
    """build_scene of a SceneDef holding the loaded mesh (two instances,
    one moved) equals the JAX build leaf for leaf, texture atlas too."""
    xf = math3d.compose(math3d.translation((0.5, -1.0, 2.0)),
                        math3d.rotation_y(30.0))
    sd, jsd = SceneDef(), JaxSceneDef()
    for d, load in ((sd, obj_loader.load_obj), (jsd, jax_load_obj)):
        mesh = load(obj_path, use_native=use_native)
        d.add_model(mesh)
        d.add_instance(0, xf)
    _assert_same_scene(build_scene(sd), jax_build(jsd))


def test_load_texture_without_pil(obj_path, monkeypatch):
    """Without PIL the texture is skipped (None), as in the reference."""
    png = obj_path.replace("test.obj", "tex.png")
    assert obj_loader.load_texture(png).shape == (4, 4, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert obj_loader.load_texture(png) is None
    mesh = obj_loader.load_obj(obj_path)
    assert mesh.textures == []
    assert all(m["texture_id"] == -1 for m in mesh.materials)


def test_native_obj_parse_threads(tmp_path):
    """The C parser keeps its result in one global: parses on many threads
    at once (the binding holds its lock from parse to free) each return
    their own file's geometry."""
    paths = []
    for k in range(2):
        body = "".join(f"v {i} {k} {i * k}\n" for i in range(3 + 40 * k))
        body += "".join(f"f 1 {i + 2} {i + 3}\n" for i in range(1 + 40 * k))
        p = tmp_path / f"m{k}.obj"
        p.write_text(body)
        paths.append(str(p))
    want = [native.obj_parse(p) for p in paths]
    bad = []

    def work(k):
        for _ in range(30):
            got = native.obj_parse(paths[k % 2])
            for f in ("positions", "indices"):
                if not np.array_equal(got[f], want[k % 2][f]):
                    bad.append((k, f))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:4]


@pytest.mark.parametrize("n,leaf", [(0, 4), (1, 4), (7, 2), (300, 4)])
def test_build_bvh_bit_equal(n, leaf):
    rng = np.random.default_rng(n)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    port = build_bvh(lo, hi, leaf_size=leaf)
    ref = jax_build_bvh(lo, hi, leaf_size=leaf)
    assert port._fields == ref._fields
    for f in ref._fields:
        a, r = getattr(port, f), getattr(ref, f)
        assert a.dtype == r.dtype and a.shape == r.shape, f
        assert a.tobytes() == r.tobytes(), f
