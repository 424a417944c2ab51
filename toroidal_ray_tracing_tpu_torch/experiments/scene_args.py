"""Shared experiment-CLI scene selection: procedural scenes or OBJ lists
(the port of the JAX package's `experiments/scene_args.py`).

The reference's whole experiment runs over OBJ scene lists — `loadModel`
calls with per-model transforms (VKT/ray_tracing__before/main.cpp:200-212:
`cube_multi.obj` as the subject plus scene models), selected by commenting
lines in and out. Here that becomes a repeatable `--obj PATH[@SPEC]` flag
usable by every experiment script (rho_sweep, gtruth), alongside the named
procedural scenes:

    --obj media/cube_multi.obj \
    --obj media/plane.obj@0,-1,0 \
    --obj media/Medieval_building.obj@2,0,-3,0.5,45

SPEC = x,y,z[,scale[,ry_degrees]] — a translation, optional uniform scale
and optional rotation about +y, composed T @ R @ S exactly like the
reference's per-model `ObjInstance` transforms. The FIRST --obj is
instance 0, the subject (`updateSubjectPosition` pins instance 0 to the
camera eye — hello_vulkan.cpp:963-986), so --subject-follow works for OBJ
scenes the same way it does for procedural ones.
"""

from __future__ import annotations

import numpy as np

from toroidal_ray_tracing_tpu_torch.scene import procedural
from toroidal_ray_tracing_tpu_torch.scene.obj_loader import load_obj
from toroidal_ray_tracing_tpu_torch.scene.types import SceneDef
from toroidal_ray_tracing_tpu_torch.utils import math3d

PROCEDURAL = {
    "cornellish": procedural.scene_cornellish,
    "torus_plane": procedural.scene_torus_plane,
    "multi_torus": procedural.scene_multi_torus,
    "single_torus": procedural.scene_single_torus,
    "instanced_grid": procedural.scene_instanced_torus_grid,
    "textured": procedural.scene_textured_mesh,
}


def add_scene_args(ap) -> None:
    ap.add_argument("--scene", default="cornellish",
                    choices=sorted(PROCEDURAL),
                    help="procedural scene (ignored when --obj is given)")
    ap.add_argument("--obj", action="append", default=None,
                    metavar="PATH[@x,y,z[,scale[,ry]]]",
                    help="load an OBJ model (repeatable; first = subject "
                         "instance 0, mirroring the reference's scene "
                         "list, main.cpp:200-212)")


def parse_obj_spec(spec: str):
    """PATH[@x,y,z[,scale[,ry_deg]]] -> (path, 4x4 transform)."""
    if "@" not in spec:
        return spec, np.eye(4, dtype=np.float32)
    path, rest = spec.rsplit("@", 1)
    parts = [float(p) for p in rest.split(",")]
    if len(parts) not in (3, 4, 5):
        raise ValueError(
            f"bad --obj transform '{rest}': want x,y,z[,scale[,ry_deg]]")
    xf = math3d.translation(tuple(parts[:3]))
    if len(parts) >= 5 and parts[4] != 0.0:
        xf = math3d.compose(xf, math3d.rotation_y(parts[4]))
    if len(parts) >= 4 and parts[3] != 1.0:
        s = parts[3]
        xf = math3d.compose(xf, np.diag([s, s, s, 1.0]).astype(np.float32))
    return path, xf


def scene_def_from_args(args) -> SceneDef:
    """SceneDef from parsed CLI args: --obj list if given, else --scene."""
    objs = getattr(args, "obj", None)
    if objs:
        s = SceneDef()
        for spec in objs:
            path, xf = parse_obj_spec(spec)
            s.add_model(load_obj(path), xf)
        return s
    return PROCEDURAL[args.scene]()
