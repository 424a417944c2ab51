"""A configuration's scene as plain arrays, made from its file's data.

Both sides take these: the harness hands them to the program through its
public scene types (`frontdoor.scene_def`), and the reference flattens them
into world space itself (`reference.scene`). Nothing here imports the
program. A model is one of

* `torus_mesh`: a tessellated torus, axis +y, `major`, `minor`,
  `seg_major` x `seg_minor` quads of two triangles (vertex order and
  winding of the program's `procedural.torus_mesh`);
* `plane`: a square of half-size `size` at height `y`, two triangles;
* `torus`: an analytic torus, axis +y, `major`, `minor`;

each with one `material` (WaveFront fields) and a `transform`, a list of
[op, argument] steps composed left to right (`translate` [x, y, z],
`rotate_x` / `rotate_y` / `rotate_z` degrees).
"""

from __future__ import annotations

import dataclasses

import numpy as np

F32 = np.float32
I32 = np.int32

MATERIAL_FIELDS = ("ambient", "diffuse", "specular", "shininess", "illum")


@dataclasses.dataclass
class Model:
    kind: str                 # "mesh" or "torus"
    transform: np.ndarray     # (4, 4) float32, object -> world
    material: dict
    positions: np.ndarray | None = None   # mesh: (V, 3) float32
    normals: np.ndarray | None = None     # mesh: (V, 3) float32
    uvs: np.ndarray | None = None         # mesh: (V, 2) float32
    indices: np.ndarray | None = None     # mesh: (T, 3) int32
    major: float = 0.0                    # torus radii
    minor: float = 0.0


def _rotation(axis: int, deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    a, b = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(4, dtype=F32)
    m[a, a], m[a, b], m[b, a], m[b, b] = c, -s, s, c
    return m


def transform(steps) -> np.ndarray:
    """The (4, 4) float32 product of the steps, left to right, each
    product rounded to float32 (as the program's `math3d.compose`)."""
    out = np.eye(4, dtype=F32)
    for op, arg in steps:
        if op == "translate":
            m = np.eye(4, dtype=F32)
            m[:3, 3] = np.asarray(arg, dtype=F32)
        elif op in ("rotate_x", "rotate_y", "rotate_z"):
            m = _rotation("xyz".index(op[-1]), float(arg))
        else:
            raise ValueError(f"unknown transform step {op!r}")
        out = (out @ m).astype(F32)
    return out


def torus_mesh(major, minor, seg_major, seg_minor):
    """(positions, normals, uvs, indices) of a tessellated torus."""
    R, r = major, minor
    i = np.arange(seg_major + 1, dtype=np.float64)[:, None]
    j = np.arange(seg_minor + 1, dtype=np.float64)[None, :]
    a = 2 * np.pi * i / seg_major
    b = 2 * np.pi * j / seg_minor
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    shp = (seg_major + 1, seg_minor + 1)
    ring = R + r * cb
    pos = np.stack([np.broadcast_to(ring * ca, shp),
                    np.broadcast_to(r * sb, shp),
                    np.broadcast_to(ring * sa, shp)], axis=-1)
    nrm = np.stack([np.broadcast_to(cb * ca, shp), np.broadcast_to(sb, shp),
                    np.broadcast_to(cb * sa, shp)], axis=-1)
    uv = np.stack(np.broadcast_arrays(i / seg_major, j / seg_minor), axis=-1)
    ii = np.arange(seg_major)[:, None]
    jj = np.arange(seg_minor)[None, :]
    a0 = (ii * (seg_minor + 1) + jj).reshape(-1)
    b0 = a0 + seg_minor + 1
    idx = np.stack([np.stack([a0, b0, a0 + 1], axis=1),
                    np.stack([a0 + 1, b0, b0 + 1], axis=1)],
                   axis=1).reshape(-1, 3)
    return (pos.reshape(-1, 3).astype(F32), nrm.reshape(-1, 3).astype(F32),
            uv.reshape(-1, 2).astype(F32), idx.astype(I32))


def plane(size, y):
    s = size
    pos = np.asarray([(-s, y, -s), (s, y, -s), (s, y, s), (-s, y, s)], F32)
    nrm = np.asarray([(0, 1, 0)] * 4, F32)
    uv = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], F32)
    idx = np.asarray([(0, 2, 1), (0, 3, 2)], I32)
    return pos, nrm, uv, idx


def material(fields: dict) -> dict:
    """The WaveFront fields of a material, each present."""
    missing = [k for k in MATERIAL_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"material lacks {missing}")
    return {"ambient": tuple(map(float, fields["ambient"])),
            "diffuse": tuple(map(float, fields["diffuse"])),
            "specular": tuple(map(float, fields["specular"])),
            "shininess": float(fields["shininess"]),
            "illum": int(fields["illum"])}


def models(scene: dict) -> list:
    """The config's `scene` entry as a list of `Model`s."""
    out = []
    for m in scene["models"]:
        xf = transform(m.get("transform", []))
        mat = material(m["material"])
        if m["type"] == "torus":
            out.append(Model("torus", xf, mat, major=float(m["major"]),
                             minor=float(m["minor"])))
            continue
        if m["type"] == "torus_mesh":
            arrays = torus_mesh(m["major"], m["minor"], m["seg_major"],
                                m["seg_minor"])
        elif m["type"] == "plane":
            arrays = plane(m["size"], m.get("y", 0.0))
        else:
            raise ValueError(f"unknown model type {m['type']!r}")
        pos, nrm, uv, idx = arrays
        out.append(Model("mesh", xf, mat, positions=pos, normals=nrm, uvs=uv,
                         indices=idx))
    return out
