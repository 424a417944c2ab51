"""Minimal OBJ + MTL loader: the port of the JAX package's
`scene/obj_loader.py`, returning the port's `TriangleMesh` (host NumPy
arrays, equal to the JAX loader's array for array).

Replaces the reference's tinyobjloader-based `ObjLoader`
(VKT/ray_tracing__before/hello_vulkan.cpp:190-247, via the git-ignored
`common/obj_loader.h`). Behavioral parity points:

* per-face materials via `usemtl`, default material if none
  (reference pushes a default MaterialObj when the MTL is missing)
* sRGB -> linear `pow(x, 2.2)` applied to ambient/diffuse/specular on load
  (hello_vulkan.cpp:197-202)
* vertices carry pos / normal / color / texcoord (host_device.h:109-115);
  missing normals are generated from face geometry
* textures referenced by `map_Kd` get a per-material texture id
  (`MaterialObj.textureID` analog; -1 when absent, raytrace.rchit:79)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from toroidal_ray_tracing_tpu_torch.io import native
from toroidal_ray_tracing_tpu_torch.scene.types import TriangleMesh

F32 = np.float32
I32 = np.int32


def _default_material() -> dict:
    # tinyobjloader-style defaults, matching the reference's fallback material
    return {
        "name": "default",
        "ambient": (0.1, 0.1, 0.1),
        "diffuse": (0.7, 0.7, 0.7),
        "specular": (1.0, 1.0, 1.0),
        "transmittance": (0.0, 0.0, 0.0),
        "emission": (0.0, 0.0, 0.1),
        "shininess": 0.0,
        "ior": 1.0,
        "dissolve": 1.0,
        "illum": 0,
        "texture_id": -1,
    }


def _srgb_to_linear(c):
    # hello_vulkan.cpp:197-202: pow(component, 2.2)
    return tuple(float(x) ** 2.2 for x in c)


def parse_mtl(path: str, textures: list, texture_dir: str) -> dict:
    """Parse an MTL file -> {name: material-dict}. Appends decoded textures
    (float32 HxWx3 in [0,1]) to `textures` and records their index."""
    mats: dict = {}
    cur: Optional[dict] = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = _default_material()
                cur["name"] = parts[1] if len(parts) > 1 else "unnamed"
                cur["emission"] = (0.0, 0.0, 0.0)
                mats[cur["name"]] = cur
            elif cur is None:
                continue
            elif key == "Ka":
                cur["ambient"] = tuple(map(float, parts[1:4]))
            elif key == "Kd":
                cur["diffuse"] = tuple(map(float, parts[1:4]))
            elif key == "Ks":
                cur["specular"] = tuple(map(float, parts[1:4]))
            elif key == "Kt" or key == "Tf":
                cur["transmittance"] = tuple(map(float, parts[1:4]))
            elif key == "Ke":
                cur["emission"] = tuple(map(float, parts[1:4]))
            elif key == "Ns":
                cur["shininess"] = float(parts[1])
            elif key == "Ni":
                cur["ior"] = float(parts[1])
            elif key == "d":
                cur["dissolve"] = float(parts[1])
            elif key == "Tr":
                cur["dissolve"] = 1.0 - float(parts[1])
            elif key == "illum":
                cur["illum"] = int(float(parts[1]))
            elif key == "map_Kd":
                tex_path = os.path.join(texture_dir, parts[-1])
                img = load_texture(tex_path)
                if img is not None:
                    cur["texture_id"] = len(textures)
                    textures.append(img)
    return mats


def load_texture(path: str) -> Optional[np.ndarray]:
    """Decode an image to LINEAR float32 (H, W, 3) in [0,1]. Uses PIL if
    available (replaces stb_image, hello_vulkan.cpp:320); silently returns
    None when the file is missing, unreadable or PIL is absent, like the reference's dummy-texture
    fallback. Image files are gamma-encoded and the reference samples them
    through VK_FORMAT_R8G8B8A8_SRGB (hello_vulkan.cpp:289) — i.e. the
    sampler decodes to linear — so decode here with the same gamma-2.2
    convention the loader applies to material colors. The atlas re-encodes
    at pack time (build._tex_quantize), so 8-bit sources round-trip the
    quantized atlas exactly."""
    if not os.path.exists(path):
        return None
    try:
        from PIL import Image  # noqa: PLC0415  (optional dependency)

        img = np.asarray(Image.open(path).convert("RGB"), dtype=F32) / F32(255.0)
        return img ** F32(2.2)
    except (ImportError, OSError):
        return None


def load_obj(path: str, use_native: bool = True) -> TriangleMesh:
    """Load an OBJ file into a TriangleMesh (one BLAS worth of geometry).

    Polygons are fan-triangulated. Negative OBJ indices are supported.
    Geometry parsing uses the native C++ parser (csrc/obj_loader.cpp) when
    available; MTL materials are always parsed here.
    """
    if use_native:
        data = native.obj_parse(path)
        if data is not None:
            return _assemble_native(path, data)
    return _load_obj_python(path)


def _assemble_native(path: str, data: dict) -> TriangleMesh:
    base_dir = os.path.dirname(os.path.abspath(path))
    materials: list = []
    textures: list = []
    mat_lookup: dict = {}
    if data["mtllib"]:
        mtl_path = os.path.join(base_dir, data["mtllib"])
        if os.path.exists(mtl_path):
            for name, mat in parse_mtl(mtl_path, textures, base_dir).items():
                mat_lookup[name] = len(materials)
                materials.append(mat)
    # map usemtl first-use slots -> parsed material rows
    slot_map = [mat_lookup.get(name, -1) for name in data["mtl_names"]]
    if not materials:
        materials.append(_default_material())
    mat_index = np.asarray(
        [slot_map[m] if 0 <= m < len(slot_map) else -1
         for m in data["mat_index"]], dtype=I32)
    mat_index = np.where(mat_index >= 0, mat_index, 0).astype(I32)

    for mat in materials:
        for k in ("ambient", "diffuse", "specular"):
            mat[k] = _srgb_to_linear(mat[k])

    pos = data["positions"]
    idx = data["indices"]
    nrm = data["normals"].copy()
    have = data["has_normal"]
    if not have.all() and len(idx):
        fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                      pos[idx[:, 2]] - pos[idx[:, 0]])
        for c in range(3):
            np.add.at(nrm, idx[:, c], np.where(have[idx[:, c], None], 0.0, fn))
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = (nrm / np.maximum(ln, 1e-30)).astype(F32)

    return TriangleMesh(
        positions=pos,
        normals=nrm,
        colors=np.ones_like(pos),
        uvs=data["uvs"],
        indices=idx,
        mat_index=mat_index,
        materials=materials,
        textures=textures,
    )


def _load_obj_python(path: str) -> TriangleMesh:
    """Pure-Python fallback parser."""
    positions: list = []
    normals: list = []
    uvs: list = []
    colors: list = []

    tri_indices: list = []
    tri_mats: list = []

    materials: list = []
    textures: list = []
    mat_lookup: dict = {}
    cur_mat = -1

    # corner -> packed vertex index (dedup on (pos, uv, nrm) triple)
    vert_cache: dict = {}
    packed_pos: list = []
    packed_nrm: list = []
    packed_uv: list = []
    packed_col: list = []

    base_dir = os.path.dirname(os.path.abspath(path))

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    def pack(corner: str) -> int:
        if corner in vert_cache:
            return vert_cache[corner]
        fields = corner.split("/")
        vi = resolve(int(fields[0]), len(positions))
        ti = resolve(int(fields[1]), len(uvs)) if len(fields) > 1 and fields[1] else -1
        ni = resolve(int(fields[2]), len(normals)) if len(fields) > 2 and fields[2] else -1
        packed_pos.append(positions[vi])
        packed_col.append(colors[vi] if colors else (1.0, 1.0, 1.0))
        packed_uv.append(uvs[ti] if ti >= 0 else (0.0, 0.0))
        packed_nrm.append(normals[ni] if ni >= 0 else None)
        out = len(packed_pos) - 1
        vert_cache[corner] = out
        return out

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append(tuple(map(float, parts[1:4])))
                if len(parts) >= 7:  # vertex colors extension
                    colors.append(tuple(map(float, parts[4:7])))
                else:
                    colors.append((1.0, 1.0, 1.0))
            elif key == "vn":
                normals.append(tuple(map(float, parts[1:4])))
            elif key == "vt":
                uvs.append(tuple(map(float, parts[1:3])))
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    for name, mat in parse_mtl(mtl_path, textures, base_dir).items():
                        mat_lookup[name] = len(materials)
                        materials.append(mat)
            elif key == "usemtl":
                name = " ".join(parts[1:])
                cur_mat = mat_lookup.get(name, -1)
            elif key == "f":
                corner_ids = [pack(c) for c in parts[1:]]
                for k in range(1, len(corner_ids) - 1):
                    tri_indices.append((corner_ids[0], corner_ids[k], corner_ids[k + 1]))
                    tri_mats.append(cur_mat)

    if not materials:
        materials.append(_default_material())
    tri_mats = [m if m >= 0 else 0 for m in tri_mats]

    # sRGB -> linear like the reference (hello_vulkan.cpp:197-202)
    for mat in materials:
        for k in ("ambient", "diffuse", "specular"):
            mat[k] = _srgb_to_linear(mat[k])

    pos = np.asarray(packed_pos, dtype=F32).reshape(-1, 3)
    idx = np.asarray(tri_indices, dtype=I32).reshape(-1, 3)

    # fill missing normals with area-weighted face normals
    nrm = np.zeros_like(pos)
    have = np.array([n is not None for n in packed_nrm])
    if have.any():
        nrm[have] = np.asarray([n for n in packed_nrm if n is not None], dtype=F32)
    if not have.all() and len(idx):
        fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
        for c in range(3):
            np.add.at(nrm, idx[:, c], np.where(have[idx[:, c], None], 0.0, fn))
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = (nrm / np.maximum(ln, 1e-30)).astype(F32)

    return TriangleMesh(
        positions=pos,
        normals=nrm,
        colors=np.asarray(packed_col, dtype=F32).reshape(-1, 3),
        uvs=np.asarray(packed_uv, dtype=F32).reshape(-1, 2),
        indices=idx,
        mat_index=np.asarray(tri_mats, dtype=I32),
        materials=materials,
        textures=textures,
    )
