"""Procedural mesh + scene generators.

The reference consumes nvpro `media/` OBJ files (`cube_multi.obj`,
`Medieval_building.obj`, `wuson.obj`, `sphere.obj`, `cube.obj`, `plane.obj`
— VKT/ray_tracing__before/main.cpp:200-212) that are git-ignored. These
generators provide equivalent test geometry, plus the torus meshes/primitives
needed for the BASELINE.json scenario ladder.
"""

from __future__ import annotations

import numpy as np

from toroidal_ray_tracing_tpu_torch.scene.types import SceneDef, Torus, TriangleMesh
from toroidal_ray_tracing_tpu_torch.utils import math3d

F32 = np.float32
I32 = np.int32


def _mesh(pos, nrm, uv, idx, mats, mat_index=None) -> TriangleMesh:
    pos = np.asarray(pos, F32)
    idx = np.asarray(idx, I32)
    return TriangleMesh(
        positions=pos,
        normals=np.asarray(nrm, F32),
        colors=np.ones_like(pos),
        uvs=np.asarray(uv, F32),
        indices=idx,
        mat_index=(
            np.zeros(len(idx), I32) if mat_index is None else np.asarray(mat_index, I32)
        ),
        materials=mats,
    )


def matte(diffuse=(0.7, 0.7, 0.7), ambient=None, illum=2, shininess=8.0,
          specular=(0.2, 0.2, 0.2), **kw) -> dict:
    if ambient is None:
        ambient = tuple(0.1 * c for c in diffuse)
    return dict(diffuse=diffuse, ambient=ambient, specular=specular,
                illum=illum, shininess=shininess, **kw)


def mirror(specular=(0.95, 0.95, 0.95), diffuse=(0.1, 0.1, 0.1)) -> dict:
    """Reflective material: illum 3, Ks 0.95 — the reflections tutorial's
    mirror config (VKT/ray_tracing_reflections/README.md:11-38)."""
    return dict(diffuse=diffuse, ambient=(0.01, 0.01, 0.01), specular=specular,
                illum=3, shininess=64.0)


def plane(size: float = 10.0, y: float = 0.0, material: dict | None = None) -> TriangleMesh:
    s = size
    pos = [(-s, y, -s), (s, y, -s), (s, y, s), (-s, y, s)]
    nrm = [(0, 1, 0)] * 4
    uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
    idx = [(0, 2, 1), (0, 3, 2)]
    return _mesh(pos, nrm, uv, idx, [material or matte((0.7, 0.7, 0.7))])


def cube(size: float = 1.0, materials: list | None = None, per_face_mats: bool = False) -> TriangleMesh:
    """Axis-aligned cube. With per_face_mats=True each face gets its own
    material (the `cube_multi.obj` subject analog — a multi-material cube)."""
    h = size / 2.0
    faces = [
        ((1, 0, 0), [(h, -h, -h), (h, h, -h), (h, h, h), (h, -h, h)]),
        ((-1, 0, 0), [(-h, -h, h), (-h, h, h), (-h, h, -h), (-h, -h, -h)]),
        ((0, 1, 0), [(-h, h, -h), (-h, h, h), (h, h, h), (h, h, -h)]),
        ((0, -1, 0), [(-h, -h, h), (-h, -h, -h), (h, -h, -h), (h, -h, h)]),
        ((0, 0, 1), [(h, -h, h), (h, h, h), (-h, h, h), (-h, -h, h)]),
        ((0, 0, -1), [(-h, -h, -h), (-h, h, -h), (h, h, -h), (h, -h, -h)]),
    ]
    pos, nrm, uv, idx, midx = [], [], [], [], []
    for f, (n, quad) in enumerate(faces):
        base = len(pos)
        pos += quad
        nrm += [n] * 4
        uv += [(0, 0), (0, 1), (1, 1), (1, 0)]
        idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
        midx += [f if per_face_mats else 0] * 2
    if materials is None:
        if per_face_mats:
            cols = [(0.9, 0.2, 0.2), (0.2, 0.9, 0.2), (0.2, 0.2, 0.9),
                    (0.9, 0.9, 0.2), (0.9, 0.2, 0.9), (0.2, 0.9, 0.9)]
            materials = [matte(c) for c in cols]
        else:
            materials = [matte((0.8, 0.3, 0.3))]
    return _mesh(pos, nrm, uv, idx, materials, midx)


def sphere(radius: float = 1.0, lat: int = 24, lon: int = 48, material: dict | None = None) -> TriangleMesh:
    pos, nrm, uv, idx = [], [], [], []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon + 1):
            ph = 2 * np.pi * j / lon
            n = (np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph))
            pos.append(tuple(radius * c for c in n))
            nrm.append(n)
            uv.append((j / lon, i / lat))
    for i in range(lat):
        for j in range(lon):
            a = i * (lon + 1) + j
            b = a + lon + 1
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
    return _mesh(pos, nrm, uv, idx, [material or matte((0.6, 0.6, 0.8))])


def torus_mesh(major_radius: float = 2.0, minor_radius: float = 0.6,
               seg_major: int = 64, seg_minor: int = 32,
               material: dict | None = None) -> TriangleMesh:
    """Triangulated torus, axis +y (same parameterization as the analytic
    `Torus` primitive so mesh vs analytic renders are comparable)."""
    R, r = major_radius, minor_radius
    pos, nrm, uv, idx = [], [], [], []
    for i in range(seg_major + 1):
        a = 2 * np.pi * i / seg_major
        ca, sa = np.cos(a), np.sin(a)
        for j in range(seg_minor + 1):
            b = 2 * np.pi * j / seg_minor
            cb, sb = np.cos(b), np.sin(b)
            pos.append(((R + r * cb) * ca, r * sb, (R + r * cb) * sa))
            nrm.append((cb * ca, sb, cb * sa))
            uv.append((i / seg_major, j / seg_minor))
    for i in range(seg_major):
        for j in range(seg_minor):
            a0 = i * (seg_minor + 1) + j
            b0 = a0 + seg_minor + 1
            idx += [(a0, b0, a0 + 1), (a0 + 1, b0, b0 + 1)]
    return _mesh(pos, nrm, uv, idx, [material or matte((0.8, 0.5, 0.2))])


def torus_mesh_fast(major_radius: float = 2.0, minor_radius: float = 0.6,
                    seg_major: int = 64, seg_minor: int = 32,
                    material: dict | None = None) -> TriangleMesh:
    """Vectorized torus tessellation — identical output to `torus_mesh`
    (same vertex order, same winding) but pure numpy array ops: the Python
    vertex loop is fine at config-6 scale (23k tris) but a >1M-triangle
    streamed-kernel mesh needs this (~50x faster to build)."""
    R, r = major_radius, minor_radius
    i = np.arange(seg_major + 1, dtype=np.float64)[:, None]
    j = np.arange(seg_minor + 1, dtype=np.float64)[None, :]
    a = 2 * np.pi * i / seg_major
    b = 2 * np.pi * j / seg_minor
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    shp = (seg_major + 1, seg_minor + 1)
    ring = R + r * cb                                    # (1, J)
    pos = np.stack([np.broadcast_to(ring * ca, shp),
                    np.broadcast_to(r * sb, shp),
                    np.broadcast_to(ring * sa, shp)], axis=-1).reshape(-1, 3)
    nrm = np.stack([np.broadcast_to(cb * ca, shp),
                    np.broadcast_to(sb, shp),
                    np.broadcast_to(cb * sa, shp)], axis=-1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(i / seg_major, j / seg_minor),
                  axis=-1).reshape(-1, 2)
    ii = np.arange(seg_major)[:, None]
    jj = np.arange(seg_minor)[None, :]
    a0 = (ii * (seg_minor + 1) + jj).reshape(-1)
    b0 = a0 + seg_minor + 1
    idx = np.stack([np.stack([a0, b0, a0 + 1], axis=1),
                    np.stack([a0 + 1, b0, b0 + 1], axis=1)],
                   axis=1).reshape(-1, 3)
    return _mesh(pos, nrm, uv, idx, [material or matte((0.8, 0.5, 0.2))])


# ---------------------------------------------------------------------------
# Canonical scenes (BASELINE.json scenario ladder + reference-style scenes)
# ---------------------------------------------------------------------------


def scene_single_torus(analytic: bool = True) -> SceneDef:
    """Config 1: single torus, flat-ish shading."""
    s = SceneDef()
    if analytic:
        s.add_model(Torus(2.0, 0.6, [matte((0.8, 0.4, 0.2), illum=1)]))
    else:
        s.add_model(torus_mesh(2.0, 0.6, material=matte((0.8, 0.4, 0.2), illum=1)))
    return s


def scene_torus_plane(analytic: bool = True) -> SceneDef:
    """Config 2: torus + ground plane, Lambertian + hard shadows
    (the ray_tracing__before scene shape)."""
    s = SceneDef()
    tor_mat = matte((0.8, 0.45, 0.15), illum=1, specular=(0.0, 0.0, 0.0))
    if analytic:
        s.add_model(Torus(2.0, 0.6, [tor_mat]),
                    math3d.translation((0.0, 0.6, 0.0)))
    else:
        s.add_model(torus_mesh(2.0, 0.6, material=tor_mat),
                    math3d.translation((0.0, 0.6, 0.0)))
    s.add_model(plane(12.0, material=matte((0.7, 0.7, 0.7), illum=1,
                                           specular=(0.0, 0.0, 0.0))))
    return s


def scene_multi_torus(analytic: bool = True) -> SceneDef:
    """Config 3: multi-torus with specular reflections, 3 bounces
    (the ray_tracing_reflections scene shape: mirrors + subjects,
    VKT/ray_tracing_reflections/README.md:11-38)."""
    s = SceneDef()
    mk = (lambda R, r, m: Torus(R, r, [m])) if analytic else (
        lambda R, r, m: torus_mesh(R, r, material=m))
    s.add_model(mk(1.6, 0.5, mirror()), math3d.translation((0.0, 0.8, 0.0)))
    s.add_model(mk(1.2, 0.4, matte((0.9, 0.25, 0.2))),
                math3d.compose(math3d.translation((-3.5, 0.6, 1.5)),
                               math3d.rotation_x(90.0)))
    s.add_model(mk(1.0, 0.35, matte((0.2, 0.4, 0.9))),
                math3d.compose(math3d.translation((3.2, 0.5, -1.0)),
                               math3d.rotation_z(90.0)))
    s.add_model(mk(0.8, 0.3, mirror((0.7, 0.8, 0.9))),
                math3d.translation((1.5, 0.4, 3.0)))
    s.add_model(plane(14.0, material=mirror((0.6, 0.6, 0.6), (0.25, 0.25, 0.28))))
    return s


def scene_instanced_torus_grid(n: int = 1024, analytic: bool = True,
                               seed: int = 0) -> SceneDef:
    """Config 4: ~1k-instance torus grid exercising TLAS-style culling."""
    s = SceneDef()
    rng = np.random.default_rng(seed)
    side = int(round(n ** 0.5))
    tor = Torus(0.35, 0.12, [matte((0.8, 0.5, 0.2))]) if analytic else torus_mesh(
        0.35, 0.12, seg_major=16, seg_minor=8, material=matte((0.8, 0.5, 0.2)))
    base = s.add_model(tor, math3d.translation((0.0, 0.15, 0.0)))
    count = 1
    for i in range(side):
        for j in range(side):
            if count >= n:
                break
            x = (i - side / 2) * 1.2
            z = (j - side / 2) * 1.2
            rot = math3d.rotation_y(float(rng.uniform(0, 360)))
            s.add_instance(base, math3d.compose(
                math3d.translation((x, 0.15, z)), rot))
            count += 1
    s.add_model(plane(side * 0.8, material=matte((0.6, 0.6, 0.65), illum=1,
                                                 specular=(0.0, 0.0, 0.0))))
    return s


def checker_texture(n: int = 128, cells: int = 16,
                    c0=(0.2, 0.25, 0.35), c1=(0.92, 0.87, 0.78)) -> np.ndarray:
    """(n, n, 3) f32 two-colour checkerboard — procedural stand-in for the
    nvpro media textures the reference's OBJ materials reference via map_Kd."""
    y, x = np.mgrid[0:n, 0:n]
    m = (((x * cells // n) + (y * cells // n)) % 2).astype(F32)[..., None]
    return (np.asarray(c0, F32) * (1.0 - m) + np.asarray(c1, F32) * m)


def scene_textured_mesh() -> SceneDef:
    """Config 7: textured triangle workload — every primary hit samples the
    mip atlas (the reference's OBJ models are all textured via map_Kd, e.g.
    media/scenes/Medieval_building.mtl; sampling at raytrace.rchit:79-84).
    A textured tessellated torus over a 20x-tiled checkered floor, with one
    mirror torus so bounce rays hit textured geometry too."""
    s = SceneDef()
    tor = torus_mesh(1.6, 0.5, material=matte((1.0, 1.0, 1.0), illum=1,
                                              specular=(0.0, 0.0, 0.0),
                                              texture_id=0))
    tor.textures = [checker_texture(256, 32)]
    s.add_model(tor, math3d.translation((-1.8, 0.6, 0.6)))
    s.add_model(Torus(1.0, 0.35, [mirror()]),
                math3d.translation((2.2, 0.5, -0.8)))
    floor = plane(14.0, material=matte((1.0, 1.0, 1.0), illum=1,
                                       specular=(0.0, 0.0, 0.0),
                                       texture_id=0))
    floor.uvs = floor.uvs * 20.0
    floor.textures = [checker_texture(128, 8, (0.45, 0.42, 0.4),
                                      (0.75, 0.73, 0.7))]
    s.add_model(floor)
    return s


def scene_hires_mesh(seg: int = 768) -> SceneDef:
    """Config 8: a >1M-triangle tessellated torus (2*seg*seg tris; the
    default 768 gives 1,179,648) over a matte floor — the HBM-streamed
    triangle kernel's ladder row (ops/tri_stream.py: tables past the
    ~16 MB scoped-VMEM budget stream through double-buffered DMA). The
    BLAS scale the reference delegates to the driver
    (hello_vulkan.cpp:602-663)."""
    s = SceneDef()
    s.add_model(torus_mesh_fast(1.6, 0.55, seg_major=seg, seg_minor=seg,
                                material=matte((0.75, 0.55, 0.25))),
                math3d.translation((0.0, 0.7, 0.0)))
    s.add_model(plane(10.0, material=matte((0.6, 0.6, 0.65), illum=1,
                                           specular=(0.0, 0.0, 0.0))))
    return s


def scene_cornellish() -> SceneDef:
    """Reference-style triangle scene: multi-material cube subject + plane +
    sphere + mirror cube (stands in for the nvpro media scene at
    VKT/ray_tracing__before/main.cpp:200-212)."""
    s = SceneDef()
    s.add_model(cube(1.0, per_face_mats=True), math3d.translation((0.0, 0.5, 0.0)))
    s.add_model(plane(10.0))
    s.add_model(sphere(0.8, material=matte((0.3, 0.7, 0.4))),
                math3d.translation((2.5, 0.8, -1.5)))
    s.add_model(cube(1.4, materials=[mirror()]), math3d.translation((-2.5, 0.7, 1.0)))
    return s
