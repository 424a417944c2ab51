"""Host-side 3D math: replaces the reference's `nvmath` + `nvh::CameraManipulator`.

Everything here runs on the host in float32 NumPy (these are tiny per-frame
matrices — reference: VKT/ray_tracing__before/hello_vulkan.cpp:58-100 builds
them on the CPU each frame too). Device-side vector helpers live in the trace
modules and use torch.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=F32)
    n = np.linalg.norm(v).astype(F32)
    return (v / n).astype(F32)


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (world -> camera), camera looks down -z.

    Clone of the `nvh::CameraManipulator` view matrix used at
    VKT/ray_tracing__before/hello_vulkan.cpp:63 (`CameraManip.getMatrix()`).
    Returns a 4x4 float32 matrix (``p_cam = M @ p_world``).
    """
    eye = np.asarray(eye, dtype=F32)
    center = np.asarray(center, dtype=F32)
    up = np.asarray(up, dtype=F32)
    f = normalize(center - eye)          # forward
    s = normalize(np.cross(f, up))       # right
    u = np.cross(s, f).astype(F32)       # true up
    m = np.eye(4, dtype=F32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_vk(fovy_deg: float, aspect: float, near: float = 0.1, far: float = 1000.0) -> np.ndarray:
    """Vulkan-convention perspective projection (clone of `nvmath::perspectiveVK`
    as used at VKT/ray_tracing__before/hello_vulkan.cpp:66: fov, aspect,
    near 0.1, far 1000). Vulkan clip space: y points down, depth in [0, 1].
    """
    t = np.tan(np.radians(F32(fovy_deg)) / F32(2.0)).astype(F32)
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = F32(1.0) / (t * F32(aspect))
    m[1, 1] = -(F32(1.0) / t)           # Vulkan y-down
    m[2, 2] = F32(far) / (F32(near) - F32(far))
    m[2, 3] = (F32(far) * F32(near)) / (F32(near) - F32(far))
    m[3, 2] = F32(-1.0)
    return m


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=np.float64)).astype(F32)


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=F32)
    m[:3, 3] = np.asarray(t, dtype=F32)
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, dtype=F32), (3,))
    m = np.eye(4, dtype=F32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_y(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    m = np.eye(4, dtype=F32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotation_x(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    m = np.eye(4, dtype=F32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotation_z(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    m = np.eye(4, dtype=F32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def compose(*mats: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=F32)
    for m in mats:
        out = (out @ np.asarray(m, dtype=F32)).astype(F32)
    return out


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to an (N,3) array of points."""
    pts = np.asarray(pts, dtype=F32)
    return (pts @ m[:3, :3].T + m[:3, 3]).astype(F32)


def transform_vectors(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    vecs = np.asarray(vecs, dtype=F32)
    return (vecs @ m[:3, :3].T).astype(F32)


def transform_normals(m: np.ndarray, nrms: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse-transpose (the reference uses
    ``nrm * gl_WorldToObjectEXT``, raytrace.rchit:54, which is the same
    thing)."""
    inv = inverse(m)
    n = np.asarray(nrms, dtype=F32) @ inv[:3, :3]
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, F32(1e-30))).astype(F32)
