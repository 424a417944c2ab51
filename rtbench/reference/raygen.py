"""Rays of chosen pixels for both cameras, and the jitter draw, written out
plainly.

Pinhole: the stock tutorial raygen (raytrace.rgen:42-48) with the
view / projection matrices of `updateUniformBuffer`
(hello_vulkan.cpp:58-100): a look-at view and Vulkan's perspective, fov
60, near 0.1, far 1000. Toroidal: the reference's experimental raygen
(VKT/ray_tracing__before/shaders/raytrace.rgen:19-57), its yaw and pitch
offsets worked out on the host in float32. The jitter: JAX's
`uniform(fold_in(PRNGKey(seed), s), (W*H, 2))` (threefry-2x32, 20
rounds), element pair i moving the pixel the program traces i-th, in its
block-major order.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32
MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


# --- host matrices (float32, as the tutorial's nvmath) ----------------------

def _normalize(v):
    v = np.asarray(v, dtype=F32)
    return (v / np.linalg.norm(v).astype(F32)).astype(F32)


def look_at(eye, center, up) -> np.ndarray:
    eye, center, up = (np.asarray(a, dtype=F32) for a in (eye, center, up))
    f = _normalize(center - eye)
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f).astype(F32)
    m = np.eye(4, dtype=F32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_vk(fovy_deg, aspect, near=0.1, far=1000.0) -> np.ndarray:
    t = np.tan(np.radians(F32(fovy_deg)) / F32(2.0)).astype(F32)
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = F32(1.0) / (t * F32(aspect))
    m[1, 1] = -(F32(1.0) / t)
    m[2, 2] = F32(far) / (F32(near) - F32(far))
    m[2, 3] = (F32(far) * F32(near)) / (F32(near) - F32(far))
    m[3, 2] = F32(-1.0)
    return m


def inverse(m) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=np.float64)).astype(F32)


def toroidal_offsets(eye, center, rho: float):
    """(omega, theta) in degrees, float32 (raytrace.rgen:34-53)."""
    eye = np.asarray(eye, dtype=F32)
    center = np.asarray(center, dtype=F32)
    temp = center - eye
    d = np.array([temp[0], temp[2]], dtype=F32)
    d = d / F32(np.linalg.norm(d))
    omega = F32(np.degrees(np.arccos(np.clip(d[0], -1.0, 1.0))))
    if temp[2] < 0:
        omega = F32(360.0) - omega
    theta = F32(0.0)
    if eye[1] != center[1]:
        first = np.array([eye[0] + rho * np.cos(np.radians(omega)), eye[1],
                          eye[2] + rho * np.sin(np.radians(omega))],
                         dtype=F32)
        temp2 = center - first
        d2 = np.array([temp2[0], temp2[1]], dtype=F32)
        d2 = d2 / F32(np.linalg.norm(d2))
        theta = F32(np.degrees(np.arccos(np.clip(d2[0], -1.0, 1.0))))
        if temp2[1] < 0:
            theta = F32(360.0) - theta
    return float(omega), float(theta)


# --- pixel order and the jitter draw ----------------------------------------

def block_size(width: int, height: int) -> int:
    """The program's trace tile: the largest of 32, 24, ... 2 dividing both
    sides, else 1."""
    for b in (32, 24, 16, 12, 8, 6, 4, 3, 2):
        if width % b == 0 and height % b == 0:
            return b
    return 1


def trace_index(xs, ys, width: int, height: int):
    """The index at which the program traces pixel (x, y): b x b tiles,
    row-major within and across tiles."""
    b = block_size(width, height)
    if b == 1:
        return ys * width + xs
    return ((ys // b) * (width // b) + xs // b) * (b * b) \
        + (ys % b) * b + xs % b


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    return (0, int(seed) & MASK)


def fold_in(key: tuple, data: int) -> tuple:
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def uniform_at(key: tuple, rays) -> torch.Tensor:
    """Rows `rays` of uniform(key, (N, 2)): (P, 2) float32 in [0, 1)."""
    e = torch.stack([2 * rays, 2 * rays + 1], dim=1).to(torch.int64)
    y0, y1 = threefry2x32(key[0], key[1], e >> 32, e & MASK)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# --- rays -------------------------------------------------------------------

def rays(camera: dict, rho: float, width: int, height: int, xs, ys,
         jitter=None, dtype=torch.float32):
    """(origins, dirs), each (P, 3) in `dtype`, of pixels (xs, ys); jitter
    (P, 2) replaces the pinhole's centered 0.5 and adds to the toroidal
    camera's pixel."""
    dev = xs.device

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=F32), device=dev).to(dtype)

    px, py = xs.to(dtype), ys.to(dtype)
    if camera["type"] == "pinhole":
        view_inv = inverse(look_at(camera["eye"], camera["center"],
                                   camera.get("up", (0.0, 1.0, 0.0))))
        proj_inv = inverse(perspective_vk(camera.get("fov_deg", 60.0),
                                          width / height))
        if jitter is None:
            px, py = px + 0.5, py + 0.5
        else:
            px, py = px + jitter[:, 0].to(dtype), py + jitter[:, 1].to(dtype)
        dx = px / float(width) * 2.0 - 1.0
        dy = py / float(height) * 2.0 - 1.0
        pi, vi = t(proj_inv), t(view_inv)
        tc = [pi[j, 0] * dx + pi[j, 1] * dy + pi[j, 2] + pi[j, 3]
              for j in range(3)]
        tn = torch.sqrt(tc[0] * tc[0] + tc[1] * tc[1] + tc[2] * tc[2])
        tc = [c / tn for c in tc]
        dirs = torch.stack([vi[j, 0] * tc[0] + vi[j, 1] * tc[1]
                            + vi[j, 2] * tc[2] for j in range(3)], dim=-1)
        return torch.broadcast_to(vi[:3, 3], dirs.shape).contiguous(), dirs
    if camera["type"] != "toroidal":
        raise ValueError(f"unknown camera type {camera['type']!r}")
    omega, theta = toroidal_offsets(camera["eye"], camera["center"], rho)
    eye = t(camera["eye"])
    if jitter is not None:
        px, py = px + jitter[:, 0].to(dtype), py + jitter[:, 1].to(dtype)
    alfa = float(F32(360.0) / F32(width)) * px
    beta = float(F32(360.0) / F32(height)) * py
    a = torch.deg2rad(alfa + t(omega))
    b = torch.deg2rad(beta + t(theta))
    ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
    r = t(rho)
    origins = torch.stack([eye[0] + r * ca, torch.broadcast_to(eye[1],
                                                               ca.shape),
                           eye[2] + r * sa], dim=-1)
    return origins, torch.stack([ca * cb, sb, sa * cb], dim=-1)
