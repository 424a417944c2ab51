"""Point-cloud reprojection (the reference's `ray_tracing__before_second`),
in plain PyTorch on the chosen device: the port of the JAX package's
`pointcloud/splat.py` (a jitted scatter-min there; no TPU kernel behind it).

App 2 re-renders the toroidal capture as a point cloud: it zips the
position/color text dumps into a `Point{vec4 pos; vec4 color}` buffer and
rasterizes with POINT_LIST topology, 2.5-px points and LESS depth test from a
normal pinhole camera (VKT/ray_tracing__before_second/hello_vulkan.cpp:
143-270, 313-330; shaders/vert_shader.vert:43-52).

Here: project all points with the same viewProj matrix (full float32, the
same bits on every device), z-buffer them with a scatter-min and resolve
colors with a masked per-channel scatter-max. Point size 2.5 px maps to a
3x3 splat neighborhood covering pixel centers within size/2, like the GL
point rasterization rule.
"""

from __future__ import annotations

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.io.dumps import FLOAT_LOWEST
from toroidal_ray_tracing_tpu_torch.render.renderer import check_device

F32 = np.float32
POINT_SIZE = 2.5  # gl_PointSize (vert_shader.vert:51)


def splat_points(positions, colors, camera, width: int, height: int,
                 clear_color=(1.0, 1.0, 1.0), point_size: float = POINT_SIZE,
                 return_cover: bool = False, fill_holes: float = 0.0,
                 device="cuda"):
    """Render a point cloud. positions/colors: (N, 3) float32 arrays or
    tensors (sentinel FLOAT_LOWEST rows are dropped, mirroring app 2's
    `-nan` handling).

    return_cover: also return the (H, W) bool mask of pixels some point
    won plus the surviving point count (the splat-sparsity metrics).
    fill_holes > point_size: pixels no point covered are resolved by a
    second, fatter splat pass with its own z-buffer (depth-aware, so
    occluded points cannot bleed through); base-pass pixels are untouched.
    device: where to splat, the CUDA device unless device="cpu" (without
    a GPU the default raises).

    Returns the (H, W, 3) linear color image (a tensor on `device`), or
    (image, cover, n_points) with return_cover.
    """
    device = check_device(device)
    pos = torch.as_tensor(positions, dtype=torch.float32, device=device)
    col = torch.as_tensor(colors, dtype=torch.float32, device=device)
    keep = ~(pos <= float(FLOAT_LOWEST * F32(0.5))).any(dim=1)
    pos, col = pos[keep], col[keep]

    view, proj, _, _ = camera.matrices(width / height)
    viewproj = torch.as_tensor((proj @ view).astype(F32), device=device)
    clear = torch.as_tensor(np.asarray(clear_color, F32), device=device)

    img, won = _splat_core(pos, col, viewproj, clear, width, height,
                           point_size)
    if fill_holes > point_size:
        fimg, fwon = _splat_core(pos, col, viewproj, clear, width, height,
                                 fill_holes)
        img = torch.where(won[:, :, None], img, fimg)
        won = won | fwon
    if return_cover:
        return img, won, int(pos.shape[0])
    return img


def _splat_core(positions, colors, viewproj, clear, width, height,
                point_size):
    dev = positions.device
    # clip = [positions, 1] @ viewproj.T, as four products summed pairwise
    # (the order XLA's CPU dot uses in the JAX package) by separate
    # elementwise ops: no FMA contraction on any device, so the card, the
    # CPU and the JAX package project every point to the same bits (a
    # matmul's own order flips z-buffer winners between near-equal depths)
    t = [positions[:, i:i + 1] * viewproj[:, i] for i in range(3)]
    clip = (t[0] + t[1]) + (t[2] + viewproj[:, 3])
    w = clip[:, 3]
    w_ok = w > float(F32(1e-6))
    ndc = clip[:, :3] / torch.where(w_ok, w, 1.0)[:, None]
    # Vulkan viewport transform: [-1,1] -> pixels, depth in [0,1], LESS test
    px = (ndc[:, 0] + 1.0) * 0.5 * width - 0.5
    py = (ndc[:, 1] + 1.0) * 0.5 * height - 0.5
    z = ndc[:, 2]
    visible = w_ok & (z >= 0.0) & (z <= 1.0)

    npx = width * height
    half = float(F32(point_size / 2.0))
    r = int(np.ceil((point_size - 1.0) / 2.0))
    x0 = torch.round(px).to(torch.int64)   # half to even, as jnp.round
    y0 = torch.round(py).to(torch.int64)

    zbuf = torch.ones((npx,), device=dev)
    taps = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xi = x0 + dx
            yi = y0 + dy
            cover = ((xi.to(torch.float32) - px).abs() <= half) \
                & ((yi.to(torch.float32) - py).abs() <= half)
            ok = visible & cover & (xi >= 0) & (xi < width) \
                & (yi >= 0) & (yi < height)
            idx = torch.where(ok, yi * width + xi, 0)
            zi = torch.where(ok, z, 2.0)
            taps.append((idx, zi, ok))
            zbuf.scatter_reduce_(0, idx, zi, "amin")

    # color resolve: a point wins a pixel iff its depth equals the z-buffer.
    # Equal-depth ties resolve to the per-channel MAX color among the tied
    # points, as the JAX package does (the reference colors by draw order,
    # which is not reproducible; exact ties between distinct capture points
    # are measure-zero).
    win_accum = torch.full((npx, 3), -1.0, device=dev)
    won = torch.zeros((npx,), dtype=torch.int32, device=dev)
    for idx, zi, ok in taps:
        winner = ok & (zi <= zbuf[idx])
        win_accum.scatter_reduce_(
            0, idx[:, None].expand(-1, 3),
            torch.where(winner[:, None], colors, -1.0), "amax")
        won.scatter_reduce_(0, idx, winner.to(torch.int32), "amax")
    won = won > 0
    img = torch.where(won[:, None], win_accum.clamp(min=0.0),
                      clear[:3].expand(npx, 3))
    return img.reshape(height, width, 3), won.reshape(height, width)
