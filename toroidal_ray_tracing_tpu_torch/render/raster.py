"""Raster debug view (the port of the JAX package's `render/raster.py`).

The reference UI can toggle from the ray tracer to a classic raster view of
the same scene (`useRayTracer`, VKT/ray_tracing__before/main.cpp:284,345-354;
pipeline at hello_vulkan.cpp:156-185,404-431). Its fragment shader runs the
same `computeDiffuse` / `computeSpecular` but casts no shadow or reflection
rays (shaders/frag_shader.frag:56-99).

Here: a plain-torch z-buffered triangle rasterizer — screen-space edge
functions, perspective-correct attribute interpolation, per-fragment
Phong. Brute force pixels x triangles, in chunks of triangles; the
analytic tori have no raster analog (the reference's raster path draws only
the OBJ meshes). Triangles crossing the near plane are clipped in clip
space into up to two sub-triangles, each sub-vertex carrying its
barycentrics in the ORIGINAL triangle, so interpolation is exact across the
clip.

Each chunk tests only the pixels of its screen box (the triangles' vertex
box, one pixel wider each way): a pixel outside it is inside none of the
chunk's triangles, so the cull leaves the z-buffer as the full test would.
Temporaries are (pixels, triangles) and stay within `PAIR_BUDGET` elements.
The z-buffer keeps the least z; ties go to the lowest sub-triangle index
(the first minimum within a chunk, a strict `<` across chunks), so the
result does not depend on the chunking.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.render.renderer import (
    autofill_pixel_spread, check_device)
from toroidal_ray_tracing_tpu_torch.scene.types import (LIGHT_POINT,
                                                        RenderSettings, Scene)

F32 = np.float32
TRI_CHUNK = 512           # triangles per z-buffer pass
PAIR_BUDGET = 1 << 27     # elements of one (pixels, triangles) temporary
TWO_PI = float(F32(2.0 * np.pi))


def _near_clip(c, bary, valid):
    """Clip triangles against the near plane (z_clip >= 0, Vulkan [0,1]
    depth).

    c: (T, 3, 4) clip-space vertices; bary: (T, 3, 3) original-triangle
    barycentrics per vertex; valid: (T,). Returns (c2, bary2, valid2) with
    a 2T sub-triangle axis: a canonical rotation puts the pattern in one of
    {all-in, one-in, two-in, none}; one-in yields one sub-triangle, two-in
    two (the clipped quad)."""
    d = c[:, :, 2]                          # (T, 3) signed near distances
    inside = d >= 0.0
    k = inside.sum(dim=1)                   # (T,)

    # canonical rotation r: k == 1 puts the inside vertex at slot 0; k == 2
    # the outside vertex at slot 2
    i0, i1, i2 = inside[:, 0], inside[:, 1], inside[:, 2]
    r1 = torch.where(i0, 0, torch.where(i1, 1, 2))
    r2 = torch.where(~i2, 0, torch.where(~i0, 1, 2))
    r = torch.where(k == 1, r1, torch.where(k == 2, r2, 0))

    idx = (r[:, None] + torch.arange(3, device=c.device)[None, :]) % 3
    cr = torch.take_along_dim(c, idx[:, :, None], dim=1)      # (T, 3, 4)
    br = torch.take_along_dim(bary, idx[:, :, None], dim=1)   # (T, 3, 3)
    dr = torch.take_along_dim(d, idx, dim=1)                  # (T, 3)

    A, B, C = cr[:, 0], cr[:, 1], cr[:, 2]
    bA, bB, bC = br[:, 0], br[:, 1], br[:, 2]
    dA, dB, dC = dr[:, 0:1], dr[:, 1:2], dr[:, 2:3]

    def lerp_at(P, Q, bP, bQ, dP, dQ):
        denom = dP - dQ
        s = dP / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        s = torch.clamp(s, 0.0, 1.0)
        return P + s * (Q - P), bP + s * (bQ - bP)

    PAB, bPAB = lerp_at(A, B, bA, bB, dA, dB)   # on edge A->B
    PBC, bPBC = lerp_at(B, C, bB, bC, dB, dC)
    PCA, bPCA = lerp_at(C, A, bC, bA, dC, dA)

    k1 = (k == 1)[:, None]
    k2 = (k == 2)[:, None]
    k3 = (k == 3)[:, None]

    def pick(all3, two, one):
        return torch.where(k3, all3, torch.where(k2, two,
                                                 torch.where(k1, one, 0.0)))

    # sub-triangle 1: all-in -> (A, B, C); two-in -> (A, B, PBC);
    # one-in -> (A, PAB, PCA)
    t1 = torch.stack([pick(A, A, A), pick(B, B, PAB), pick(C, PBC, PCA)],
                     dim=1)
    b1 = torch.stack([pick(bA, bA, bA), pick(bB, bB, bPAB),
                      pick(bC, bPBC, bPCA)], dim=1)
    v1_ok = valid & (k >= 1)
    # sub-triangle 2: only for two-in -> (A, PBC, PCA)
    t2 = torch.stack([A, PBC, PCA], dim=1)
    b2 = torch.stack([bA, bPBC, bPCA], dim=1)
    v2_ok = valid & (k == 2)

    return (torch.cat([t1, t2]), torch.cat([b1, b2]),
            torch.cat([v1_ok, v2_ok]))


def _to_clip(p, viewproj):
    """(T, 3) world points -> (T, 4) clip coordinates, [p, 1] @ viewproj^T
    summed left to right."""
    vp = viewproj
    return torch.stack([p[:, 0] * vp[j, 0] + p[:, 1] * vp[j, 1]
                        + p[:, 2] * vp[j, 2] + vp[j, 3] for j in range(4)],
                       dim=1)


def _project(cl, width, height):
    w = cl[:, 3]
    ok = w > 1e-6
    inv_w = torch.where(ok, 1.0 / torch.where(ok, w, 1.0), 0.0)
    ndc = cl[:, :3] * inv_w[:, None]
    sx = (ndc[:, 0] + 1.0) * 0.5 * width
    sy = (ndc[:, 1] + 1.0) * 0.5 * height
    return sx, sy, ndc[:, 2], inv_w, ok


def _screen_boxes(xs, ys, tri_ok, width, height, n_chunks):
    """Per chunk, the pixel rectangle [x0, x1) x [y0, y1) that can hold a
    pixel center inside one of its drawable triangles (one pixel of margin
    for rounding), as a host (n_chunks, 4) int array; empty when x0 >= x1.
    Non-finite corners widen the box to the whole screen."""
    big = 1e30
    pad = n_chunks * TRI_CHUNK - xs[0].shape[0]

    def per_chunk(v, fill, reduce):
        v = torch.cat([v, v.new_full((pad,), fill)])
        return reduce(v.reshape(n_chunks, TRI_CHUNK), dim=1)

    lo, hi = [], []
    for v in (xs, ys):
        vmin = torch.minimum(torch.minimum(v[0], v[1]), v[2])
        vmax = torch.maximum(torch.maximum(v[0], v[1]), v[2])
        vmin = torch.nan_to_num(vmin, nan=-big, posinf=big, neginf=-big)
        vmax = torch.nan_to_num(vmax, nan=big, posinf=big, neginf=-big)
        lo.append(per_chunk(torch.where(tri_ok, vmin, big), big,
                            torch.amin))
        hi.append(per_chunk(torch.where(tri_ok, vmax, -big), -big,
                            torch.amax))
    box = torch.stack([lo[0], hi[0], lo[1], hi[1]], dim=1).cpu().double()
    out = np.zeros((n_chunks, 4), np.int64)
    for i, (x0, x1, y0, y1) in enumerate(box.tolist()):
        out[i] = (max(0, math.floor(min(x0, width) - 1.5)),
                  min(width, math.ceil(max(x1, 0.0) + 1.5)),
                  max(0, math.floor(min(y0, height) - 1.5)),
                  min(height, math.ceil(max(y1, 0.0) + 1.5)))
    return out


def _zbuffer(xs, ys, zs, tri_ok, width, height, device):
    """The z-buffer pass: per pixel, the nearest sub-triangle whose edge
    functions contain the pixel center and whose NDC z lies in [0, 1].
    Returns (zbuf, prim, w0, w1) as (H, W) tensors (zbuf 1.5 where
    nothing was drawn)."""
    zbuf = torch.full((height, width), 1.5, dtype=torch.float32,
                      device=device)
    prim = torch.zeros((height, width), dtype=torch.int32, device=device)
    bu = torch.zeros((height, width), dtype=torch.float32, device=device)
    bv = torch.zeros((height, width), dtype=torch.float32, device=device)
    T = xs[0].shape[0]
    n_chunks = -(-T // TRI_CHUNK)
    boxes = _screen_boxes(xs, ys, tri_ok, width, height, n_chunks)
    for c in range(n_chunks):
        x0, x1, y0, y1 = (int(v) for v in boxes[c])
        if x0 >= x1 or y0 >= y1:
            continue
        s = slice(c * TRI_CHUNK, min((c + 1) * TRI_CHUNK, T))
        cx0, cx1, cx2 = (v[s][None] for v in xs)
        cy0, cy1, cy2 = (v[s][None] for v in ys)
        cz0, cz1, cz2 = (v[s][None] for v in zs)
        cok = tri_ok[s][None]
        area = (cx1 - cx0) * (cy2 - cy0) - (cy1 - cy0) * (cx2 - cx0)
        a_ok = area.abs() > 1e-12
        inv_area = (torch.where(a_ok, 1.0, 0.0)
                    / torch.where(a_ok, area, 1.0))
        n_tri = cx0.shape[1]
        band = max(1, PAIR_BUDGET // ((x1 - x0) * n_tri))
        px1 = torch.arange(x0, x1, dtype=torch.float32, device=device) + 0.5
        for r0 in range(y0, y1, band):
            r1 = min(r0 + band, y1)
            py1 = (torch.arange(r0, r1, dtype=torch.float32, device=device)
                   + 0.5)
            pxc = px1[None, :].expand(r1 - r0, -1).reshape(-1, 1)
            pyc = py1[:, None].expand(-1, x1 - x0).reshape(-1, 1)
            w0 = ((cx1 - pxc) * (cy2 - pyc)
                  - (cy1 - pyc) * (cx2 - pxc)) * inv_area
            w1 = ((cx2 - pxc) * (cy0 - pyc)
                  - (cy2 - pyc) * (cx0 - pxc)) * inv_area
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & a_ok & cok
            z = w0 * cz0 + w1 * cz1 + w2 * cz2      # NDC z is screen-linear
            z = torch.where(inside & (z >= 0.0) & (z <= 1.0), z, 2.0)
            zmin, arg = torch.min(z, dim=1)         # first minimum on ties
            shape = (r1 - r0, x1 - x0)
            zmin = zmin.reshape(shape)
            better = zmin < zbuf[r0:r1, x0:x1]
            a = arg[:, None]
            zbuf[r0:r1, x0:x1] = torch.where(better, zmin, zbuf[r0:r1, x0:x1])
            prim[r0:r1, x0:x1] = torch.where(
                better, (c * TRI_CHUNK + arg).to(torch.int32).reshape(shape),
                prim[r0:r1, x0:x1])
            bu[r0:r1, x0:x1] = torch.where(
                better, w0.gather(1, a).reshape(shape), bu[r0:r1, x0:x1])
            bv[r0:r1, x0:x1] = torch.where(
                better, w1.gather(1, a).reshape(shape), bv[r0:r1, x0:x1])
    return zbuf, prim, bu, bv


def _raster(scene: Scene, settings: RenderSettings, viewproj, width, height):
    """Rasterize the scene's triangles and interpolate each pixel's
    surface; returns per-pixel (row-major) tensors."""
    tris = scene.triangles
    mats = scene.materials
    T = tris.v0.shape[0]
    dev = tris.v0.device

    p1 = tris.v0 + tris.e1
    p2 = tris.v0 + tris.e2
    clip = torch.stack([_to_clip(tris.v0, viewproj), _to_clip(p1, viewproj),
                        _to_clip(p2, viewproj)], dim=1)        # (T, 3, 4)
    bary0 = torch.eye(3, dtype=torch.float32, device=dev)[None].expand(T, 3,
                                                                       3)
    clip2, bary2, sub_ok = _near_clip(clip, bary0, tris.valid)
    sub_orig = torch.arange(T, device=dev).repeat(2)

    proj = [_project(clip2[:, v], width, height) for v in range(3)]
    xs = tuple(p[0] for p in proj)
    ys = tuple(p[1] for p in proj)
    zs = tuple(p[2] for p in proj)
    iw = tuple(p[3] for p in proj)
    tri_ok = proj[0][4] & proj[1][4] & proj[2][4] & sub_ok

    zbuf, prim, w0b, w1b = (a.reshape(-1) for a in _zbuffer(
        xs, ys, zs, tri_ok, width, height, dev))
    hit = zbuf <= 1.0
    prim = prim.long()
    w2b = 1.0 - w0b - w1b

    # perspective-correct interpolation weights (within the sub-triangle)
    pw0 = w0b * iw[0][prim]
    pw1 = w1b * iw[1][prim]
    pw2 = w2b * iw[2][prim]
    denom = torch.clamp(pw0 + pw1 + pw2, min=1e-20)
    pw0, pw1, pw2 = pw0 / denom, pw1 / denom, pw2 / denom

    # ORIGINAL-triangle barycentrics via the sub-vertex table, then the
    # attributes from the original corners
    bsub = bary2[prim]                                       # (P, 3, 3)
    b0, b1, b2 = (pw0 * bsub[:, 0, j] + pw1 * bsub[:, 1, j]
                  + pw2 * bsub[:, 2, j] for j in range(3))
    orig = sub_orig[prim]
    b0, b1, b2 = b0[:, None], b1[:, None], b2[:, None]

    world_pos = b0 * tris.v0[orig] + b1 * p1[orig] + b2 * p2[orig]
    nrm = b0 * tris.n0[orig] + b1 * tris.n1[orig] + b2 * tris.n2[orig]
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                     keepdim=True), min=1e-30)
    mat_id = tris.mat_id[orig].long()
    # perspective-correct uv (vert_shader.vert:63 -> frag_shader.frag:86-91)
    # and the uv texel density the mip-LOD heuristic needs (as in shade)
    uv = b0 * tris.uv0[orig] + b1 * tris.uv1[orig] + b2 * tris.uv2[orig]
    duv1 = tris.uv1[orig] - tris.uv0[orig]
    duv2 = tris.uv2[orig] - tris.uv0[orig]
    uv_area = (duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]).abs()
    world_area = torch.linalg.vector_norm(
        torch.linalg.cross(tris.e1[orig], tris.e2[orig], dim=-1), dim=-1)
    tex_density = torch.sqrt(uv_area / torch.clamp(world_area, min=1e-30))

    # frag_shader.frag:56-99 — computeDiffuse + computeSpecular, no shadows
    light = settings.light
    lpos = light.position
    if light.type == LIGHT_POINT:
        ldir = lpos[None, :] - world_pos
        ldist = torch.linalg.vector_norm(ldir, dim=-1)
        L = ldir / torch.clamp(ldist[:, None], min=1e-20)
        lint = light.intensity / torch.clamp(ldist * ldist, min=1e-20)
    else:
        L = (lpos / torch.clamp(torch.linalg.vector_norm(lpos),
                                min=1e-20))[None, :].expand_as(world_pos)
        lint = torch.full_like(world_pos[:, 0], light.intensity)

    ndotl = (nrm * L).sum(dim=-1)
    diffuse = mats.diffuse[mat_id] * torch.clamp(ndotl, min=0.0)[:, None]
    diffuse = torch.where((mats.illum[mat_id] >= 1)[:, None],
                          diffuse + mats.ambient[mat_id], diffuse)
    return (hit, world_pos, nrm, mat_id, diffuse, lint, L, uv, tex_density)


def raster_render(scene: Scene, camera, width: int, height: int,
                  settings: RenderSettings | None = None, device="cuda"):
    """Debug raster view of the triangle geometry (no shadows or
    reflections), on `device` (the CUDA device by default; without a GPU
    that raises, pass device="cpu" for the CPU).

    Returns {"image": (H, W, 3) linear} — compare with the ray-traced view
    the way the reference's UI checkbox did."""
    from toroidal_ray_tracing_tpu_torch.trace.shade import (_sample_texture,
                                                            mip_lod)

    device = check_device(device)
    if settings is None:
        settings = RenderSettings.default()
    settings = autofill_pixel_spread(settings, camera, width, height)
    scene = scene.to(device)
    settings = settings.to(device)
    view, proj, _, _ = camera.matrices(width / height)
    viewproj = torch.from_numpy((proj @ view).astype(F32)).to(device)
    (hit, world_pos, nrm, mat_id, diffuse, lint, L, uv,
     tex_density) = _raster(scene, settings, viewproj, width, height)

    mats = scene.materials
    eye = torch.tensor(np.asarray(camera.eye, F32), device=device)

    # texture modulate (frag_shader.frag:86-91: diffuse *= texture(txt,
    # uv)) with the ray path's trilinear footprint-LOD sampler, so the two
    # views agree on unshadowed geometry
    if scene.textures.data4q.shape[0] > 1:
        tex_id = mats.texture_id[mat_id]
        tid = torch.clamp(tex_id, min=0)
        dist = torch.linalg.vector_norm(world_pos - eye[None, :], dim=-1)
        sizes0 = scene.textures.sizes[tid.long(), 0]
        dim0 = torch.maximum(sizes0[:, 0], sizes0[:, 1]).float()
        lod = mip_lod(dist, settings.pixel_spread, tex_density, dim0)
        texel = _sample_texture(scene, tid, uv.T, lod, backend="torch").T
        diffuse = torch.where((tex_id >= 0)[:, None], diffuse * texel,
                              diffuse)
    V = eye[None, :] - world_pos
    V = V / torch.clamp(torch.linalg.vector_norm(V, dim=-1, keepdim=True),
                        min=1e-30)
    kshine = torch.clamp(mats.shininess[mat_id], min=4.0)
    energy = (2.0 + kshine) / TWO_PI
    R = 2.0 * (L * nrm).sum(dim=-1, keepdim=True) * nrm - L
    spec = energy * torch.pow(torch.clamp((V * R).sum(dim=-1), min=0.0),
                              kshine)
    spec = torch.where(mats.illum[mat_id] >= 2, spec, 0.0)
    specular = mats.specular[mat_id] * spec[:, None]

    color = lint[:, None] * (diffuse + specular)
    clear = settings.clear_color[:3]
    image = torch.where(hit[:, None], color, clear[None, :])
    return {"image": image.reshape(height, width, 3)}
