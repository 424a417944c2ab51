"""Closest-hit + miss shading, vectorized over the ray batch.

Port of the reference's shading semantics as dense tensor ops with masked
selects:

  raytrace.rchit:26-135  — interpolation, lighting, shadow ray, reflection
  raytrace.rmiss:16-22   — miss = clearColor * 0.8, hitPosition = 0
  wavefront.glsl:23-50   — computeDiffuse (Lambert+ambient), computeSpecular
                           (Phong with (2+s)/(2pi) energy factor)

Per-ray vectors are rows: (3, N).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.geom import torus as torus_geom
from toroidal_ray_tracing_tpu_torch.ops.tex_kernel import quad_gather
from toroidal_ray_tracing_tpu_torch.scene.types import (LIGHT_POINT,
                                                        RenderSettings, Scene,
                                                        tex_dequant)
from toroidal_ray_tracing_tpu_torch.trace.intersect import Hit, any_hit

TWO_PI = float(np.float32(2.0 * np.pi))


@dataclasses.dataclass
class ShadeResult:
    hit_value: torch.Tensor     # (3, N) prd.hitValue
    hit_position: torch.Tensor  # (3, N) prd.hitPosition (0 on miss)
    atten_factor: torch.Tensor  # (3, N) multiplied into prd.attenuation
    done: torch.Tensor          # (N,) bool — no reflection requested
    next_origin: torch.Tensor   # (3, N)
    next_dir: torch.Tensor      # (3, N)
    shadow_rays: torch.Tensor   # (N,) bool — a shadow ray was traced


def _reflect(d, n):
    return d - 2.0 * (d * n).sum(dim=0, keepdim=True) * n


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=0, keepdim=True),
                           min=1e-30)


def mip_lod(t, pixel_spread, tex_density, level0_max_dim):
    """Footprint-based LOD: texels covered by one pixel at hit distance t =
    t * pixel_spread * uv-density * texture resolution; lod = log2 of that.
    pixel_spread == 0 degenerates to level 0."""
    texels = (torch.clamp(t, max=1e8) * pixel_spread * tex_density
              * level0_max_dim)
    return torch.log2(torch.clamp(texels, min=1e-20))


def _quad_index(atlas, tex_id, level, uv):
    """Flat data4q row of the top-left tap + bilinear fractions, repeat
    addressing, at one mip level (the index half of the quad gather, shared
    by the torch gather and the K4 kernel so the two cannot drift).
    uv: (2, N) rows; returns ((N,) int32, (1, N), (1, N))."""
    tid, lv = tex_id.long(), level.long()
    off = atlas.offsets[tid, lv]
    hs = atlas.sizes[tid, lv, 0]
    ws = atlas.sizes[tid, lv, 1]
    x = torch.remainder(uv[0], 1.0) * ws.float() - 0.5
    y = torch.remainder(uv[1], 1.0) * hs.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[None, :]
    fy = (y - y0)[None, :]
    xi = torch.remainder(x0.to(torch.int32), ws)
    yi = torch.remainder(y0.to(torch.int32), hs)
    return (off + yi * ws + xi).to(torch.int32), fx, fy


def _blend_quad(q, fx, fy):
    """Bilinear blend of one gathered quad word set, (3, N) words: the taps
    are decoded after the fetch and before the blend (the R8G8B8A8_SRGB
    sampler order)."""
    t00, t10, t01, t11 = (tex_dequant(q, k) for k in range(4))
    return (t00 * (1 - fx) * (1 - fy)
            + t10 * fx * (1 - fy)
            + t01 * (1 - fx) * fy
            + t11 * fx * fy)


def _sample_texture(scene: Scene, tex_id, uv, lod, valid=None,
                    backend: str = "torch"):
    """Trilinear mipmapped sampling (raytrace.rchit:83; full mip chain,
    hello_vulkan.cpp:315-339). uv: (2, N); returns (3, N).

    backend="kernel" fetches both trilinear taps through the K4 gather
    (`ops.tex_kernel.quad_gather`) in one call; `valid` marks the rays whose
    sample is used (the others get zero words)."""
    atlas = scene.textures
    nl = atlas.n_levels[tex_id.long()]
    lvl = torch.minimum(torch.clamp(lod, min=0.0), (nl - 1).float())
    l0 = torch.floor(lvl).to(torch.int32)
    l1 = torch.minimum(l0 + 1, nl - 1)
    f = (lvl - l0.float())[None, :]
    i0, fx0, fy0 = _quad_index(atlas, tex_id, l0, uv)
    i1, fx1, fy1 = _quad_index(atlas, tex_id, l1, uv)
    if backend == "kernel":
        if valid is None:
            valid = torch.ones_like(i0, dtype=torch.bool)
        q0, q1 = quad_gather(atlas.data4q, i0, i1, valid)
    else:
        q0 = atlas.data4q[i0.long()].T
        q1 = atlas.data4q[i1.long()].T
    c0 = _blend_quad(q0, fx0, fy0)
    c1 = _blend_quad(q1, fx1, fy1)
    return c0 * (1 - f) + c1 * f


def shade(scene: Scene, settings: RenderSettings, origins, dirs, hit: Hit,
          backend: str = "torch", geom=None, prim_group=None) -> ShadeResult:
    """origins/dirs: (3, N) rows. geom / prim_group: the shadow query's
    geometry slice and the group it merges over (`closest_hit`'s)."""
    tris = scene.triangles
    tor = scene.tori
    mats = scene.materials

    missed = hit.kind < 0
    prim = torch.clamp(hit.prim, min=0)
    is_tor = hit.kind == 1

    # hit point along the ray (rchit:94,134); t clamped so the BIG miss
    # sentinel doesn't overflow float32 (missed lanes are masked below)
    ray_hit_pos = origins + torch.clamp(hit.t, max=1.0e8)[None, :] * dirs

    if hit.attrs is not None:
        # kernel-emitted attributes: no per-ray table gathers
        a = hit.attrs
        world_pos = torch.where(is_tor[None, :], ray_hit_pos, a.pos)
        tex_id = torch.where(is_tor, -1, a.texture_id)
        return _shade_common(scene, settings, dirs, hit, missed,
                             ray_hit_pos, world_pos, _normalize(a.nrm), a.uv,
                             a.ambient, a.diffuse, a.specular, a.shininess,
                             a.illum, tex_id, a.tex_density, backend, geom,
                             prim_group)

    tri_prim = torch.where(is_tor, 0, prim).long()
    tor_prim = torch.clamp(torch.where(is_tor, prim, 0),
                           max=tor.world_to_obj.shape[0] - 1).long()

    # --- triangle attributes, barycentric interpolation (rchit:43-54) ---
    w = (1.0 - hit.u - hit.v)[None, :]
    u = hit.u[None, :]
    v = hit.v[None, :]
    tri_pos = tris.v0[tri_prim].T + u * tris.e1[tri_prim].T \
        + v * tris.e2[tri_prim].T
    tri_nrm = (w * tris.n0[tri_prim].T + u * tris.n1[tri_prim].T
               + v * tris.n2[tri_prim].T)
    tri_uv = (w * tris.uv0[tri_prim].T + u * tris.uv1[tri_prim].T
              + v * tris.uv2[tri_prim].T)
    tri_mat = tris.mat_id[tri_prim]

    # --- torus attributes (object-space normal -> world) ---
    W12 = tor.world_to_obj.reshape(-1, 12)
    wc = [W12[tor_prim, i] for i in range(12)]
    hx, hy, hz = ray_hit_pos[0], ray_hit_pos[1], ray_hit_pos[2]
    p_obj = torch.stack([
        wc[0] * hx + wc[1] * hy + wc[2] * hz + wc[3],
        wc[4] * hx + wc[5] * hy + wc[6] * hz + wc[7],
        wc[8] * hx + wc[9] * hy + wc[10] * hz + wc[11],
    ], dim=0)
    n_obj = torus_geom.torus_normal(p_obj.T, tor.major_radius[tor_prim])
    nx, ny, nz = n_obj[:, 0], n_obj[:, 1], n_obj[:, 2]
    # normals transform by the inverse-transpose = rows of world_to_obj's
    # rotation applied as columns (rchit:54)
    n_tor = torch.stack([
        nx * wc[0] + ny * wc[4] + nz * wc[8],
        nx * wc[1] + ny * wc[5] + nz * wc[9],
        nx * wc[2] + ny * wc[6] + nz * wc[10],
    ], dim=0)
    tor_mat = tor.mat_id[tor_prim]

    world_pos = torch.where(is_tor[None, :], ray_hit_pos, tri_pos)
    nrm = _normalize(torch.where(is_tor[None, :], n_tor, tri_nrm))
    mat_id = torch.where(is_tor, tor_mat, tri_mat).long()

    # uv texel density for mip LOD: sqrt(uv area / world area) of the tri
    duv1 = tris.uv1[tri_prim] - tris.uv0[tri_prim]
    duv2 = tris.uv2[tri_prim] - tris.uv0[tri_prim]
    uv_area = (duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]).abs()
    world_area = torch.linalg.vector_norm(
        torch.linalg.cross(tris.e1[tri_prim], tris.e2[tri_prim], dim=-1),
        dim=-1)
    tex_density = torch.sqrt(uv_area / torch.clamp(world_area, min=1e-30))

    return _shade_common(
        scene, settings, dirs, hit, missed, ray_hit_pos, world_pos, nrm,
        tri_uv, mats.ambient[mat_id].T, mats.diffuse[mat_id].T,
        mats.specular[mat_id].T, mats.shininess[mat_id], mats.illum[mat_id],
        torch.where(is_tor, -1, mats.texture_id[mat_id]), tex_density,
        backend, geom, prim_group)


def _shade_common(scene, settings, dirs, hit, missed, ray_hit_pos,
                  world_pos, nrm, tri_uv, ambient, diffuse_c, specular_c,
                  shininess, illum, tex_id, tex_density, backend, geom,
                  prim_group) -> ShadeResult:
    # --- light (rchit:57-71) ---
    light = settings.light
    lpos = light.position
    if light.type == LIGHT_POINT:
        ldir = lpos[:, None] - world_pos
        ldist_pt = torch.linalg.vector_norm(ldir, dim=0)
        L = ldir / torch.clamp(ldist_pt[None, :], min=1e-20)
        ldist = ldist_pt
        lint = light.intensity / torch.clamp(ldist_pt * ldist_pt, min=1e-20)
    else:
        L = torch.broadcast_to(
            (lpos / torch.clamp(torch.linalg.vector_norm(lpos),
                                min=1e-30))[:, None], world_pos.shape)
        ldist = torch.full_like(world_pos[0], 100000.0)
        lint = light.intensity

    # --- computeDiffuse (wavefront.glsl:23-31) ---
    ndotl = (nrm * L).sum(dim=0)
    diffuse = diffuse_c * torch.clamp(ndotl, min=0.0)[None, :]
    diffuse = torch.where((illum >= 1)[None, :], diffuse + ambient, diffuse)

    # texture modulation (rchit:79-84); static skip when the scene has no
    # textures (the dummy atlas is a single texel)
    if scene.textures.data4q.shape[0] > 1:
        tid = torch.clamp(tex_id, min=0).long()
        sizes0 = scene.textures.sizes[:, 0]
        dim0 = torch.maximum(sizes0[tid, 0], sizes0[tid, 1]).float()
        lod = mip_lod(hit.t, settings.pixel_spread, tex_density, dim0)
        texel = _sample_texture(scene, tid, tri_uv, lod,
                                valid=(tex_id >= 0) & ~missed,
                                backend=backend)
        diffuse = torch.where((tex_id >= 0)[None, :], diffuse * texel,
                              diffuse)

    # --- shadow ray (rchit:89-120): only where dot(N, L) > 0 ---
    facing = ndotl > 0.0
    need_shadow = facing & ~missed
    # rays that don't need the query get tmax = 0 (never hit). The query
    # is cut off from autograd: hard-shadow visibility has zero derivative
    # almost everywhere, and the dense path's backward would carry 0 * inf
    # = NaN from far-sentinel lanes into the light and geometry gradients
    shadow_tmax = torch.where(need_shadow, ldist, 0.0)
    shadowed = any_hit(scene, ray_hit_pos.detach(), L.detach().contiguous(),
                       shadow_tmax.detach(), backend=backend, geom=geom,
                       prim_group=prim_group)
    shadowed = shadowed & need_shadow
    attenuation_local = torch.where(shadowed, 0.3, 1.0)

    # --- computeSpecular (wavefront.glsl:34-50) ---
    kshine = torch.clamp(shininess, min=4.0)
    energy = (2.0 + kshine) / TWO_PI
    V = _normalize(-dirs)
    Rv = _reflect(-L, nrm)
    spec = energy * torch.pow(torch.clamp((V * Rv).sum(dim=0), min=0.0),
                              kshine)
    spec = torch.where((illum >= 2) & facing & ~shadowed, spec, 0.0)
    specular = specular_c * spec[None, :]

    hit_value = (attenuation_local * lint)[None, :] * (diffuse + specular)

    # --- miss (rmiss:16-22) ---
    clear = settings.clear_color[:3] * 0.8
    hit_value = torch.where(missed[None, :], clear[:, None], hit_value)
    hit_position = torch.where(missed[None, :], 0.0, ray_hit_pos)

    # --- reflection request (rchit:122-131) ---
    reflective = (illum == 3) & ~missed
    atten_factor = torch.where(reflective[None, :], specular_c, 1.0)

    return ShadeResult(
        hit_value=hit_value,
        hit_position=hit_position,
        atten_factor=atten_factor,
        done=~reflective,
        next_origin=world_pos,
        next_dir=_reflect(dirs, nrm),
        shadow_rays=need_shadow,
    )
