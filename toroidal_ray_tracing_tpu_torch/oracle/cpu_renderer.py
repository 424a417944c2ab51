"""The fidelity oracle: a plain renderer on tensors, the RMSE ground truth.

An independent implementation of the full reference pipeline semantics
(toroidal/pinhole raygen -> closest hit -> shade -> iterative reflection),
the port of the JAX package's NumPy oracle (`oracle/cpu_renderer.py` there)
onto torch tensors, so that it runs on the card as well as on the CPU.
It is written the naive way — a dense Möller–Trumbore test of every ray
against every triangle row, a float64 quartic per torus, a Python bounce
loop over the live rays — and shares no code path with the Woop / tree /
kernel path it checks: only the cameras' raygen (an exact port, tested on
its own; on the card it is R1, `ops/front_kernel.py`, held bit-equal to
its plain twin by chip_smoke.py), `geom/`, `scene/types.py` and
`autofill_pixel_spread`. It never runs `trace/` or any other part of
`ops/`.

The arithmetic follows the NumPy oracle step for step, in the same order
(sums of three products in index order, true divisions), so on the CPU the
two agree to the last bit but for the transcendental functions (pow, log2,
the cube root and arccos of the float64 resolvent). Rays and primitives go
in blocks of at most `PAIRS` (ray, primitive) pairs (a quarter of that for
the float64 tori); the blocks keep the NumPy oracle's tie rule: the first
primitive index with the smallest t, triangles before tori.

Shading semantics ported line-by-line from:
  VKT/ray_tracing__before/shaders/raytrace.rgen:59-116 (bounce loop, miss mix)
  VKT/ray_tracing__before/shaders/raytrace.rchit:26-135 (closest hit)
  VKT/ray_tracing__before/shaders/raytrace.rmiss:16-22  (miss)
  VKT/ray_tracing__before/shaders/wavefront.glsl:23-50  (diffuse/specular)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.geom import torus as torus_geom
from toroidal_ray_tracing_tpu_torch.geom.triangle import (cross3, dot3,
                                                          moller_trumbore)
from toroidal_ray_tracing_tpu_torch.render.renderer import (
    autofill_pixel_spread, check_device)
from toroidal_ray_tracing_tpu_torch.scene.types import (LIGHT_POINT,
                                                        RenderSettings, Scene)

F32 = np.float32
BIG = 1.0e30
TMIN = float(F32(0.001))     # raytrace.rgen:61
TMAX = float(F32(10000.0))   # raytrace.rgen:62

# (ray, primitive) pairs a block: ~2 GB of float32 temporaries on the card,
# ~16 MB on the CPU
PAIRS = {"cuda": 1 << 25, "cpu": 1 << 18}


def _sqrt(x):
    """Square root of a float32 tensor, correctly rounded on every device
    (torch's vectorized CPU sqrt may miss by an ulp; the float64 root
    rounded to float32 does not)."""
    return torch.sqrt(x.double()).float()


def _norm(x):
    """Euclidean norm over the last axis (size 3), as np.linalg.norm."""
    return _sqrt(dot3(x, x))


def _torus_normal(p, R):
    """`geom.torus.torus_normal` (the vector from the core circle to p,
    normalized) with `_sqrt`."""
    xz = _sqrt(torch.clamp(p[:, 0] * p[:, 0] + p[:, 2] * p[:, 2], min=1e-30))
    scale = R / xz
    n = p - torch.stack([p[:, 0] * scale, torch.zeros_like(scale),
                         p[:, 2] * scale], dim=-1)
    return n / _sqrt(torch.clamp(dot3(n, n), min=1e-30))[:, None]


def _reflect(d, n):
    return d - (2.0 * dot3(d, n))[:, None] * n


def _blocks(n: int, count: int, pairs: int):
    """(ray slices, primitive block size): blocks of at most `pairs`
    (ray, primitive) pairs."""
    per = max(1, min(count, pairs // max(n, 1)))
    rows = max(1, pairs // per)
    return [slice(s, min(s + rows, n)) for s in range(0, n, rows)], per


def _closest_hit(scene: Scene, origins, dirs, tmax=TMAX,
                 any_hit: bool = False):
    """Nearest intersection against all triangles + tori.

    Returns a dict of per-ray tensors: t, kind (0 tri / 1 torus / -1 miss),
    prim index, u, v. With any_hit=True returns only the occlusion mask
    (shadow-ray semantics: TerminateOnFirstHit, raytrace.rchit:96)."""
    n = origins.shape[0]
    dev = origins.device
    f32 = torch.float32
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=f32, device=dev),
                              (n,))
    best_t = torch.full((n,), BIG, dtype=f32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_kind = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=f32, device=dev)
    best_v = torch.zeros((n,), dtype=f32, device=dev)
    pairs = PAIRS[dev.type]

    # every row: with SAH clustering, padding rows are interleaved (not a
    # prefix); they are degenerate (e1 = e2 = 0) and never hit
    tris = scene.triangles
    nt = tris.count
    ray_slices, per = _blocks(n, nt, pairs)
    for rs in ray_slices:
        o, d, tm = origins[rs], dirs[rs], tmax[rs, None]
        bt, bp, bk = best_t[rs], best_prim[rs], best_kind[rs]
        bu, bv = best_u[rs], best_v[rs]
        for s in range(0, nt, per):
            e = min(s + per, nt)
            t, u, v, hit = moller_trumbore(o, d, tris.v0[s:e], tris.e1[s:e],
                                           tris.e2[s:e], TMIN, tm)
            t = torch.where(hit, t, BIG)
            arg = torch.argmin(t, dim=1, keepdim=True)
            tbest = t.gather(1, arg)[:, 0]
            better = tbest < bt
            bt = torch.where(better, tbest, bt)
            bp = torch.where(better, arg[:, 0].to(torch.int32) + s, bp)
            bk = torch.where(better, 0, bk)
            bu = torch.where(better, u.gather(1, arg)[:, 0], bu)
            bv = torch.where(better, v.gather(1, arg)[:, 0], bv)
            if any_hit and bool((bt < BIG).all()):
                break
        best_t[rs], best_prim[rs], best_kind[rs] = bt, bp, bk
        best_u[rs], best_v[rs] = bu, bv

    tor = scene.tori
    ks = torch.nonzero(tor.valid.cpu()).flatten().to(dev)
    if len(ks):
        # the float64 quartic holds ~4x the temporaries of the triangle test
        ray_slices, per = _blocks(n, len(ks), pairs // 4)
        f64 = torch.float64
        for rs in ray_slices:
            o64, d64 = origins[rs].to(f64), dirs[rs].to(f64)
            tm = tmax[rs, None].to(f64)
            bt, bp, bk = best_t[rs], best_prim[rs], best_kind[rs]
            for s in range(0, len(ks), per):
                kb = ks[s:s + per]
                M = tor.world_to_obj[kb].to(f64)
                oo = torch.stack(
                    [((o64[:, None, 0] * M[None, :, i, 0]
                       + o64[:, None, 1] * M[None, :, i, 1])
                      + o64[:, None, 2] * M[None, :, i, 2])
                     + M[None, :, i, 3] for i in range(3)], dim=-1)
                dd = torch.stack(
                    [(d64[:, None, 0] * M[None, :, i, 0]
                      + d64[:, None, 1] * M[None, :, i, 1])
                     + d64[:, None, 2] * M[None, :, i, 2] for i in range(3)],
                    dim=-1)
                t, _ = torus_geom.torus_intersect(
                    oo, dd, tor.major_radius[kb].to(f64)[None],
                    tor.minor_radius[kb].to(f64)[None], TMIN, tm,
                    newton_iters=3, cubic="trig")
                t = t.to(torch.float32)
                arg = torch.argmin(t, dim=1, keepdim=True)
                tbest = t.gather(1, arg)[:, 0]
                better = tbest < bt
                bt = torch.where(better, tbest, bt)
                bp = torch.where(better, kb[arg[:, 0]].to(torch.int32), bp)
                bk = torch.where(better, 1, bk)
            best_t[rs], best_prim[rs], best_kind[rs] = bt, bp, bk

    if any_hit:
        return best_t < BIG
    return {"t": best_t, "prim": best_prim, "kind": best_kind,
            "u": best_u, "v": best_v}


def _shade(scene: Scene, settings: RenderSettings, origins, dirs, hit):
    """Port of raytrace.rchit:26-135 + rmiss. Returns a per-ray dict."""
    n = origins.shape[0]
    dev = origins.device
    t = hit["t"]
    kind = hit["kind"]
    prim = torch.clamp(hit["prim"], min=0).long()
    missed = kind < 0

    tris = scene.triangles
    tor = scene.tori
    mats = scene.materials

    # hit position along the ray (raytrace.rchit:94,134); t clamped so the
    # BIG miss sentinel doesn't overflow fp32 (missed lanes are masked below)
    tc = torch.clamp(t, max=1.0e8)
    ray_hit_pos = origins + tc[:, None] * dirs

    # --- triangle attributes (interpolated) ---
    # clamp: `prim` is a torus index on torus-hit lanes and may exceed the
    # (tightly padded) triangle count; those lanes are masked by kind below
    tp = torch.clamp(prim, max=tris.count - 1)
    u, v = hit["u"][:, None], hit["v"][:, None]
    w = (1.0 - hit["u"] - hit["v"])[:, None]

    def interp(a0, a1, a2):
        return (a0 * w + a1 * u) + a2 * v

    v0 = tris.v0[tp]
    tri_pos = interp(v0, v0 + tris.e1[tp], v0 + tris.e2[tp])
    tri_nrm = interp(tris.n0[tp], tris.n1[tp], tris.n2[tp])
    tri_uv = interp(tris.uv0[tp], tris.uv1[tp], tris.uv2[tp])
    tri_mat = tris.mat_id[tp]

    # --- torus attributes ---
    k = torch.clamp(prim, max=tor.count - 1)
    M = tor.world_to_obj[k]
    p = ray_hit_pos
    p_obj = torch.stack(
        [((M[:, i, 0] * p[:, 0] + M[:, i, 1] * p[:, 1]) + M[:, i, 2] * p[:, 2])
         + M[:, i, 3] for i in range(3)], dim=-1)
    n_obj = _torus_normal(p_obj, tor.major_radius[k])
    # normal transform: row-vector multiply by world_to_obj linear part
    # == inverse-transpose of obj_to_world (cf. raytrace.rchit:54)
    n_w = torch.stack(
        [(n_obj[:, 0] * M[:, 0, j] + n_obj[:, 1] * M[:, 1, j])
         + n_obj[:, 2] * M[:, 2, j] for j in range(3)], dim=-1)
    n_w = n_w / torch.clamp(_norm(n_w), min=1e-30)[:, None]
    tor_mat = tor.mat_id[k]

    is_tor = kind == 1
    world_pos = torch.where(is_tor[:, None], ray_hit_pos, tri_pos)
    nrm = torch.where(is_tor[:, None], n_w, tri_nrm)
    nrm = nrm / torch.clamp(_norm(nrm), min=1e-30)[:, None]
    mat_id = torch.where(is_tor, tor_mat, tri_mat).long()

    ambient = mats.ambient[mat_id]
    diffuse_c = mats.diffuse[mat_id]
    specular_c = mats.specular[mat_id]
    shininess = mats.shininess[mat_id]
    illum = mats.illum[mat_id]
    tex_id = torch.where(is_tor, -1, mats.texture_id[mat_id])

    # --- light (raytrace.rchit:57-71) ---
    light = settings.light
    lpos = torch.as_tensor(light.position, dtype=torch.float32, device=dev)
    if int(light.type) == LIGHT_POINT:
        ldir = lpos[None, :] - world_pos
        ldist = _norm(ldir)
        d2 = torch.clamp(ldist * ldist, min=1e-20)
        lint = torch.full_like(d2, light.intensity) / d2
        L = ldir / torch.clamp(ldist, min=1e-20)[:, None]
    else:
        L = torch.broadcast_to(lpos / _norm(lpos), world_pos.shape)
        ldist = torch.full((n,), 100000.0, device=dev)
        lint = torch.full((n,), light.intensity, device=dev)

    # --- diffuse (wavefront.glsl:23-31) ---
    ndotl = dot3(nrm, L)
    diffuse = diffuse_c * torch.clamp(ndotl, min=0.0)[:, None]
    diffuse = torch.where((illum >= 1)[:, None], diffuse + ambient, diffuse)

    # texture modulation (raytrace.rchit:79-84), mip LOD as in trace/shade.py
    has_tex = tex_id >= 0
    if bool(has_tex.any()):
        duv1 = tris.uv1[tp] - tris.uv0[tp]
        duv2 = tris.uv2[tp] - tris.uv0[tp]
        uv_area = (duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]).abs()
        world_area = _norm(cross3(tris.e1[tp], tris.e2[tp]))
        density = _sqrt(uv_area / torch.clamp(world_area, min=1e-30))
        tid = torch.clamp(tex_id, min=0).long()
        sizes = scene.textures.sizes
        dim0 = torch.maximum(sizes[tid, 0, 0], sizes[tid, 0, 1]).float()
        texels = tc * float(F32(settings.pixel_spread)) * density * dim0
        lod = torch.log2(torch.clamp(texels, min=1e-20))
        texel = _sample_texture(scene, tid, tri_uv, lod)
        diffuse = torch.where(has_tex[:, None], diffuse * texel, diffuse)

    # --- shadow ray (raytrace.rchit:89-120) ---
    facing = ndotl > 0.0
    shadowed = torch.zeros((n,), dtype=torch.bool, device=dev)
    idx = torch.nonzero(facing & ~missed).flatten()
    if len(idx):
        shadowed[idx] = _closest_hit(scene, ray_hit_pos[idx], L[idx],
                                     tmax=ldist[idx], any_hit=True)

    attenuation_local = torch.where(facing & shadowed, float(F32(0.3)), 1.0)

    # --- specular (wavefront.glsl:34-50), only lit & unshadowed ---
    kshine = torch.clamp(shininess, min=4.0)
    energy = (2.0 + kshine) / (2.0 * math.pi)
    V = -dirs / torch.clamp(_norm(dirs), min=1e-30)[:, None]
    Rv = _reflect(-L, nrm)
    spec = energy * torch.clamp(dot3(V, Rv), min=0.0) ** kshine
    spec = torch.where((illum >= 2) & facing & ~shadowed, spec, 0.0)
    specular = specular_c * spec[:, None]

    hit_value = (attenuation_local * lint)[:, None] * (diffuse + specular)

    # --- miss (raytrace.rmiss:16-22) ---
    clear = torch.as_tensor(settings.clear_color, dtype=torch.float32,
                            device=dev)[:3] * float(F32(0.8))
    hit_value = torch.where(missed[:, None], clear[None, :], hit_value)
    hit_position = torch.where(missed[:, None], 0.0, ray_hit_pos)

    # --- reflection request (raytrace.rchit:122-131) ---
    reflective = (illum == 3) & ~missed
    return {
        "hit_value": hit_value,
        "hit_position": hit_position,
        "atten_factor": torch.where(reflective[:, None], specular_c, 1.0),
        "done": ~reflective,
        "next_origin": world_pos,
        "next_dir": _reflect(dirs, nrm),
    }


def _bilinear_level(scene: Scene, tex_id, level, uv):
    """Bilinear, repeat addressing, at one mip level of the flat atlas."""
    atlas = scene.textures
    off = atlas.offsets[tex_id, level].long()
    hs = atlas.sizes[tex_id, level, 0].long()
    ws = atlas.sizes[tex_id, level, 1].long()
    x = torch.remainder(uv[:, 0], 1.0) * ws.float() - 0.5
    y = torch.remainder(uv[:, 1], 1.0) * hs.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    data = atlas.data

    def tap(xi, yi):
        xi = torch.remainder(xi.long(), ws)
        yi = torch.remainder(yi.long(), hs)
        return data[off + yi * ws + xi]

    return (tap(x0, y0) * (1 - fx) * (1 - fy)
            + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy
            + tap(x0 + 1, y0 + 1) * fx * fy)


def _sample_texture(scene: Scene, tex_id, uv, lod):
    """Trilinear mipmapped sampling (matches trace/shade._sample_texture)."""
    nl = scene.textures.n_levels[tex_id].long()
    lv = torch.minimum(torch.clamp(lod, min=0.0), (nl - 1).float())
    l0 = torch.floor(lv).long()
    l1 = torch.minimum(l0 + 1, nl - 1)
    f = (lv - l0.float())[:, None]
    return (_bilinear_level(scene, tex_id, l0, uv) * (1 - f)
            + _bilinear_level(scene, tex_id, l1, uv) * f)


def render_oracle(scene: Scene, camera, width: int, height: int,
                  settings: RenderSettings | None = None, device="cuda"):
    """Full render. Returns a dict with image (H, W, 3) linear color,
    hit_position (H, W, 3), ray_origin, ray_dir (the RenderedData quartet,
    host_device.h:101-107), as tensors on `device`.

    device: the CUDA device by default; without a GPU that raises (no
    fallback), pass device="cpu" for the CPU."""
    device = check_device(device)
    if settings is None:
        settings = RenderSettings.default()
    settings = autofill_pixel_spread(settings, camera, width, height)
    scene = scene.to(device)
    origins, dirs = camera.generate_rays(width, height, settings,
                                         device=device)
    n = origins.shape[0]

    hit_value = torch.zeros((n, 3), dtype=torch.float32, device=device)
    attenuation = torch.ones((n, 3), dtype=torch.float32, device=device)
    first_hit_pos = torch.zeros((n, 3), dtype=torch.float32, device=device)
    cur_o, cur_d = origins.clone(), dirs.clone()
    idx = torch.arange(n, device=device)

    # bounce loop: port of raytrace.rgen:75-108 (a do-while — the primary
    # segment always traces, even when maxDepth <= 0)
    for depth in range(max(int(settings.max_depth), 1)):
        if len(idx) == 0:
            break
        hit = _closest_hit(scene, cur_o[idx], cur_d[idx])
        sh = _shade(scene, settings, cur_o[idx], cur_d[idx], hit)
        # chit multiplies prd.attenuation *before* rgen accumulates
        # (raytrace.rchit:127 runs before raytrace.rgen:92)
        att = attenuation[idx] * sh["atten_factor"]
        attenuation[idx] = att
        hit_value[idx] = hit_value[idx] + sh["hit_value"] * att
        if depth == 0:
            first_hit_pos[idx] = sh["hit_position"]
        cur_o[idx] = sh["next_origin"]
        cur_d[idx] = sh["next_dir"]
        idx = idx[~sh["done"]]

    shape = (height, width, 3)
    return {
        "image": hit_value.reshape(shape),
        "hit_position": first_hit_pos.reshape(shape),
        "ray_origin": origins.reshape(shape),
        "ray_dir": dirs.reshape(shape),
    }
