"""SceneDef -> trace-ready `Scene` flattening (host side, NumPy).

The replacement for the reference's acceleration-structure build
(`createBottomLevelAS`/`createTopLevelAS`,
VKT/ray_tracing__before/hello_vulkan.cpp:602-687): triangle instances are
baked to world space, sorted into fixed-size clusters with AABBs (binned SAH
through the native library, else Morton order) and given precomputed Woop
transforms. Analytic tori stay parametric: per-instance world/object
transforms plus a world bounding sphere.

Everything runs in NumPy on the host, exactly as the JAX package's build
does (every array is bit-equal to it); only the final leaves become CPU
tensors. `Scene.to(device)` moves them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from toroidal_ray_tracing_tpu_torch.io import native
from toroidal_ray_tracing_tpu_torch.scene.types import (
    Material,
    Scene,
    SceneDef,
    TextureAtlas,
    TriangleMesh,
    TriangleSoup,
    Torus,
    TorusSoup,
    _tensor,
)
from toroidal_ray_tracing_tpu_torch.utils import math3d

F32 = np.float32
I32 = np.int32


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton code from (N,3) centroids normalized to [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def _woop_matrices(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Per-triangle Woop unit-triangle transform.

    M = [e1 e2 n] (columns), W = M^-1, c = -W v0. A ray (o, d) maps to
    o' = W o + c, d' = W d; then t = -o'z/d'z, u = o'x + t d'x,
    v = o'y + t d'y; hit iff u>=0, v>=0, u+v<=1.
    """
    n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    # relative degeneracy test: area^2 vs edge lengths (sin^2 of edge angle)
    n2 = np.einsum("ti,ti->t", n, n)
    scale2 = (np.einsum("ti,ti->t", e1, e1) * np.einsum("ti,ti->t", e2, e2)).astype(np.float64)
    degenerate = (n2 <= 1e-12 * scale2) | (n2 <= 0.0) | ~np.isfinite(n2)
    M = np.stack([e1.astype(np.float64), e2.astype(np.float64), n], axis=2)  # (T,3,3) columns
    M[degenerate] = np.eye(3)
    W = np.linalg.inv(M)
    c = -np.einsum("tij,tj->ti", W, v0.astype(np.float64))
    # degenerate/padding rows become guaranteed misses: d' = 0 => dz = 0
    W[degenerate] = 0.0
    c[degenerate] = (0.0, 0.0, 1.0)
    return W.astype(F32), c.astype(F32), degenerate


LOOSE_MAX_PER_CLUSTER = 8   # a cluster this sparse is mostly padding
LOOSE_TOTAL_MAX = 16        # the kernel backend tests loose rows densely
                            # (loose x rays) — keep it a few columns


def _split_loose_clusters(slots: np.ndarray, cluster_size: int):
    """Compact nearly-empty clusters' live rows into tail clusters.

    Spatially fat primitives (a whole-floor ground plane) end up alone in a
    cluster whose AABB nearly every ray enters. Clusters with
    <= LOOSE_MAX_PER_CLUSTER live rows (when the scene has denser ones)
    move to the END of the table, live rows first: the kernel backend tests
    them densely before the triangle kernel and never walks their clusters.
    When EVERY live cluster is loose (a plane-only triangle set) the whole
    table becomes the tail and no triangle kernel launches at all.
    Returns (new_slots, n_loose)."""
    cs = cluster_size
    C = len(slots) // cs
    blocks = slots.reshape(C, cs)
    live = (blocks >= 0).sum(axis=1)
    loose = (live > 0) & (live <= LOOSE_MAX_PER_CLUSTER)
    if not loose.any():
        return slots, 0
    loose_rows = blocks[loose][blocks[loose] >= 0]
    if not (1 <= len(loose_rows) <= LOOSE_TOTAL_MAX):
        return slots, 0
    dense = blocks[~loose & (live > 0)].reshape(-1)
    n_loose = len(loose_rows)
    tail = np.full(_round_up(n_loose, cs), -1, slots.dtype)
    tail[:n_loose] = loose_rows
    return np.concatenate([dense, tail]), n_loose


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _mip_chain(img: np.ndarray) -> "list[np.ndarray]":
    """Full mip pyramid by 2x2 box filtering (the linear-blit behavior of
    nvvk::cmdGenerateMipmaps, hello_vulkan.cpp:339). Odd dimensions round
    down (floor(d/2), min 1), averaging the even-cropped region."""
    levels = [np.asarray(img[..., :3], F32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        h2, w2 = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
        c = cur[: h2 * 2 or 1, : w2 * 2 or 1]
        if cur.shape[0] == 1:
            nxt = (c[:, 0::2] + c[:, 1::2]) * 0.5
        elif cur.shape[1] == 1:
            nxt = (c[0::2] + c[1::2]) * 0.5
        else:
            nxt = (c[0::2, 0::2] + c[1::2, 0::2]
                   + c[0::2, 1::2] + c[1::2, 1::2]) * 0.25
        levels.append(nxt.astype(F32))
    return levels


def _tex_quantize(m: np.ndarray) -> np.ndarray:
    """(h, w, 3) linear f32 -> gamma-encoded u8, the reference's own texel
    precision (VK_FORMAT_R8G8B8A8_SRGB, hello_vulkan.cpp:289)."""
    g = np.clip(m, 0.0, 1.0).astype(F32) ** F32(1.0 / 2.2)
    return np.round(g * F32(255.0)).astype(np.uint8)


def _quad_pack(m: np.ndarray) -> np.ndarray:
    """(h, w, 3) linear level -> (h*w, 3) u32 rows of wrap-addressed 2x2
    quads: bilinear tap k (t00, t10, t01, t11) in byte k of each channel
    word, so one row fetch gives all four taps."""
    m8 = _tex_quantize(m)
    taps = (m8,
            np.roll(m8, -1, axis=1),
            np.roll(m8, -1, axis=0),
            np.roll(np.roll(m8, -1, axis=0), -1, axis=1))
    words = sum(t.astype(np.uint32) << np.uint32(8 * k)
                for k, t in enumerate(taps))
    return words.reshape(-1, 3)


def _atlas(offsets, sizes, n_levels, data4q_u32) -> TextureAtlas:
    return TextureAtlas(offsets=_tensor(offsets), sizes=_tensor(sizes),
                        n_levels=_tensor(n_levels),
                        data4q=_tensor(data4q_u32.view(np.int32)))


def build_texture_atlas(textures: list) -> TextureAtlas:
    """Pack textures + mip chains into a flat texel buffer (TextureAtlas)."""
    if not textures:
        # dummy white texel (hello_vulkan.cpp:292-309)
        return _atlas(np.zeros((1, 1), I32), np.ones((1, 1, 2), I32),
                      np.ones((1,), I32),
                      np.full((1, 3), 0xFFFFFFFF, np.uint32))
    chains = [_mip_chain(t) for t in textures]
    L = max(len(c) for c in chains)
    n = len(chains)
    offsets = np.zeros((n, L), I32)
    sizes = np.ones((n, L, 2), I32)
    quads = []
    cursor = 0
    for i, chain in enumerate(chains):
        for lv in range(L):
            m = chain[min(lv, len(chain) - 1)]
            if lv < len(chain):
                quads.append(_quad_pack(m))
                offsets[i, lv] = cursor
                cursor += m.shape[0] * m.shape[1]
            else:  # clamp: duplicate the last level's offset
                offsets[i, lv] = offsets[i, lv - 1]
            sizes[i, lv] = (m.shape[0], m.shape[1])
    return _atlas(offsets, sizes, np.asarray([len(c) for c in chains], I32),
                  np.concatenate(quads, axis=0))


def build_scene(
    scene_def: SceneDef,
    cluster_size: int = 128,
    use_native: bool = True,
) -> Scene:
    """Flatten a SceneDef into a trace-ready Scene (CPU tensors).

    cluster_size: triangles per culling cluster. Padded rows are marked
    invalid and never hit. For scenes smaller than one cluster the size
    adapts down (multiple of 8); multi-cluster tables keep 128-multiples
    (the JAX package's kernel needs that, and the build stays bit-equal to
    it).
    """
    materials_rows: list = []
    textures: list = []
    mat_offsets: list = []
    for model in scene_def.models:
        mat_offsets.append(len(materials_rows))
        mats = list(model.materials) if model.materials else [{}]
        for m in mats:
            m = dict(m)
            tid = m.get("texture_id", -1)
            if tid is not None and tid >= 0:
                m["texture_id"] = tid + len(textures)
            materials_rows.append(m)
        if isinstance(model, TriangleMesh):
            textures.extend(model.textures)
    if not materials_rows:
        materials_rows = [{}]

    # --- flatten triangle instances to world space ------------------------
    (v0s, e1s, e2s, n0s, n1s, n2s, uv0s, uv1s, uv2s, c0s, c1s, c2s, mids,
     iids) = ([] for _ in range(14))
    tori_rows = []
    for inst_id, inst in enumerate(scene_def.instances):
        model = scene_def.models[inst.obj_index]
        xform = np.asarray(inst.transform, dtype=F32)
        if isinstance(model, Torus):
            tori_rows.append((inst_id, inst.obj_index, model, xform))
            continue
        mesh: TriangleMesh = model
        if mesh.num_triangles == 0:
            continue
        pos_w = math3d.transform_points(xform, mesh.positions)
        nrm_w = math3d.transform_normals(xform, mesh.normals)
        idx = mesh.indices.astype(I32)
        p0, p1, p2 = pos_w[idx[:, 0]], pos_w[idx[:, 1]], pos_w[idx[:, 2]]
        v0s.append(p0)
        e1s.append(p1 - p0)
        e2s.append(p2 - p0)
        n0s.append(nrm_w[idx[:, 0]])
        n1s.append(nrm_w[idx[:, 1]])
        n2s.append(nrm_w[idx[:, 2]])
        uv = mesh.uvs if mesh.uvs is not None else np.zeros((len(pos_w), 2), F32)
        uv0s.append(uv[idx[:, 0]])
        uv1s.append(uv[idx[:, 1]])
        uv2s.append(uv[idx[:, 2]])
        col = (mesh.colors if getattr(mesh, "colors", None) is not None
               else np.ones((len(pos_w), 3), F32))
        c0s.append(col[idx[:, 0]])
        c1s.append(col[idx[:, 1]])
        c2s.append(col[idx[:, 2]])
        mids.append(mesh.mat_index.astype(I32) + I32(mat_offsets[inst.obj_index]))
        iids.append(np.full(len(idx), inst_id, dtype=I32))

    if v0s:
        v0 = np.concatenate(v0s).astype(F32)
        e1 = np.concatenate(e1s).astype(F32)
        e2 = np.concatenate(e2s).astype(F32)
        n0 = np.concatenate(n0s).astype(F32)
        n1 = np.concatenate(n1s).astype(F32)
        n2 = np.concatenate(n2s).astype(F32)
        uv0 = np.concatenate(uv0s).astype(F32)
        uv1 = np.concatenate(uv1s).astype(F32)
        uv2 = np.concatenate(uv2s).astype(F32)
        c0 = np.concatenate(c0s).astype(F32)
        c1 = np.concatenate(c1s).astype(F32)
        c2 = np.concatenate(c2s).astype(F32)
        mat_id = np.concatenate(mids)
        inst_ids = np.concatenate(iids)
    else:
        v0 = np.zeros((0, 3), F32)
        e1 = e2 = n0 = n1 = n2 = v0
        uv0 = uv1 = uv2 = np.zeros((0, 2), F32)
        c0 = c1 = c2 = np.zeros((0, 3), F32)
        mat_id = np.zeros((0,), I32)
        inst_ids = np.zeros((0,), I32)

    # drop degenerate (zero-area) triangles — e.g. lat-long sphere poles;
    # the hardware pipeline also never reports hits on them
    if v0.shape[0]:
        face_n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
        area2 = np.einsum("ti,ti->t", face_n, face_n)
        edge2 = (np.einsum("ti,ti->t", e1, e1)
                 * np.einsum("ti,ti->t", e2, e2)).astype(np.float64)
        keep = (area2 > 1e-12 * edge2) & (area2 > 0.0) & np.isfinite(area2)
        if not keep.all():
            v0, e1, e2, n0, n1, n2, uv0, uv1, uv2, c0, c1, c2 = (
                a[keep] for a in (v0, e1, e2, n0, n1, n2, uv0, uv1, uv2,
                                  c0, c1, c2))
            mat_id, inst_ids = mat_id[keep], inst_ids[keep]

    n_real = v0.shape[0]
    cluster_size = min(cluster_size, max(_round_up(n_real, 8), 8))
    if n_real > cluster_size and cluster_size % 128 != 0:
        cluster_size = _round_up(cluster_size, 128)

    # --- cluster assignment: native binned-SAH leaves when available, else
    # Morton sort + fixed chunking. `slots` maps padded cluster positions to
    # original triangle rows (-1 = padding). ----------------------------------
    slots = None
    if n_real <= cluster_size:
        use_native = False  # one cluster: nothing to split
    if n_real > 0 and use_native and native.available():
        tri_lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
        tri_hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
        try:
            order, starts, counts = native.build_sah_clusters(
                tri_lo, tri_hi, cluster_size)
        except RuntimeError:
            order = None
        if order is not None:
            n_leaves = len(starts)
            slots = np.full(n_leaves * cluster_size, -1, np.int64)
            for li in range(n_leaves):
                s, cnt = int(starts[li]), int(counts[li])
                slots[li * cluster_size: li * cluster_size + cnt] = \
                    order[s: s + cnt]

    if slots is None:
        if n_real > 0:
            centroid = v0 + (e1 + e2) / F32(3.0)
            lo = centroid.min(axis=0)
            span = np.maximum(centroid.max(axis=0) - lo, F32(1e-6))
            order = np.argsort(_morton3((centroid - lo) / span), kind="stable")
        else:
            order = np.zeros((0,), np.int64)
        T0 = max(_round_up(max(n_real, 1), cluster_size), cluster_size)
        slots = np.full(T0, -1, np.int64)
        slots[:n_real] = order

    slots, n_loose = _split_loose_clusters(slots, cluster_size)

    T = len(slots)
    valid = slots >= 0
    FAR = F32(1e30)

    def take(a, fill=0.0):
        out = np.full((T,) + a.shape[1:], fill, dtype=a.dtype)
        out[valid] = a[np.maximum(slots[valid], 0)]
        return out

    # padding rows are all-zero: degenerate for every intersector (Woop rows
    # are zeroed in _woop_matrices) and harmless when shading gathers them
    v0 = take(v0)
    e1 = take(e1)
    e2 = take(e2)
    n0 = take(n0)
    n1 = take(n1)
    n2 = take(n2)
    uv0 = take(uv0)
    uv1 = take(uv1)
    uv2 = take(uv2)
    c0 = take(c0)
    c1 = take(c1)
    c2 = take(c2)
    mat_id = take(mat_id)
    inst_ids = take(inst_ids, fill=-1)

    W, c, degenerate = _woop_matrices(v0, e1, e2)
    valid &= ~degenerate
    # layout (3, 4, T): output component x input dim x triangle
    A = np.concatenate([W, c[:, :, None]], axis=2)  # (T, 3, 4)
    woop_o = A.transpose(1, 2, 0).astype(F32)
    woop_d = W.transpose(1, 2, 0).astype(F32)

    # cluster AABBs over the clustered array, ignoring padding rows
    C = T // cluster_size
    tri_lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tri_hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    tri_lo[~valid] = FAR
    tri_hi[~valid] = -FAR
    cluster_lo = tri_lo.reshape(C, cluster_size, 3).min(axis=1)
    cluster_hi = tri_hi.reshape(C, cluster_size, 3).max(axis=1)
    # all-invalid clusters: far POINT boxes, not inverted ones (an inverted
    # lo>hi box conservatively PASSES the per-axis-swapped slab test)
    empty_cl = ~valid.reshape(C, cluster_size).any(axis=1)
    cluster_hi[empty_cl] = cluster_lo[empty_cl]

    triangles = TriangleSoup(
        v0=_tensor(v0), e1=_tensor(e1), e2=_tensor(e2),
        n0=_tensor(n0), n1=_tensor(n1), n2=_tensor(n2),
        uv0=_tensor(uv0), uv1=_tensor(uv1), uv2=_tensor(uv2),
        c0=_tensor(c0), c1=_tensor(c1), c2=_tensor(c2),
        mat_id=_tensor(mat_id), instance_id=_tensor(inst_ids),
        valid=_tensor(valid), woop_o=_tensor(woop_o), woop_d=_tensor(woop_d),
    )

    # --- tori: Morton-sorted by world center --------------------------------
    if len(tori_rows) > 1:
        centers = np.stack([x[3][:3, 3] for x in tori_rows]).astype(F32)
        lo_c = centers.min(axis=0)
        span_c = np.maximum(centers.max(axis=0) - lo_c, F32(1e-6))
        order_t = np.argsort(_morton3((centers - lo_c) / span_c), kind="stable")
        tori_rows = [tori_rows[i] for i in order_t]

    K = max(len(tori_rows), 1)
    w2o = np.tile(np.eye(4, dtype=F32)[:3], (K, 1, 1))
    o2w = np.tile(np.eye(4, dtype=F32)[:3], (K, 1, 1))
    majr = np.zeros((K,), F32)
    minr = np.full((K,), F32(-1.0))  # negative => never hit
    t_mid = np.zeros((K,), I32)
    t_iid = np.full((K,), -1, I32)
    t_valid = np.zeros((K,), bool)
    t_center = np.full((K, 3), F32(1e30))
    t_bound = np.zeros((K,), F32)
    for row, (inst_id, obj_index, torus, xform) in enumerate(tori_rows):
        inv = math3d.inverse(xform)
        w2o[row] = inv[:3]
        o2w[row] = xform[:3]
        majr[row] = F32(torus.major_radius)
        minr[row] = F32(torus.minor_radius)
        t_mid[row] = I32(torus.mat_index + mat_offsets[obj_index])
        t_iid[row] = I32(inst_id)
        t_valid[row] = True
        t_center[row] = xform[:3, 3]
        smax = float(np.linalg.norm(xform[:3, :3], ord=2))
        t_bound[row] = F32((torus.major_radius + torus.minor_radius) * smax)

    tori = TorusSoup(
        world_to_obj=_tensor(w2o), obj_to_world=_tensor(o2w),
        major_radius=_tensor(majr), minor_radius=_tensor(minr),
        mat_id=_tensor(t_mid), instance_id=_tensor(t_iid),
        valid=_tensor(t_valid), center=_tensor(t_center),
        bound_radius=_tensor(t_bound),
    )

    return Scene(
        triangles=triangles,
        tori=tori,
        materials=Material.table(materials_rows),
        textures=build_texture_atlas(textures),
        cluster_lo=_tensor(cluster_lo.astype(F32)),
        cluster_hi=_tensor(cluster_hi.astype(F32)),
        cluster_size=cluster_size,
        loose_tris=n_loose,
    )


def refit_instance(scene: Scene, instance_id: int, old_transform,
                   new_transform) -> Scene:
    """Per-frame TLAS refit analog: re-bake ONE instance's world-space rows
    (the JAX package's `scene.build.refit_instance`, the same NumPy
    arithmetic, so every refit array is bit-equal to its refit).

    The reference's `updateSubjectPosition` re-translates instance 0 (the
    `cube_multi` subject) to the camera eye every frame and refits the TLAS
    (VKT/ray_tracing__before/hello_vulkan.cpp:963-986, update=true). Only
    rows whose `instance_id` matches are transformed (Woop matrices and the
    AABBs of the clusters they live in are recomputed); the cluster order,
    materials and textures are untouched.

    old/new_transform: the instance's previous and next 4x4 world transforms
    (the caller, e.g. experiments.rho_sweep's subject_follow, tracks them).
    `scene` may live on any device and is not modified; the returned Scene
    lives on the same device, shares the untouched tensors, and starts with
    an empty `kernel_tables` (its trees, Woop rows and boxes are stale).
    """
    device = scene.device

    def host(t):
        """A writable host copy (never a view of the input's memory)."""
        return t.detach().cpu().numpy().copy()

    def dev(a):
        return _tensor(a).to(device)

    delta = (np.asarray(new_transform, np.float64)
             @ np.linalg.inv(np.asarray(old_transform, np.float64)))
    R = delta[:3, :3].astype(F32)
    t = delta[:3, 3].astype(F32)
    Ninv = np.linalg.inv(delta[:3, :3]).T.astype(F32)  # normal transform

    tris = scene.triangles
    mask = host(tris.instance_id) == instance_id
    new_tris = tris
    cluster_lo = host(scene.cluster_lo)
    cluster_hi = host(scene.cluster_hi)
    if mask.any():
        arrs = {f: host(getattr(tris, f))
                for f in ("v0", "e1", "e2", "n0", "n1", "n2")}
        arrs["v0"][mask] = arrs["v0"][mask] @ R.T + t
        for f in ("e1", "e2"):
            arrs[f][mask] = arrs[f][mask] @ R.T
        for f in ("n0", "n1", "n2"):
            n = arrs[f][mask] @ Ninv.T
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            arrs[f][mask] = (n / np.maximum(ln, F32(1e-30))).astype(F32)

        W, c, degenerate = _woop_matrices(arrs["v0"][mask], arrs["e1"][mask],
                                          arrs["e2"][mask])
        A = np.concatenate([W, c[:, :, None]], axis=2)   # (n, 3, 4)
        woop_o = host(tris.woop_o)
        woop_d = host(tris.woop_d)
        woop_o[:, :, mask] = A.transpose(1, 2, 0)
        woop_d[:, :, mask] = W.transpose(1, 2, 0)
        valid = host(tris.valid)
        valid[mask] &= ~degenerate

        # recompute AABBs only for clusters containing touched rows
        cs = scene.cluster_size
        touched = np.unique(np.nonzero(mask)[0] // cs)
        v0, e1, e2 = arrs["v0"], arrs["e1"], arrs["e2"]
        FAR = F32(1e30)
        for ci in touched:
            rows = slice(ci * cs, (ci + 1) * cs)
            lo = np.minimum(np.minimum(v0[rows], v0[rows] + e1[rows]),
                            v0[rows] + e2[rows])
            hi = np.maximum(np.maximum(v0[rows], v0[rows] + e1[rows]),
                            v0[rows] + e2[rows])
            lo[~valid[rows]] = FAR
            hi[~valid[rows]] = -FAR
            cluster_lo[ci] = lo.min(axis=0)
            cluster_hi[ci] = hi.max(axis=0)
            if not valid[rows].any():
                # all-invalid cluster: far POINT box (an inverted lo>hi box
                # conservatively PASSES the per-axis-swapped slab test)
                cluster_hi[ci] = cluster_lo[ci]
        new_tris = dataclasses.replace(
            tris, valid=dev(valid), woop_o=dev(woop_o), woop_d=dev(woop_d),
            **{f: dev(a) for f, a in arrs.items()})

    tor = scene.tori
    mask_t = host(tor.instance_id) == instance_id
    new_tor = tor
    if mask_t.any():
        o2w = host(tor.obj_to_world)
        w2o = host(tor.world_to_obj)
        center = host(tor.center)
        bound = host(tor.bound_radius)
        major = host(tor.major_radius)
        minor = host(tor.minor_radius)
        for i in np.nonzero(mask_t)[0]:
            full = np.concatenate([o2w[i], [[0, 0, 0, 1]]], axis=0)
            new_full = delta @ full
            o2w[i] = new_full[:3].astype(F32)
            w2o[i] = np.linalg.inv(new_full)[:3].astype(F32)
            center[i] = new_full[:3, 3].astype(F32)
            smax = float(np.linalg.norm(new_full[:3, :3], ord=2))
            R_t = float(major[i] + minor[i])
            bound[i] = F32(R_t * smax)
        new_tor = dataclasses.replace(
            tor, obj_to_world=dev(o2w), world_to_obj=dev(w2o),
            center=dev(center), bound_radius=dev(bound))

    # a new Scene: `kernel_tables` (init=False) starts empty
    return dataclasses.replace(scene, triangles=new_tris, tori=new_tor,
                               cluster_lo=dev(cluster_lo.astype(F32)),
                               cluster_hi=dev(cluster_hi.astype(F32)))
