"""The scene's tables for the reference, worked out from the benchmark's
scene data (`rtbench.scenedata`): every triangle in world space with its
world vertex normals (by the inverse-transpose, normalized), every torus
with its world-to-object transform, one material row per model."""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def tables(models: list, device, dtype=torch.float32) -> dict:
    v0, v1, v2, n0, n1, n2, tri_mat = ([] for _ in range(7))
    w2o, major, minor, tor_mat = [], [], [], []
    mats = []
    for m in models:
        mid = len(mats)
        mats.append(m.material)
        xf = np.asarray(m.transform, np.float64)
        if m.kind == "torus":
            w2o.append(np.linalg.inv(xf)[:3])
            major.append(m.major)
            minor.append(m.minor)
            tor_mat.append(mid)
            continue
        pos = m.positions.astype(np.float64) @ xf[:3, :3].T + xf[:3, 3]
        nrm = m.normals.astype(np.float64) @ np.linalg.inv(xf)[:3, :3]
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-30)
        i = m.indices
        for lst, a in ((v0, pos[i[:, 0]]), (v1, pos[i[:, 1]]),
                       (v2, pos[i[:, 2]]), (n0, nrm[i[:, 0]]),
                       (n1, nrm[i[:, 1]]), (n2, nrm[i[:, 2]])):
            lst.append(a)
        tri_mat.append(np.full(len(i), mid))

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a, dtype=np.float64).astype(F32),
                               device=device).to(dt)

    def cat(lst, width):
        return (np.concatenate(lst) if lst else np.zeros((0, width)))

    p0, p1, p2 = cat(v0, 3), cat(v1, 3), cat(v2, 3)
    col = {k: np.asarray([mt[k] for mt in mats], np.float64)
           for k in ("ambient", "diffuse", "specular", "shininess")}
    return {
        "device": torch.device(device),
        "v0": t(p0), "e1": t(p1 - p0), "e2": t(p2 - p0),
        "n0": t(cat(n0, 3)), "n1": t(cat(n1, 3)), "n2": t(cat(n2, 3)),
        "tri_mat": torch.as_tensor(cat(tri_mat, 1).reshape(-1).astype(
            np.int64), device=device),
        "w2o": t(np.asarray(w2o).reshape(-1, 3, 4)),
        "major": t(major), "minor": t(minor),
        "tor_mat": torch.as_tensor(np.asarray(tor_mat, np.int64),
                                   device=device),
        "ambient": t(col["ambient"]), "diffuse": t(col["diffuse"]),
        "specular": t(col["specular"]), "shininess": t(col["shininess"]),
        "illum": torch.as_tensor([mt["illum"] for mt in mats],
                                 dtype=torch.int64, device=device),
    }
