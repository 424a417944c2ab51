"""The plain reference that decides `correct`: the reference shader's
semantics written the naive way in PyTorch (and NumPy on the host), a
frozen copy of the repository's oracle arithmetic. It imports neither JAX
nor any part of the program, and takes nothing the program made: it
flattens the scene from the benchmark's own scene data (`scene`), makes
each sampled pixel's rays from the camera and the jitter draw itself
(`raygen`), and traces them with a dense Möller–Trumbore test of every
triangle and a quartic per torus (`tracer`).

`render_pixels` is the entry: the image, first hit and sample-0 ray of a
set of pixels of one frame, in float32 (the configurations' precision) or,
for the control, in a lower `dtype`.
"""

from __future__ import annotations

import torch

from rtbench.reference import raygen, tracer


def render_pixels(tables, camera: dict, rho: float, width: int, height: int,
                  settings: dict, xs, ys, spp: int, seed: int,
                  frame_in_call: int, dtype=torch.float32):
    """Reference outputs of pixels (xs[i], ys[i]) of one frame: {"image",
    "hit_position", "ray_origin", "ray_dir"}, each (P, 3) float32 on the
    tables' device. With spp > 1, sample s adds the jitter the program
    draws: uniform(fold_in(PRNGKey(seed), frame_in_call * spp + s), (W*H,
    2)) at the pixel's trace-order index; the image is the samples' mean;
    the first hit and rays are sample 0's."""
    dev = tables["device"]
    xs = torch.as_tensor(xs, dtype=torch.int64, device=dev)
    ys = torch.as_tensor(ys, dtype=torch.int64, device=dev)
    acc = None
    out = {}
    for s in range(max(spp, 1)):
        jitter = None
        if s > 0:
            key = raygen.fold_in(raygen.prng_key(seed),
                                 frame_in_call * spp + s)
            idx = raygen.trace_index(xs, ys, width, height)
            jitter = raygen.uniform_at(key, idx)
        o, d = raygen.rays(camera, rho, width, height, xs, ys, jitter,
                           dtype)
        color, first = tracer.trace(tables, settings, o, d, dtype)
        acc = color if acc is None else acc + color
        if s == 0:
            out = {"hit_position": first, "ray_origin": o.float(),
                   "ray_dir": d.float()}
    out["image"] = (acc / float(max(spp, 1))).float()
    return out
