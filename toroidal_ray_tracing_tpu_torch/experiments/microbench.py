"""Pass-level microbenchmarks: where does a frame's time go? (The port of the
JAX package's `experiments/microbench.py`.)

Times each stage of the bounce loop in isolation on one ladder scene: K1's
and K2's wrappers, the full closest hit with attributes
(`ops.trace_kernel.closest_hit_kernel`), hit + shade (with its shadow
rays), hit + shadow-ray setup, hit + setup + occlusion, and the trilinear
texture sample on the torch gather and through K4. Each row is the median
of 3 windows of `k` calls after a warm-up call, timed with CUDA events on
the card (the host clock on the CPU), divided by `k`. The JAX module's
scan-in-one-jit windows and their anti-CSE input perturbation are TPU
machinery and have no counterpart: eager calls are never merged. Its
"4-tap" texture row timed the JAX package's pre-packing texel path, which
the port does not have; it is not ported.

    python -m toroidal_ray_tracing_tpu_torch.experiments.microbench \\
        [--scene {3,4,6,7}] [--rays N] [--k K] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
import types

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.render.renderer import check_device

F32 = np.float32
WINDOWS = 3


def time_calls(fn, k: int, device) -> float:
    """Median milliseconds per call over WINDOWS windows of k calls, after
    one warm-up call: CUDA events on a CUDA device, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(WINDOWS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times) / k


def bench_atlas():
    """The texture rows' atlas: a 512x512 RGB texture of
    `np.random.default_rng(5).uniform` draws and its mip chain, as the JAX
    package's microbench builds it, so both packages' texture rows sample
    the same texels."""
    from toroidal_ray_tracing_tpu_torch.scene.build import build_texture_atlas

    texels = np.random.default_rng(5).uniform(size=(512, 512, 3))
    return build_texture_atlas([texels.astype(F32)])


def run(scene_num: int = 3, rays: int = 2 * 1024 * 1024, k: int = 8,
        device="cuda"):
    """The rows for ladder scene `scene_num` on `rays` primary rays (cut to
    a multiple of 2048): a list of (name, ms per call). device: the CUDA
    device by default (raises without a GPU); device="cpu" runs the
    kernels' plain twins."""
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.ops import torus_kernel, tri_kernel
    from toroidal_ray_tracing_tpu_torch.ops.shade_kernel import shade_attrs
    from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
        closest_hit_kernel)
    from toroidal_ray_tracing_tpu_torch.scene.types import _to
    from toroidal_ray_tracing_tpu_torch.trace.intersect import geom_from_scene
    from toroidal_ray_tracing_tpu_torch.trace.shade import (_sample_texture,
                                                            shade)

    if scene_num not in (3, 4, 6, 7):
        raise ValueError(f"microbench scenes are 3, 4, 6 and 7, not "
                         f"{scene_num}")
    device = check_device(device)
    sc = SCENARIOS[scene_num]
    scene = sc.build().to(device)
    cam = sc.camera
    st = sc.settings()
    n = (rays // 2048) * 2048
    side = int(np.ceil(np.sqrt(n)))
    # the textured scene's shade must mip (render's autofill_pixel_spread)
    st.pixel_spread = float(F32(cam.pixel_spread(side, side)))
    st = st.to(device)
    o, d = cam.generate_rays(side, side, st, device=device)
    o = o[:n].T.contiguous()                 # (3, N) rows
    d = d[:n].T.contiguous()
    tmax = torch.full((n,), 10000.0, device=device)
    geom = geom_from_scene(scene)

    tris = scene.triangles
    tri = tri_kernel.tri_tables(geom.woop_o, geom.woop_d, geom.cluster_lo,
                                geom.cluster_hi, scene.cluster_size,
                                (tris.v0, tris.e1, tris.e2, tris.valid))
    tor = torus_kernel.torus_tables(geom.tor_w2o, geom.tor_major,
                                    geom.tor_minor)
    lpos = st.light.position[:, None]

    def tri_pass():
        return tri_kernel.tri_closest_hit(o, d, tmax, tri)

    def tor_pass():
        return torus_kernel.torus_closest_hit_chunked(o, d, tmax, tor)

    def full_hit():
        return closest_hit_kernel(scene, geom, o, d, tmax, want_attrs=True)

    def shade_pass():
        hit = full_hit()
        hit.attrs = shade_attrs(hit, hit.attrs)
        return shade(scene, st, o, d, hit, backend="kernel")

    # the shadow query shade() issues, isolated (raytrace.rchit:89-120):
    # primary hit points toward the light
    def shadow_setup():
        hit = closest_hit_kernel(scene, geom, o, d, tmax)
        hp = o + torch.clamp(hit.t, max=1.0e8)[None, :] * d
        ldir = lpos - hp
        ldist = torch.linalg.vector_norm(ldir, dim=0)
        L = ldir / torch.clamp(ldist, min=1e-20)[None, :]
        stmax = torch.where(hit.kind >= 0, ldist, 0.0)
        return hp.contiguous(), L.contiguous(), stmax

    def occl_pass():
        hp, L, stmax = shadow_setup()
        return closest_hit_kernel(scene, geom, hp, L, stmax, occlusion=True)

    # trilinear mipmapped sampling in isolation: n uvs and lods from the
    # rays against a random 512x512 texture's mip chain
    tex = types.SimpleNamespace(textures=_to(bench_atlas(), device))
    uv = torch.remainder(o[:2] * 0.137 + d[:2], 1.0)
    lod = d[0].abs() * 6.0
    tid = torch.zeros((n,), dtype=torch.int32, device=device)

    def texture(backend):
        return lambda: _sample_texture(tex, tid, uv, lod, backend=backend)

    passes = [
        ("texture sample (torch)", texture("torch")),
        ("texture sample (K4)", texture("kernel")),
        ("tri kernel (K1 wrapper)", tri_pass),
        ("torus kernel (K2 wrapper)", tor_pass),
        ("hit (tri+torus+attrs)", full_hit),
        ("hit + shade (incl shadow)", shade_pass),
        ("hit + shadow-ray setup", shadow_setup),
        ("hit + setup + occlusion", occl_pass),
    ]
    return [(name, time_calls(fn, k, device)) for name, fn in passes], n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=2 * 1024 * 1024)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--scene", type=int, default=3, choices=[3, 4, 6, 7])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    rows, n = run(args.scene, args.rays, args.k, args.device)
    print(f"# scene config {args.scene}, {n} rays, median of {WINDOWS} "
          f"windows of {args.k} calls, {args.device}")
    for name, ms in rows:
        print(f"{name:28s} {ms:9.3f} ms  ({n / ms / 1e3:9.1f} Mrays/s "
              "equivalent)")
    print(json.dumps({"scene": args.scene, "rays": n, "k": args.k,
                      "device": args.device,
                      "rows_ms": {name: ms for name, ms in rows}}))
    return rows


if __name__ == "__main__":
    main()
