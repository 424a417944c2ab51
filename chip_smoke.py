#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, measure.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles the port's CUDA kernels from csrc/;
  3. each kernel against its plain PyTorch twin on the card, same inputs,
     at the main path's shapes (K1 on config 6's 1080p rays, K2 on config 3
     and config 4, K3 on config 3 at 512x512), with CUDA-event timings;
  4. the main path: `render(..., backend="kernel", device="cuda")` at
     1920x1080 for config 3, config 6, config 4 and the toroidal capture,
     plus config 3 at 512x512 (the K3 route), with the kernel launch
     counts of that run; each scene also renders at 480x270 on both
     backends, which must agree;
  5. the goldens of tests/golden on the card.

Any failed check exits 1 without the result lines. On success the line
before the last is the per-kernel JSON summary and the last line is
{"ok": true, "device": {...}}. With no CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")
DEVICE = "cuda"
FULL = (1920, 1080)       # the ladder's frame size
SUBSET = 262144           # rays compared against the dense plain twins
K3_RES = 512              # config 3 at this square size routes to K3
CHECK_RES = (480, 270)    # kernel-vs-torch backend agreement renders
FAILURES: list[str] = []


def check(ok: bool, what: str) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)
    return ok


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `fn` over `reps` runs after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_hits(name, got, ref, n, attr_rows=None, occlusion=False):
    """Print and check kernel-vs-twin agreement. got/ref: (t, idx[, ...]).
    Pass: t within rtol 1e-5 on common hits, mask and idx mismatches at
    most 1e-4 of the rays, attrs within 1e-4."""
    import torch

    hit_g, hit_r = got[0] < 1e30, ref[0] < 1e30
    mask_bad = int((hit_g != hit_r).sum())
    line = f"  {name}: rays {n}, mask mismatches {mask_bad}"
    ok = mask_bad <= 1e-4 * n
    err = 0.0
    if not occlusion:
        both = hit_g & hit_r
        dt = (got[0][both] - ref[0][both]).abs()
        rel = dt / ref[0][both].abs().clamp(min=1e-30)
        err = float(dt.max()) if dt.numel() else 0.0
        idx_bad = int((got[1][both] != ref[1][both]).sum())
        line += (f", common hits {int(both.sum())}, max|dt| {err:.3e}, "
                 f"max rel dt {float(rel.max()) if rel.numel() else 0:.3e}, "
                 f"idx mismatches {idx_bad}")
        ok &= bool((rel <= 1e-5).all()) and idx_bad <= 1e-4 * n
        if attr_rows is not None:
            same = both & (got[1] == ref[1])
            da = (got[attr_rows][:, same] - ref[attr_rows][:, same]).abs()
            amax = float(da.max()) if da.numel() else 0.0
            line += f", attrs max diff {amax:.3e}"
            ok &= amax <= 1e-4
            ok &= bool((got[attr_rows][:, ~hit_g] == 0).all())
    print(line, flush=True)
    check(ok, f"{name} agrees with its plain twin")
    return err


def phase_kernels(torch, results):
    from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
    from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
    from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk
    from toroidal_ray_tracing_tpu_torch.ops import tri_kernel as trk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (round_up,
                                                                  visit_order)
    from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
        _material_rows, _tri_attr_tables)
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)

    dev = torch.device(DEVICE)
    st = RenderSettings.default(max_depth=3)
    gen = torch.Generator().manual_seed(0)

    def rays(cam, w, h):
        o, d = cam.device_rays(cam.ray_params(w, h, st), w, h, st,
                               block=pick_block(w, h), rows=True, device=dev)
        return o.contiguous(), d.contiguous()

    def subset(n, m=SUBSET):
        return torch.randperm(n, generator=gen)[:m].sort().values.to(dev)

    cam36 = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    o, d = rays(cam36, *FULL)
    n_full = o.shape[1]
    sel = subset(n_full)
    os_, ds_ = o[:, sel].contiguous(), d[:, sel].contiguous()
    n_sub = os_.shape[1]

    # --- K1: config 6 mesh, the tables as the main path passes them -------
    print("K1 tri_closest_hit (config 6, 23k-triangle mesh)", flush=True)
    scene = build_scene(procedural.scene_multi_torus(False)).to(dev)
    tri = scene.triangles
    cs, n_cl = scene.cluster_size, scene.cluster_lo.shape[0]
    n_tail = (scene.loose_tris + cs - 1) // cs
    far = torch.full((n_tail, 3), 2.0e38, device=dev)
    clo = torch.cat([scene.cluster_lo[:n_cl - n_tail], far]).contiguous()
    chi = torch.cat([scene.cluster_hi[:n_cl - n_tail], far]).contiguous()
    tables = _tri_attr_tables(scene)
    wrows = trk.woop_rows(tri.woop_o, tri.woop_d)

    def k1(o_, d_, tm, attrs=True, occl=False):
        return trk.tri_closest_hit(o_, d_, tm, tri.woop_o, tri.woop_d, clo,
                                   chi, cs, attr_tables=tables if attrs
                                   else None, occlusion=occl)

    def k1_plain(o_, d_, tm, attrs=True, occl=False):
        order = visit_order(clo, chi, o_, o_.shape[1])
        return trk.tri_closest_hit_plain(o_, d_, tm, wrows, clo, chi, order,
                                         cs, True, tables if attrs else None,
                                         occl)

    tm_sub = torch.full((n_sub,), 1e4, device=dev)
    got = k1(os_, ds_, tm_sub)
    ref = k1_plain(os_, ds_, tm_sub)
    err = compare_hits("closest+attrs", got, ref, n_sub, attr_rows=4)
    # u/v are the true barycentrics on both sides
    same = (got[0] < 1e30) & (ref[0] < 1e30) & (got[1] == ref[1])
    check(bool(((got[2] - ref[2])[same].abs() <= 1e-4).all()
               and ((got[3] - ref[3])[same].abs() <= 1e-4).all()),
          "K1 u/v within 1e-4 on common winners")
    ms = cuda_ms(lambda: k1(os_, ds_, tm_sub))
    plain_ms = cuda_ms(lambda: k1_plain(os_, ds_, tm_sub))
    tm_full = torch.full((n_full,), 1e4, device=dev)
    ms_full = cuda_ms(lambda: k1(o, d, tm_full))
    print(f"  closest+attrs: kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"at {n_sub} rays; kernel {ms_full:.3f} ms at {n_full} rays",
          flush=True)
    # shadow rays toward the light from the closest hits
    hit = got[0] < 1e30
    p = os_ + torch.where(hit, got[0], 0.0)[None, :] * ds_
    L = st.light.position.to(dev)[:, None] - p
    dist = torch.linalg.vector_norm(L, dim=0)
    so, sd = p.contiguous(), (L / dist.clamp(min=1e-20)).contiguous()
    stm = torch.where(hit, dist, 0.0)
    compare_hits("occlusion (shadow rays)",
                 k1(so, sd, stm, False, True), k1_plain(so, sd, stm, False,
                                                        True),
                 n_sub, occlusion=True)
    occ_ms = cuda_ms(lambda: k1(so, sd, stm, False, True))
    occ_plain = cuda_ms(lambda: k1_plain(so, sd, stm, False, True))
    print(f"  occlusion: kernel {occ_ms:.3f} ms vs plain {occ_plain:.3f} ms",
          flush=True)
    results["tri_closest_hit"] = dict(
        source="toroidal_ray_tracing_tpu_torch/csrc/tri_hit.cu",
        replaces="toroidal_ray_tracing_tpu/ops/tri_kernel.py:77",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, rays=n_sub,
        ms_full=ms_full, rays_full=n_full)

    # --- K2: config 3 tori at 1080p, config 4 tori on a subset ------------
    print("K2 torus_closest_hit", flush=True)
    s3 = build_scene(procedural.scene_multi_torus(True)).to(dev)
    tor = s3.tori
    mat3 = _material_rows(s3, tor.mat_id).contiguous()

    def k2(sc, mat, o_, d_, tm, plain=False):
        t = sc.tori
        args = (o_, d_, tm, t.world_to_obj, t.major_radius, t.minor_radius)
        if not plain:
            return tk.torus_closest_hit_chunked(*args, mat_table=mat)
        return tk.torus_chunked_plain(*args[:3], *tk.chunked_inputs(
            o_, t.world_to_obj, t.major_radius, t.minor_radius, mat))

    err3 = compare_hits("config 3 (4 tori) closest+attrs",
                        k2(s3, mat3, o, d, tm_full),
                        k2(s3, mat3, o, d, tm_full, plain=True), n_full,
                        attr_rows=2)
    ms3 = cuda_ms(lambda: k2(s3, mat3, o, d, tm_full))
    plain3 = cuda_ms(lambda: k2(s3, mat3, o, d, tm_full, plain=True))
    print(f"  config 3: kernel {ms3:.3f} ms vs plain {plain3:.3f} ms at "
          f"{n_full} rays", flush=True)
    cam4 = PinholeCamera(eye=(25.0, 18.0, 25.0), center=(0.0, 0.0, 0.0))
    o4, d4 = rays(cam4, *FULL)
    o4s, d4s = o4[:, sel].contiguous(), d4[:, sel].contiguous()
    s4 = build_scene(procedural.scene_instanced_torus_grid(n=1024)).to(dev)
    mat4 = _material_rows(s4, s4.tori.mat_id).contiguous()
    compare_hits("config 4 (1,024 tori) closest+attrs",
                 k2(s4, mat4, o4s, d4s, tm_sub),
                 k2(s4, mat4, o4s, d4s, tm_sub, plain=True), n_sub,
                 attr_rows=2)
    ms4 = cuda_ms(lambda: k2(s4, mat4, o4s, d4s, tm_sub))
    plain4 = cuda_ms(lambda: k2(s4, mat4, o4s, d4s, tm_sub, plain=True))
    ms4_full = cuda_ms(lambda: k2(s4, mat4, o4, d4, tm_full))
    print(f"  config 4: kernel {ms4:.3f} ms vs plain {plain4:.3f} ms at "
          f"{n_sub} rays; kernel {ms4_full:.3f} ms at {n_full} rays",
          flush=True)
    results["torus_closest_hit"] = dict(
        source="toroidal_ray_tracing_tpu_torch/csrc/torus_hit.cu",
        replaces="toroidal_ray_tracing_tpu/ops/torus_kernel.py:136",
        max_abs_err=err3, ms=ms3, plain_ms=plain3, rays=n_full,
        config4_ms=ms4, config4_plain_ms=plain4, config4_rays=n_sub,
        config4_ms_full=ms4_full)

    # --- K3: config 3 tori at 512x512 -------------------------------------
    print("K3 torus_closest_hit_small (config 3 at 512x512)", flush=True)
    o5, d5 = rays(cam36, K3_RES, K3_RES)
    n5 = o5.shape[1]
    tm5 = torch.full((n5,), 1e4, device=dev)
    K3 = tor.major_radius.shape[0]
    check(tk.use_small_kernel(round_up(n5, 2048), K3),
          f"{K3_RES}x{K3_RES} config 3 routes to K3")
    a3 = (o5, d5, tm5, tor.world_to_obj, tor.major_radius, tor.minor_radius)
    par = tk.small_params(tor.world_to_obj, tor.major_radius,
                          tor.minor_radius, mat3)
    err5 = compare_hits(
        "closest+attrs", tk.torus_closest_hit_small(*a3, mat_table=mat3),
        tk.torus_small_plain(o5, d5, tm5, par, True), n5, attr_rows=2)
    ms5 = cuda_ms(lambda: tk.torus_closest_hit_small(*a3, mat_table=mat3))
    plain5 = cuda_ms(lambda: tk.torus_small_plain(o5, d5, tm5, par, True))
    print(f"  kernel {ms5:.3f} ms vs plain {plain5:.3f} ms at {n5} rays",
          flush=True)
    results["torus_closest_hit_small"] = dict(
        source="toroidal_ray_tracing_tpu_torch/csrc/torus_hit.cu",
        replaces="toroidal_ray_tracing_tpu/ops/torus_kernel.py:530",
        max_abs_err=err5, ms=ms5, plain_ms=plain5, rays=n5)


def write_ppm(path, image):
    import numpy as np

    img = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def phase_main_path(torch):
    from toroidal_ray_tracing_tpu_torch import render, tonemap
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        ToroidalCamera)
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)

    cam36 = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    W, H = FULL
    cells = [
        ("config3_multi_torus", procedural.scene_multi_torus(True), cam36,
         RenderSettings.default(max_depth=3), W, H, ["torus_closest_hit"]),
        ("config3_multi_torus_k3", procedural.scene_multi_torus(True), cam36,
         RenderSettings.default(max_depth=3), K3_RES, K3_RES,
         ["torus_closest_hit_small"]),
        ("config6_mesh_torus", procedural.scene_multi_torus(False), cam36,
         RenderSettings.default(max_depth=3), W, H, ["tri_closest_hit"]),
        ("config4_instanced_grid",
         procedural.scene_instanced_torus_grid(n=1024),
         PinholeCamera(eye=(25.0, 18.0, 25.0), center=(0.0, 0.0, 0.0)),
         RenderSettings.default(max_depth=5), W, H, ["torus_closest_hit"]),
        # the capture experiment's settings (reference default depth 10)
        ("cornellish_toroidal_rho4", procedural.scene_cornellish(),
         ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
         RenderSettings.default(rho=4.0), W, H, ["tri_closest_hit"]),
    ]
    scenes = {name: build_scene(sd).to(DEVICE) for name, sd, *_ in cells}
    os.makedirs(OUT_DIR, exist_ok=True)

    # the main path's run: every launch count starts at 0 here
    reset_launches()
    stats = []
    for name, _, cam, st, w, h, needs in cells:
        before = dict(LAUNCHES)

        def run():
            out = render(scenes[name], cam, w, h, st, backend="kernel",
                         device=DEVICE)
            sync(torch)
            return out

        out = run()                                   # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        rays = out["rays_traced"]
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        print(f"{name} {w}x{h}: {ms:.2f} ms/frame (median of 3), "
              f"{rays} rays/frame, {rays / ms / 1e3:.2f} Mrays/s, "
              f"launches {launched}", flush=True)
        img = out["image"]
        check(tuple(img.shape) == (h, w, 3)
              and bool(torch.isfinite(img).all()), f"{name}: image finite")
        for k in needs:
            check(launched[k] > 0, f"{name}: {k} launched")
        stats.append(dict(cell=name, width=w, height=h, ms_per_frame=ms,
                          rays_per_frame=rays,
                          mrays_per_s=rays / ms / 1e3, launches=launched))
    main_launches = dict(LAUNCHES)
    for k, v in main_launches.items():
        check(v > 0, f"main path launched {k} ({v} times)")

    # each scene at 480x270: kernel backend against the torch backend
    cw, ch = CHECK_RES
    for name, _, cam, st, w, h, _ in cells:
        if (w, h) != FULL:
            continue
        a = render(scenes[name], cam, cw, ch, st, backend="kernel",
                   device=DEVICE)
        b = render(scenes[name], cam, cw, ch, st, backend="torch",
                   device=DEVICE)
        diff = (a["image"] - b["image"]).abs()
        rmse = float(diff.pow(2).mean().sqrt())
        bad = int((diff.amax(dim=-1) > 1e-3).sum())
        print(f"{name} {cw}x{ch} kernel vs torch: rmse {rmse:.3e}, "
              f"{bad} pixels off by > 1e-3, rays {a['rays_traced']} vs "
              f"{b['rays_traced']}", flush=True)
        check(rmse < 1e-4 and bad <= 1e-3 * cw * ch,
              f"{name}: kernel backend agrees with torch backend")
        write_ppm(os.path.join(OUT_DIR, f"chip_smoke_{name}.ppm"),
                  tonemap(a["image"]).cpu().numpy())
    return main_launches, stats


def phase_goldens(torch):
    import numpy as np

    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        ToroidalCamera)
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)

    cases = {
        "multi_torus_pinhole": (
            procedural.scene_multi_torus(True),
            PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
            RenderSettings.default(max_depth=3)),
        "cornellish_toroidal": (
            procedural.scene_cornellish(),
            ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
            RenderSettings.default(max_depth=2, rho=5.0)),
        "torus_plane_shadow": (
            procedural.scene_torus_plane(True),
            PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
            RenderSettings.default(max_depth=1,
                                   light_position=(6.0, 10.0, 2.0))),
        "textured_mesh": (
            procedural.scene_textured_mesh(),
            PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
            RenderSettings.default(max_depth=3)),
    }
    for name, (sd, cam, st) in cases.items():
        want = np.load(os.path.join(ROOT, "tests", "golden",
                                    f"{name}.npz"))["image"]
        scene = build_scene(sd).to(DEVICE)
        for backend in ("torch", "kernel"):
            if backend == "kernel" and name == "textured_mesh":
                continue          # textures on the kernel path wait for K4
            got = render(scene, cam, 32, 32, st, backend=backend,
                         device=DEVICE)["image"].cpu().numpy()
            err = float(np.abs(got - want).max())
            check(err < 5e-4, f"golden {name} ({backend}): max diff {err:.2e}")
    # no silent fallback: a textured scene on the kernel backend needs K4
    try:
        render(build_scene(cases["textured_mesh"][0]).to(DEVICE),
               cases["textured_mesh"][1], 8, 8, backend="kernel",
               device=DEVICE)
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    check("K4" in raised, "textured scene on backend='kernel' raises naming K4")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import toroidal_ray_tracing_tpu_torch  # noqa: F401  (sets TF32 off)
    from toroidal_ray_tracing_tpu_torch.ops import kernel_common

    print("== 1. device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}",
          flush=True)

    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    path = kernel_common.build_library()
    kernel_common.library()
    print(f"built {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in kernel_common.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)

    print("== 3. kernels against their plain twins", flush=True)
    results: dict = {}
    phase_kernels(torch, results)

    print("== 4. main path: render(backend='kernel', device='cuda')",
          flush=True)
    launches, stats = phase_main_path(torch)

    print("== 5. goldens on the card", flush=True)
    phase_goldens(torch)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"kernels": results, "cells": stats}, f, indent=1)
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"], launches=launches[k],
                    max_abs_err=v["max_abs_err"], ms=v["ms"],
                    plain_ms=v["plain_ms"], rays=v["rays"])
               for k, v in results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
