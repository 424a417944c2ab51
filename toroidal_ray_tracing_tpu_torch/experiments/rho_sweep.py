"""App-1 experiment script: the rho sweep capture protocol (the port of the
JAX package's `experiments/rho_sweep.py`; the same files).

Replicates VKT/ray_tracing__before/main.cpp:239-257,337-341,376-402:
render the scene through the toroidal camera for rho = 4.0 .. 10.0 in 0.5
steps (the reference advances every 60 frames purely to let the UI breathe —
one render per step here unless `frames_per_step` says otherwise), dumping
per-step position + color text files, and optionally the per-pixel ray
origins/directions.

The reference's `updateSubjectPosition` (hello_vulkan.cpp:963-986) pins
instance 0 — the `cube_multi` "subject" avatar — to the camera eye EVERY
frame via a TLAS refit (update=true); `subject_follow=True` replicates that
with `scene.build.refit_instance`, an incremental re-bake of instance 0's
rows only. With `camera_path` the camera animates across the sweep and the
subject tracks each new eye — the moving-camera case the reference's render
loop handles (main.cpp:296-300).

Run: python -m toroidal_ray_tracing_tpu_torch.experiments.rho_sweep --out DIR
[--obj PATH[@x,y,z[,s[,ry]]] ...] (renders on the CUDA device; --device cpu
for the CPU).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import os

import numpy as np

from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
from toroidal_ray_tracing_tpu_torch.io import dumps
from toroidal_ray_tracing_tpu_torch.render.renderer import (check_device,
                                                            render,
                                                            render_sequence)
from toroidal_ray_tracing_tpu_torch.scene import RenderSettings, build_scene
from toroidal_ray_tracing_tpu_torch.scene.build import refit_instance

F32 = np.float32
RHO_START = 4.0   # main.cpp:245
RHO_END = 10.0    # main.cpp:399-402
RHO_STEP = 0.5    # main.cpp:339
DUMP_KEYS = ("image", "hit_position", "ray_origin", "ray_dir")


def rho_values():
    return [RHO_START + i * RHO_STEP
            for i in range(int(round((RHO_END - RHO_START) / RHO_STEP)) + 1)]


def run_sweep(
    scene_def,
    out_dir: str,
    camera: ToroidalCamera | None = None,
    width: int = 1920,   # SAMPLE_WIDTH/HEIGHT (main.cpp:77-78)
    height: int = 1080,
    settings: RenderSettings | None = None,
    backend: str = "kernel",
    save_rays: bool = True,
    subject_follow: bool = False,
    save_npz: bool = False,
    camera_path=None,
    frames_per_step: int = 1,
    device="cuda",
):
    """Run the full sweep; returns the list of written files.

    camera_path: optional callable step -> ToroidalCamera animating the
    camera across the sweep; with subject_follow, instance 0 is refit to
    each frame's eye (updateSubjectPosition semantics).

    frames_per_step: render this many frames per rho step, dumping from
    the LAST one — the reference's literal capture cadence (it advances
    rho only every 60 frames, main.cpp:337-341). The extra frames run as
    one `render_sequence` (keep_images=False), then the dump frame renders
    through `render`.

    device: where to render, the CUDA device unless device="cpu" (without
    a GPU the default raises). The scene moves there once.
    """
    device = check_device(device)
    if camera is None:
        # reference default pose: lookat (0,0,0) -> (10,0,0) (main.cpp:123-133)
        camera = ToroidalCamera(eye=(0.0, 0.0, 0.0), center=(10.0, 0.0, 0.0))
    if settings is None:
        settings = RenderSettings.default()
    os.makedirs(out_dir, exist_ok=True)

    subject_xf = None
    if subject_follow and scene_def.instances:
        cam0 = camera_path(0) if camera_path is not None else camera
        xf = np.array(scene_def.instances[0].transform, copy=True)
        xf[:3, 3] = np.asarray(cam0.eye, F32)
        scene_def.instances[0].transform = xf
        subject_xf = xf
    scene = build_scene(scene_def).to(device)

    # Step i+1 renders while step i's text serialization (~80 MB of
    # formatted rows per 1080p step) runs on worker threads: the native
    # writer releases the GIL inside its ctypes call. Only host numpy
    # arrays and file IO cross into the pool.
    written = []
    pool = cf.ThreadPoolExecutor(max_workers=3)
    futures = []

    def harvest(i, rho, out):
        """Copy step i's buffers to the host (main thread) and hand the
        serialization to the pool."""
        host = {k: out[k].cpu().numpy() for k in DUMP_KEYS}
        futures.append(pool.submit(dumps.write_rendered_position, out_dir,
                                   rho, host["hit_position"]))
        futures.append(pool.submit(dumps.write_color_image, out_dir, rho,
                                   host["image"]))
        if save_rays and i == 0:  # reference writes rays once per run
            futures.append(pool.submit(dumps.write_rendered_rays, out_dir,
                                       host["ray_origin"], host["ray_dir"]))
        if save_npz:
            futures.append(pool.submit(
                dumps.save_render_npz,
                os.path.join(out_dir,
                             f"render_rho{dumps.rho_tag(rho)}.npz"), host))

    try:
        prev = None
        for i, rho in enumerate(rho_values()):
            if camera_path is not None:
                camera = camera_path(i)
                if subject_xf is not None:
                    new_xf = np.array(subject_xf, copy=True)
                    new_xf[:3, 3] = np.asarray(camera.eye, F32)
                    scene = refit_instance(scene, 0, subject_xf, new_xf)
                    subject_xf = new_xf
            st = dataclasses.replace(settings, rho=float(F32(rho)))
            if frames_per_step > 1:
                # frames 1 .. N-1 of the reference's 60-frame step loop:
                # same pose, no dumps (the reference's extras only fed
                # the interactive UI)
                render_sequence(scene, [camera] * (frames_per_step - 1),
                                width, height, st, backend=backend,
                                keep_images=False, device=device)
            out = render(scene, camera, width, height, st, backend=backend,
                         device=device)
            if prev is not None:
                harvest(*prev)   # step i rendered; i-1 drains meanwhile
            prev = (i, rho, out)
        harvest(*prev)
        for f in futures:
            res = f.result()
            written.extend(res if isinstance(res, tuple) else [res])
    finally:
        pool.shutdown(wait=True)
    return written


def main(argv=None):
    from toroidal_ray_tracing_tpu_torch.experiments.scene_args import (
        add_scene_args, scene_def_from_args)

    ap = argparse.ArgumentParser(description=__doc__)
    add_scene_args(ap)  # --scene NAME | --obj PATH[@x,y,z[,s[,ry]]] ...
    ap.add_argument("--out", required=True)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--backend", default="kernel", choices=["torch", "kernel"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eye", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--center", type=float, nargs=3, default=(10.0, 0.0, 0.0))
    ap.add_argument("--max-depth", type=int, default=10)
    ap.add_argument("--subject-follow", action="store_true")
    ap.add_argument("--npz", action="store_true")
    ap.add_argument("--frames-per-step", type=int, default=1,
                    help="frames rendered per rho step (60 = the "
                         "reference's literal UI cadence, main.cpp:337-341)")
    args = ap.parse_args(argv)

    scene_def = scene_def_from_args(args)
    cam = ToroidalCamera(eye=tuple(args.eye), center=tuple(args.center))
    st = RenderSettings.default(max_depth=args.max_depth)
    files = run_sweep(scene_def, args.out, cam, args.width, args.height, st,
                      backend=args.backend, subject_follow=args.subject_follow,
                      save_npz=args.npz, frames_per_step=args.frames_per_step,
                      device=args.device)
    print(f"wrote {len(files)} files under {args.out}")


if __name__ == "__main__":
    main()
