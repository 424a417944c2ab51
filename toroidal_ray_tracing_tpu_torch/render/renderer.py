"""Top-level render entry points: `render` (one frame), `render_sequence`
and `render_frames` (many frames).

One call replaces the reference's per-frame command buffer (`raytrace()` +
offscreen image + RenderedData SSBO,
VKT/ray_tracing__before/hello_vulkan.cpp:936-958): generate rays for the
camera, run the wavefront bounce loop, and return the image plus the
`RenderedData` quartet (pos / color / rayOrigin / rayDir,
shaders/host_device.h:101-107).

The image is linear color; `tonemap` applies the post pass's gamma
(post.frag:35-36) for display. Every entry point renders on the CUDA device
unless the caller passes `device="cpu"`; without a GPU, the default raises.

Each call runs inside a `utils.profiling.span` named `trt.door.<name>`,
and its stages inside `trt.door.setup` (device check, the scene's and
settings' copies, output allocation), `trt.raygen` (the jitter draw and R1
of one batch), the bounce loop's spans (`trace.wavefront`) and
`trt.finish` (F1 of one frame). Each finished frame adds one to
`utils.profiling.COUNTERS["frames"]`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel
from toroidal_ray_tracing_tpu_torch.ops.front_kernel import (frame_finish,
                                                             raygen_state)
from toroidal_ray_tracing_tpu_torch.scene.types import RenderSettings, Scene
from toroidal_ray_tracing_tpu_torch.trace.wavefront import (lane_count,
                                                            new_state,
                                                            trace_rays,
                                                            trace_state)
from toroidal_ray_tracing_tpu_torch.utils import prng
from toroidal_ray_tracing_tpu_torch.utils.profiling import COUNTERS, span

F32 = np.float32
INV_GAMMA = float(F32(1.0 / 2.2))


def tonemap(image):
    """Post-pass gamma (pow(color, 1/2.2), post.frag:35-36)."""
    return torch.pow(torch.clamp(image, min=0.0), INV_GAMMA)


def autofill_pixel_spread(settings: RenderSettings, camera, width, height):
    """Fill `pixel_spread` from the camera when unset (0) — the reference's
    sampler is always mipmapped (hello_vulkan.cpp:315-339). A negative
    value forces level-0 sampling."""
    ps = float(settings.pixel_spread)
    if ps == 0.0 and hasattr(camera, "pixel_spread"):
        return dataclasses.replace(
            settings, pixel_spread=float(F32(camera.pixel_spread(width,
                                                                 height))))
    if ps < 0.0:
        return dataclasses.replace(settings, pixel_spread=0.0)
    return settings


def _trace_frames(scene, settings, cams, width, height, backend, jitter_key,
                  device):
    """R1 + the bounce loop of one wavefront batch: each (camera, params)
    of `cams` writes its frame's rays, in block-major pixel order (each
    warp of a trace kernel covers a compact screen patch), straight into
    its columns of the loop's state (`ops.front_kernel.raygen_state`, the
    last also the dead tail lanes), jittered by
    `prng.uniform(jitter_key, (W*H, 2))` unless jitter_key is None.
    Returns the loop's `Traced`."""
    n = width * height
    total = n * len(cams)
    with span("trt.raygen"):
        jitter = (None if jitter_key is None else
                  threefry_kernel.uniform(jitter_key, (n, 2), device))
        lanes = lane_count(total, backend)
        state, active = new_state(lanes, device)
        block = pick_block(width, height)
        for g, (cam, params) in enumerate(cams):
            raygen_state(cam.KIND, params, width, height, jitter, block,
                         state, active, g * n,
                         lanes - total if g == len(cams) - 1 else 0)
    return trace_state(scene, settings, state, active, total, backend)


def _finish(traced, cam, params, width, height, off, outs, s, spp,
            chw=False):
    """F1 (`ops.front_kernel.frame_finish`): the frame at lanes [off, off +
    W*H) of the batch into outs[0], sample s of spp, and on sample 0 the
    dumps into outs[1:] (when there), row-major (H, W, 3), or (3, H, W)
    with chw. The last sample finishes the frame (`COUNTERS["frames"]`)."""
    with span("trt.finish"):
        frame_finish(cam.KIND, params, width, height,
                     pick_block(width, height), traced.state, traced.first,
                     traced.slot, off, outs[0], s, spp,
                     tuple(outs[1:]) if s == 0 and len(outs) > 1 else None,
                     chw)
    if s == spp - 1:
        COUNTERS["frames"] += 1


def _render_banded(scene, camera, width, height, settings, backend, spp,
                   seed, device, tile_rows):
    """Row-band rendering: bounds the live ray state for very large frames.
    Bands trace row-major slices of the full-frame rays. Each jittered
    sample steps the reference's split chain from PRNGKey(seed)
    (`key, sub = split(key)`), so a banded spp > 1 image is another draw
    than the unbanded one, as in the JAX package."""
    n = width * height
    key = prng.prng_key(seed)
    bands = [(y0, min(tile_rows, height - y0))
             for y0 in range(0, height, tile_rows)]
    color = torch.zeros((n, 3), dtype=torch.float32, device=device)
    hitpos = orig0 = dir0 = None
    nrays = 0
    for s in range(max(spp, 1)):
        jitter = None
        if s > 0:
            key, sub = prng.split(key)
            jitter = threefry_kernel.uniform(sub, (n, 2), device)
        o_full, d_full = generate_rays(camera, width, height, settings,
                                       jitter=jitter, device=device)
        if s == 0:
            orig0, dir0 = o_full, d_full
            hitpos = torch.zeros_like(o_full)
        for y0, rows in bands:
            sl = slice(y0 * width, (y0 + rows) * width)
            c, hp, nr = trace_rays(scene, settings,
                                   o_full[sl].T.contiguous(),
                                   d_full[sl].T.contiguous(), backend)
            color[sl] += c.T
            nrays += nr
            if s == 0:
                hitpos[sl] = hp.T
    shape = (height, width, 3)
    return {
        "image": (color / float(max(spp, 1))).reshape(shape),
        "hit_position": hitpos.reshape(shape),
        "ray_origin": orig0.reshape(shape),
        "ray_dir": dir0.reshape(shape),
        "rays_traced": nrays,
    }


def check_device(device) -> torch.device:
    """The torch.device to render on; a CUDA device without a GPU raises
    (there is no CPU fallback). "cuda" resolves to the current card's
    index, so it compares equal to the device of a tensor there."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"render on {device}: no CUDA device "
                               "available (pass device='cpu' to render on "
                               "the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def settings_to(settings: RenderSettings, device,
                kept: dict) -> RenderSettings:
    """settings on `device`. Its two host tensors (clear color, light
    position) are uploaded once for their values and kept in `kept` (the
    scene's `kernel_tables`, one entry a device, replaced by other
    values): a closed-loop client hands equal settings every call, which
    then share one device copy (and the scene's kept shading constants,
    `ops.shade_kernel.kept_shade_params`). Tensors that need a gradient, or
    are not on the host, go as `RenderSettings.to` takes them."""
    cc, lp = settings.clear_color, settings.light.position
    if (device.type == "cpu" or cc.device.type != "cpu"
            or lp.device.type != "cpu" or cc.requires_grad
            or lp.requires_grad):
        return settings.to(device)
    values = tuple((t.dtype, tuple(t.shape), t.numpy().tobytes())
                   for t in (cc, lp))
    entry = kept.get(("settings", device))
    if entry is None or entry[0] != values:
        entry = kept[("settings", device)] = (values, cc.to(device),
                                              lp.to(device))
    return dataclasses.replace(
        settings, clear_color=entry[1],
        light=dataclasses.replace(settings.light, position=entry[2]))


def _setup(scene, settings, camera, width, height, device):
    """Check the device and move the scene (once per scene object, see
    `Scene.to`) and settings (`settings_to`) onto it."""
    device = check_device(device)
    if settings is None:
        settings = RenderSettings.default()
    settings = autofill_pixel_spread(settings, camera, width, height)
    scene = scene.to(device)
    return scene, settings_to(settings, device, scene.kernel_tables), device


def _spp_frame(scene, settings, camera, width, height, backend, spp,
               sample_key, device, outs=None, chw=False):
    """One frame's spp samples, the centered one first (it also provides
    the hit/ray dumps); sample s >= 1 adds the jitter
    `prng.uniform(sample_key(s), (n, 2))`, drawn on `device` (the threefry
    kernel on the card, `ops.threefry_kernel`) and taken by the rays in
    their trace order, as the JAX package's. Each sample is R1, the bounce
    loop and F1, which accumulates the image in place. outs: the (image,
    hit_position, ray_origin, ray_dir) tensors to write, or (image,) with
    no dumps, each (H, W, 3) or (3, H, W) with chw; None makes the four
    (H, W, 3). Returns (outs, the exact ray count)."""
    params = camera.ray_params(width, height, settings)
    if outs is None:
        with span("trt.door.setup"):
            outs = tuple(torch.empty((height, width, 3), dtype=torch.float32,
                                     device=device) for _ in range(4))
    nrays = 0
    spp = max(spp, 1)
    for s in range(spp):
        traced = _trace_frames(scene, settings, [(camera, params)], width,
                               height, backend,
                               None if s == 0 else sample_key(s), device)
        _finish(traced, camera, params, width, height, 0, outs, s, spp, chw)
        nrays += traced.rays
    return outs, nrays


def render(scene: Scene, camera, width: int, height: int,
           settings: RenderSettings | None = None, backend: str = "torch",
           spp: int = 1, seed: int = 0, tile_rows: int | None = None,
           device="cuda"):
    """Render one frame.

    backend: "torch" (plain tensor ops) or "kernel" (the hand-written
         closest-hit and texture kernels on CUDA; their plain twins on the
         CPU).
    spp: samples per pixel; > 1 adds jittered samples after the centered
         one, sample s drawn as the JAX package's `render` draws it:
         `jax.random.uniform(fold_in(PRNGKey(seed), s), (W*H, 2))`
         (`utils.prng`), on `device` (on the card by the threefry kernel,
         `ops.threefry_kernel`). With tile_rows, the samples step
         the reference's banded split chain instead.
    tile_rows: render in horizontal bands of this many rows.
    device: where to render, the CUDA device by default. Without a GPU
         that raises — there is no CPU fallback; pass device="cpu" for the
         CPU.

    Returns a dict: image, hit_position, ray_origin, ray_dir — each
    (H, W, 3) — and rays_traced (int).
    """
    with span("trt.door.render"):
        with span("trt.door.setup"):
            scene, settings, device = _setup(scene, settings, camera, width,
                                             height, device)
        if tile_rows is not None and tile_rows < height:
            return _render_banded(scene, camera, width, height, settings,
                                  backend, spp, seed, device, tile_rows)
        root = prng.prng_key(seed)
        (image, hitpos, origins, dirs), nrays = _spp_frame(
            scene, settings, camera, width, height, backend, spp,
            lambda s: prng.fold_in(root, s), device)
    return {
        "image": image,
        "hit_position": hitpos,
        "ray_origin": origins,
        "ray_dir": dirs,
        "rays_traced": nrays,
    }


def _frame_groups(n_frames: int, width: int, height: int, spp: int,
                  frames_per_batch: int | None):
    """Frames traced per wavefront batch: `frames_per_batch`, or (None) the
    largest divisor of the frame count that keeps a batch within ~2M rays
    (the JAX package's rule; spp > 1 traces frames one by one)."""
    if frames_per_batch is not None:
        group = frames_per_batch
    else:
        group = 1
        if spp <= 1:
            target = max(1, (2 * 1024 * 1024) // max(width * height, 1))
            for g in range(2, n_frames + 1):
                if n_frames % g == 0 and g <= target:
                    group = g
    if group > 1 and (spp > 1 or n_frames % group):
        raise ValueError(f"frames_per_batch={group} needs spp == 1 and a "
                         f"frame count ({n_frames}) it divides")
    return max(group, 1)


def _frames(scene, cameras, width, height, settings, backend, spp, seed,
            frames_per_batch, device, n_bufs, chw):
    """Render the cameras' frames into `n_bufs` stacked outputs, (F, H, W,
    3), or (F, 3, H, W) with chw: the images, then (n_bufs == 4) the
    hit_position, ray_origin and ray_dir dumps; n_bufs == 0 keeps no image
    (each frame is finished into one scratch image). Returns (the outputs,
    the total ray count).

    With spp > 1, sample s of frame f draws its jitter from the key
    fold_in(PRNGKey(seed), f * spp + s), as the JAX package's sequence
    front doors do: frame 0 equals render(cameras[0], spp=spp, seed=seed).
    A group of frames (frames_per_batch) is traced as one wavefront batch:
    each camera's rays fill its columns of the state (R1) and F1 finishes
    each frame from its columns; every per-ray result is the frame's own."""
    with span("trt.door.setup"):
        scene, settings, device = _setup(scene, settings, cameras[0], width,
                                         height, device)
        group = _frame_groups(len(cameras), width, height, spp,
                              frames_per_batch)
        frame = (3, height, width) if chw else (height, width, 3)
        f32 = dict(dtype=torch.float32, device=device)
        bufs = tuple(torch.empty((len(cameras), *frame), **f32)
                     for _ in range(n_bufs))
        scratch = (torch.empty(frame, **f32),) if not n_bufs else None

    def outs(f):
        return scratch or tuple(b[f] for b in bufs)

    total = 0
    if group == 1:
        root = prng.prng_key(seed)
        for f, cam in enumerate(cameras):
            total += _spp_frame(
                scene, settings, cam, width, height, backend, spp,
                lambda s, f=f: prng.fold_in(root, f * spp + s), device,
                outs(f), chw)[1]
        return bufs, total
    n = width * height
    for f0 in range(0, len(cameras), group):
        cams = [(cam, cam.ray_params(width, height, settings))
                for cam in cameras[f0:f0 + group]]
        traced = _trace_frames(scene, settings, cams, width, height,
                               backend, None, device)
        for g, (cam, params) in enumerate(cams):
            _finish(traced, cam, params, width, height, g * n, outs(f0 + g),
                    0, 1, chw)
        total += traced.rays
    return bufs, total


def render_sequence(scene: Scene, cameras, width: int, height: int,
                    settings: RenderSettings | None = None,
                    backend: str = "torch", spp: int = 1, seed: int = 0,
                    keep_images: bool = True,
                    frames_per_batch: int | None = None, device="cuda"):
    """Render an animated frame sequence, one camera per frame (the
    reference's frame loop with the camera animating between captures,
    main.cpp:269-403).

    keep_images: False returns only the ray count (throughput runs).
    frames_per_batch: trace this many frames' rays as one wavefront batch
         (None = enough frames to fill ~2M-ray batches, dividing the frame
         count; 1 disables; needs spp == 1).
    spp / seed: as `render`, but sample s of frame f draws from
         fold_in(PRNGKey(seed), f * spp + s) (the JAX package's rule).
    device: as `render` (the CUDA device unless device="cpu").

    Returns {"images": (F, H, W, 3) linear color (if keep_images),
             "rays_traced": int}.
    """
    with span("trt.door.render_sequence"):
        bufs, total = _frames(scene, cameras, width, height, settings,
                              backend, spp, seed, frames_per_batch, device,
                              int(keep_images), chw=False)
    out = {"rays_traced": total}
    if keep_images:
        out["images"] = bufs[0]
    return out


def render_frames(scene: Scene, cameras, width: int, height: int,
                  settings: RenderSettings | None = None,
                  backend: str = "torch", spp: int = 1, seed: int = 0,
                  dumps: bool = True, frames_per_batch: int | None = None,
                  device="cuda"):
    """Render a batch of frames, each with the full RenderedData set.

    cameras: a list of cameras (one per frame) or a single camera.
    dumps: False skips the per-frame hit_position / ray buffers.
    frames_per_batch, spp, seed, device: as `render_sequence`.

    Outputs are channel-major, as the JAX package's: {"images": (F, 3, H,
    W) linear color, "hit_positions" / "ray_origins" / "ray_dirs": (F, 3,
    H, W) (when dumps), "rays_traced": int}.
    """
    if not isinstance(cameras, (list, tuple)):
        cameras = [cameras]
    keys = ("images", "hit_positions", "ray_origins", "ray_dirs")
    with span("trt.door.render_frames"):
        bufs, total = _frames(scene, cameras, width, height, settings,
                              backend, spp, seed, frames_per_batch, device,
                              4 if dumps else 1, chw=True)
    out = dict(zip(keys, bufs))
    out["rays_traced"] = total
    return out
