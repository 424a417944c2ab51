"""The system under test: the program's scene types and front doors, driven
by a configuration and the generator's calls. This is the only module of
the harness that imports the program (`toroidal_ray_tracing_tpu_torch`),
with `kernel_bytes` and `metrics/` reading its counters.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rtbench import scenedata

OUTPUT_KEYS = ("image", "hit_position", "ray_origin", "ray_dir")


def scene_def(models: list):
    """The program's `SceneDef` of the scene's models."""
    from toroidal_ray_tracing_tpu_torch.scene.types import (SceneDef, Torus,
                                                            TriangleMesh)

    sd = SceneDef()
    for m in models:
        if m.kind == "torus":
            model = Torus(m.major, m.minor, [m.material])
        else:
            n = len(m.indices)
            model = TriangleMesh(
                positions=m.positions, normals=m.normals,
                colors=np.ones_like(m.positions), uvs=m.uvs,
                indices=m.indices, mat_index=np.zeros(n, np.int32),
                materials=[m.material])
        sd.add_model(model, m.transform)
    return sd


def settings_of(config: dict):
    """The program's `RenderSettings` of the configuration."""
    from toroidal_ray_tracing_tpu_torch.scene.types import (LIGHT_INFINITE,
                                                            LIGHT_POINT,
                                                            RenderSettings)

    s = config["settings"]
    kind = {"point": LIGHT_POINT, "infinite": LIGHT_INFINITE}[s["light_type"]]
    return RenderSettings.default(
        clear_color=tuple(s["clear_color"]),
        light_position=tuple(s["light_position"]),
        light_intensity=s["light_intensity"], light_type=kind,
        max_depth=config["max_depth"])


def camera(spec: dict):
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        ToroidalCamera)

    cls = {"pinhole": PinholeCamera, "toroidal": ToroidalCamera}[spec["type"]]
    return cls(eye=tuple(spec["eye"]), center=tuple(spec["center"]))


class Port:
    """The program with a configuration's scene on `device`.

    Building it is the set-up's scene step: the models made from the
    config, the program's `build_scene` and its copy on the device
    (`build_s`, host clock, synchronized)."""

    def __init__(self, config: dict, device):
        from toroidal_ray_tracing_tpu_torch.render import renderer
        from toroidal_ray_tracing_tpu_torch.scene.build import build_scene

        self.renderer = renderer
        self.device = torch.device(device)
        self.width, self.height = config["width"], config["height"]
        self.spp = int(config.get("spp", 1))
        t0 = time.perf_counter()
        self.scene = build_scene(scene_def(scenedata.models(
            config["scene"]))).to(self.device)
        self.sync()
        self.build_s = time.perf_counter() - t0
        self.settings = settings_of(config)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, c):
        """Run one front-door call; returns (outputs, rays traced). The
        outputs of a `to_host` call are copied to host memory (numpy), as
        the capture's harvest copies them."""
        st = dataclasses.replace(self.settings, rho=c.rho)
        cams = [camera(s) for s in c.cameras]
        fn = getattr(self.renderer, c.door)
        common = dict(backend="kernel", spp=self.spp, seed=c.seed,
                      device=self.device)
        if c.door == "render":
            out = fn(self.scene, cams[0], self.width, self.height, st,
                     **common)
        else:
            out = fn(self.scene, cams, self.width, self.height, st,
                     **common, **dict(c.door_args))
        rays = int(out["rays_traced"])
        if c.to_host:
            out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else v) for k, v in out.items()}
        return out, rays


# each output's key in the stacked outputs of `render_sequence` and
# `render_frames`
STACKED = {"image": "images", "hit_position": "hit_positions",
           "ray_origin": "ray_origins", "ray_dir": "ray_dirs"}


def answer_keys(call) -> tuple:
    """The answers a call's front door is asked for, for each of its
    frames (`OUTPUT_KEYS`; none for a sequence that keeps no images)."""
    args = dict(call.door_args)
    if call.door == "render":
        return OUTPUT_KEYS
    if call.door == "render_sequence":
        return ("image",) if args.get("keep_images", True) else ()
    if call.door == "render_frames":
        return OUTPUT_KEYS if args.get("dumps", True) else ("image",)
    raise ValueError(f"unknown front door {call.door!r}")


def frame_outputs(call, out: dict) -> list:
    """The answers of a call (`answer_keys`) that its outputs hold, one
    dict a frame of name -> (H, W, 3) array (tensor or numpy); an answer
    the front door did not return is left out, for the check to miss."""
    keys = answer_keys(call)
    if call.door == "render":
        return [{k: out[k] for k in keys if k in out}]
    got = {k: out[STACKED[k]] for k in keys if STACKED[k] in out}
    view = _hwc if call.door == "render_frames" else (lambda a: a)
    return [{k: view(v[f]) for k, v in got.items()}
            for f in range(call.frames)] if keys else []


def _hwc(a):
    """(3, H, W) -> (H, W, 3) view."""
    return a.permute(1, 2, 0) if isinstance(a, torch.Tensor) else \
        np.moveaxis(a, 0, -1)
