"""Carry scene state across from NumPy-leaved scene objects.

`scene_from_numpy` reads any object shaped like the JAX package's `Scene`
(attributes `triangles.v0`, `tori.world_to_obj`, `materials.ambient`,
`textures.data4q`, `cluster_lo`, ... whose leaves convert with
`np.asarray`) by plain attribute access, and builds this package's `Scene`
from the very same arrays. `settings_from_numpy` does the same for
`RenderSettings`. Nothing here imports the other package: the objects are
duck-typed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from toroidal_ray_tracing_tpu_torch.scene.types import (
    Light,
    Material,
    RenderSettings,
    Scene,
    TextureAtlas,
    TorusSoup,
    TriangleSoup,
    _tensor,
)


def _leaves(cls, src, **override):
    return cls(**{f.name: override[f.name] if f.name in override
                  else _tensor(np.asarray(getattr(src, f.name)))
                  for f in dataclasses.fields(cls)})


def scene_from_numpy(scene) -> Scene:
    """A `Scene` of CPU tensors holding the same arrays as `scene`."""
    tex = scene.textures
    data4q = np.ascontiguousarray(np.asarray(tex.data4q, np.uint32))
    return Scene(
        triangles=_leaves(TriangleSoup, scene.triangles),
        tori=_leaves(TorusSoup, scene.tori),
        materials=_leaves(Material, scene.materials),
        textures=_leaves(TextureAtlas, tex,
                         data4q=_tensor(data4q.view(np.int32))),
        cluster_lo=_tensor(np.asarray(scene.cluster_lo)),
        cluster_hi=_tensor(np.asarray(scene.cluster_hi)),
        cluster_size=int(scene.cluster_size),
        loose_tris=int(scene.loose_tris),
    )


def settings_from_numpy(settings) -> RenderSettings:
    """A `RenderSettings` holding the same values as `settings`."""
    light = settings.light
    return RenderSettings(
        clear_color=_tensor(np.asarray(settings.clear_color, np.float32)),
        light=Light(position=_tensor(np.asarray(light.position, np.float32)),
                    intensity=float(np.float32(light.intensity)),
                    type=int(light.type)),
        max_depth=int(settings.max_depth),
        rho=float(np.float32(settings.rho)),
        pixel_spread=float(np.float32(settings.pixel_spread)),
    )
