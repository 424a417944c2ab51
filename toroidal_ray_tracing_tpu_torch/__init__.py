"""toroidal_ray_tracing_tpu_torch — the toroidal-capture ray tracer in
PyTorch, with hand-written CUDA kernels for the closest-hit queries.

The port of the JAX package of this repository (which stays the
reference). Main path: `scene.build.build_scene` -> camera raygen (pinhole,
toroidal) -> `trace.wavefront.trace_rays` (closest hit, Lambert/Phong
shading with shadow rays and mirror reflections, trilinear mip textures) ->
`render.render`, with `render_sequence` and `render_frames` for many
frames. Every entry point renders on the CUDA device unless the caller
passes `device="cpu"`.

Backends: `backend="torch"` runs plain tensor ops on any device;
`backend="kernel"` runs the closest-hit / any-hit queries and the texture
gather through the kernels of `ops/` (CUDA sources in `csrc/`, built with nvcc at first use):
on CUDA tensors the kernels launch, on CPU tensors their plain PyTorch
twins run.

Importing the package sets `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False: the few matrix products on the
path (the loose-triangle prepass) are full float32, as in the reference.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from toroidal_ray_tracing_tpu_torch.scene.types import (  # noqa: E402,F401
    Instance,
    Light,
    Material,
    RenderSettings,
    Scene,
    SceneDef,
    Torus,
    TriangleMesh,
)
from toroidal_ray_tracing_tpu_torch.cameras import (  # noqa: E402,F401
    PinholeCamera,
    ToroidalCamera,
)
from toroidal_ray_tracing_tpu_torch.render.renderer import (  # noqa: E402,F401
    render,
    render_frames,
    render_sequence,
    tonemap,
)
