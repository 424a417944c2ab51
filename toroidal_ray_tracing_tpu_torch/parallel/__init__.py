from toroidal_ray_tracing_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    pad_scene_for_mesh,
    render_sharded,
)
from toroidal_ray_tracing_tpu_torch.parallel import multihost  # noqa: F401
