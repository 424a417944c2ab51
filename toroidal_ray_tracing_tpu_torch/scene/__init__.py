from toroidal_ray_tracing_tpu_torch.scene.types import (  # noqa: F401
    Instance,
    Light,
    Material,
    RenderSettings,
    Scene,
    SceneDef,
    TextureAtlas,
    Torus,
    TorusSoup,
    TriangleMesh,
    TriangleSoup,
    LIGHT_POINT,
    LIGHT_INFINITE,
)
from toroidal_ray_tracing_tpu_torch.scene.build import build_scene  # noqa: F401
from toroidal_ray_tracing_tpu_torch.scene.convert import (  # noqa: F401
    scene_from_numpy,
    settings_from_numpy,
)
from toroidal_ray_tracing_tpu_torch.scene import procedural  # noqa: F401
