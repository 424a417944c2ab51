from toroidal_ray_tracing_tpu_torch.cameras.pinhole import PinholeCamera  # noqa: F401
from toroidal_ray_tracing_tpu_torch.cameras.toroidal import ToroidalCamera  # noqa: F401


def generate_rays(camera, width, height, settings, jitter=None,
                  device="cpu"):
    """Dispatch to the camera's ray generator. Returns (origins, dirs) as
    (H*W, 3) float32 tensors in row-major image order (i = y*W + x)."""
    return camera.generate_rays(width, height, settings, jitter=jitter,
                                device=device)
