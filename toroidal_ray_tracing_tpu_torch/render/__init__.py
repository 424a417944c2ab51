from toroidal_ray_tracing_tpu_torch.render.renderer import (  # noqa: F401
    autofill_pixel_spread,
    render,
    render_frames,
    render_sequence,
    tonemap,
)
