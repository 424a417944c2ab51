from toroidal_ray_tracing_tpu_torch.oracle.cpu_renderer import render_oracle  # noqa: F401
