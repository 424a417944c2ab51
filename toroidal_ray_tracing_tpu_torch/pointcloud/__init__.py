from toroidal_ray_tracing_tpu_torch.pointcloud.splat import splat_points  # noqa: F401
