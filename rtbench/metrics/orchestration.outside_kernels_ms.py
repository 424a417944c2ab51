"""Device milliseconds a frame not spent in the program's own kernels:
what PyTorch launches (ATen kernels, cub, thrust) and every copy and fill,
in the profiled sub-window. A kernel a later change adds to the program
counts as the program's."""

NAME = "orchestration.outside_kernels_ms"
LAYER = "orchestration"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    if ctx.profile is None or not ctx.profile_frames:
        return None
    return 1e3 * ctx.profile.library_seconds() / ctx.profile_frames
