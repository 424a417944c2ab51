"""Device operations (kernels, copies, fills) a frame in the profiled
sub-window: what the host launches to make a frame."""

NAME = "orchestration.device_ops_per_frame"
LAYER = "orchestration"
UNIT = "ops"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    if ctx.profile is None or not ctx.profile_frames:
        return None
    return len(ctx.profile.device) / ctx.profile_frames
