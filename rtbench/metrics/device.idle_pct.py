"""Share of the profiled sub-window in which no operation ran on the card:
100 x (1 - the union of its busy intervals over the window)."""

NAME = "device.idle_pct"
LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    if ctx.profile is None or ctx.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.window_s)
