"""Millions of rays the bounce loop traced a frame over the traced run's
calls: the front doors' exact `rays_traced` (a closest hit per live ray a
segment and a shadow ray per lit hit) over the frames."""

NAME = "loop.rays_per_frame"
LAYER = "bounce loop"
UNIT = "Mrays"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.rays / ctx.frames / 1e6
