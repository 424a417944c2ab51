"""Seconds the set-up spends making the configuration's scene: its models
from the config file, the program's `build_scene` and the copy to the card
(host clock around them, synchronized)."""

NAME = "host_scene.build_s"
LAYER = "host scene"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(ctx):
    return ctx.build_s
