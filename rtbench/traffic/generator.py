"""The one traffic generator: a traffic file's parameters and a seed in, the
closed-loop client's front-door calls out.

A traffic file (`traffic/<name>.json`) holds:

* `camera`: the camera's `type` (`pinhole` or `toroidal`) and its pose:
  `eye` and `center`, or for a `flythrough` path `center`, `radius`,
  `height` and `bob`;
* `path`: the views the client cycles through, from a seed-drawn first
  view, so that every seed renders the same set of views in another order:
  - `rho_sweep`: the toroidal camera at rho = `rho_start` .. `rho_end` by
    `rho_step` (the reference's capture sweep), its center turned about
    the eye by a seed-drawn yaw;
  - `flythrough`: `count` views on the orbit eye = center + (radius cos a,
    height + bob sin 2a, radius sin a), a = 2 pi v / count, looking at
    `center` (the ladder's config 5 `camera_at`);
  - `turntable`: `count` views of `eye` turned about the vertical axis
    through `center` by 2 pi v / count (the ladder's `cameras_seq`);
* `frames_per_view`: frames rendered at one view before the next;
* `frames_per_call`: frames a front-door call renders;
* `door` and `door_args`: the program's front door (`render`,
  `render_sequence`, `render_frames`) and its keyword arguments;
* `last_of_view` (optional): the call that renders a view's last frame
  instead, its `door` and `to_host` (copy the outputs to host memory);
* `trace_calls`: the calls of each sub-window of a traced run;
* `sample`: how many answering calls of each front door the check keeps
  (`calls`) and how many pixels of each of their frames it compares
  (`pixels`).

Where the configuration renders more than one sample a pixel, each call
draws its own `seed` for the jittered samples. Before the window, the
client runs `WARMUP_PER_DOOR` calls of each front door.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

F32 = np.float32
SCHEDULE, JITTER, RESERVOIR, PIXELS = range(4)   # the seed's streams
DOORS = ("render", "render_sequence", "render_frames")
WARMUP_PER_DOOR = 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of one purpose (`SCHEDULE`, ...) of a run's
    seed; any whole number is a seed."""
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]))


@dataclasses.dataclass(frozen=True)
class Call:
    index: int                # position in the schedule
    door: str
    cameras: tuple            # one camera dict a frame
    rho: float                # the toroidal ring radius of the call
    seed: int                 # the front door's jitter seed
    door_args: tuple          # (key, value) pairs
    to_host: bool = False

    @property
    def frames(self) -> int:
        return len(self.cameras)


def _turn(vec, deg: float):
    """vec turned about +y by deg (the `rotate_y` convention)."""
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    x, y, z = vec
    return (x * c + z * s, y, -x * s + z * c)


def views(traffic: dict, seed: int) -> list:
    """The path's views in the order a run with this seed visits them:
    [(camera dict, rho)]."""
    cam, path = traffic["camera"], traffic["path"]
    g = rng(seed, SCHEDULE)
    kind = path["kind"]
    if kind == "rho_sweep":
        n = int(round((path["rho_end"] - path["rho_start"])
                      / path["rho_step"])) + 1
        rhos = [float(F32(path["rho_start"] + i * path["rho_step"]))
                for i in range(n)]
        yaw = float(g.uniform(0.0, 360.0))
        eye = tuple(map(float, cam["eye"]))
        rel = _turn(np.subtract(cam["center"], eye).tolist(), yaw)
        center = tuple(e + r for e, r in zip(eye, rel))
        out = [({"type": cam["type"], "eye": eye, "center": center}, rho)
               for rho in rhos]
    elif kind == "flythrough":
        n = int(path["count"])
        cx, cy, cz = map(float, cam["center"])
        out = []
        for v in range(n):
            a = 2.0 * math.pi * v / n
            eye = (cx + cam["radius"] * math.cos(a),
                   cam["height"] + cam["bob"] * math.sin(2 * a),
                   cz + cam["radius"] * math.sin(a))
            out.append(({"type": cam["type"], "eye": eye,
                         "center": (cx, cy, cz)}, 0.0))
    elif kind == "turntable":
        n = int(path["count"])
        eye = np.asarray(cam["eye"], np.float64)
        ctr = np.asarray(cam["center"], np.float64)
        rel = eye - ctr
        out = []
        for v in range(n):
            a = 2.0 * math.pi * v / n
            c, s = math.cos(a), math.sin(a)
            rot = np.array([rel[0] * c + rel[2] * s, rel[1],
                            -rel[0] * s + rel[2] * c])
            out.append(({"type": cam["type"],
                         "eye": tuple(map(float, ctr + rot)),
                         "center": tuple(map(float, ctr))}, 0.0))
    else:
        raise ValueError(f"unknown path kind {kind!r}")
    start = int(g.integers(len(out)))
    return out[start:] + out[:start]


def calls(traffic: dict, seed: int, spp: int = 1):
    """The run's calls, endlessly (the path cycles); `spp` is the
    configuration's samples a pixel."""
    seq = views(traffic, seed)
    per_view = int(traffic.get("frames_per_view", 1))
    per_call = int(traffic.get("frames_per_call", 1))
    door = traffic["door"]
    if door not in DOORS:
        raise ValueError(f"unknown front door {door!r}")
    args = tuple(sorted(traffic.get("door_args", {}).items()))
    last = traffic.get("last_of_view")
    jitter = rng(seed, JITTER) if spp > 1 else None
    frames = ((v, i) for v in itertools.cycle(range(len(seq)))
              for i in range(per_view))
    for index in itertools.count():
        chunk = list(itertools.islice(frames, per_call))
        rhos = {seq[v][1] for v, _ in chunk}
        if len(rhos) != 1:
            raise ValueError("a call's frames share one rho")
        call_seed = int(jitter.integers(0, 2**31)) if jitter else 0
        cams = tuple(seq[v][0] for v, _ in chunk)
        if last is not None and chunk[-1][1] == per_view - 1:
            yield Call(index, last["door"], cams, rhos.pop(), call_seed,
                       (), bool(last.get("to_host", False)))
        else:
            yield Call(index, door, cams, rhos.pop(), call_seed, args)


def warmup(traffic: dict, seed: int, spp: int = 1) -> list:
    """`WARMUP_PER_DOOR` calls of each door the schedule uses in one cycle
    of its path, the first of each (drawn from a schedule of their own, so
    the window starts at the schedule's start)."""
    cycle = -(-len(views(traffic, seed)) * int(traffic.get(
        "frames_per_view", 1)) // int(traffic.get("frames_per_call", 1)))
    per = WARMUP_PER_DOOR
    got: dict = {}
    out = []
    for c in itertools.islice(calls(traffic, seed, spp), per * cycle):
        if got.get(c.door, 0) < per:
            got[c.door] = got.get(c.door, 0) + 1
            out.append(c)
    return out
