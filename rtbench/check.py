"""What decides `correct`: a seeded sample of the answers the window
produced, the reference's answers for the same pixels, the numbers that
compare them, and each number against its limit.

An answer is a frame a call returns (its image, and where the front door
gives them its first hits and rays). A reservoir for each front door keeps
a fixed number of its answering calls drawn uniformly from the seed over
every call of the window, each as its answers at a set of pixels of each
of its frames, also drawn from the seed (taken when the call is drawn, so
no frame is held); after the window they are compared with the
reference:

* `image_off_pct`: % of pixels whose color differs from the reference's
  by more than 1e-3 x max(1, |reference|) in some channel;
* `image_rmse_rest`: RMS color difference over the pixels not off;
* `hit_off_pct`: % of pixels whose first hit lies farther than 1e-3 x
  max(1, |reference|) from the reference's;
* `ray_err`: the largest difference of a ray origin or direction.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench import frontdoor

TOL = 1e-3


class Reservoir:
    """A uniform sample of `k` items of a stream of unknown length
    (Algorithm R), its draws from `rng`."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make):
        """Count one item; keep `make()` if it is drawn (make runs only
        then)."""
        self.seen += 1
        if not self.k:
            return
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = make()


class Sample:
    """A `Reservoir` of `k` items for each key (a call's front door), its
    draws from `rng`, so a door of few calls is sampled as fully as one of
    many."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.parts = k, rng, {}

    def offer(self, key, make):
        if key not in self.parts:
            self.parts[key] = Reservoir(self.k, self.rng)
        self.parts[key].offer(make)

    @property
    def items(self) -> list:
        return [it for part in self.parts.values() for it in part.items]

    @property
    def seen(self) -> int:
        return sum(part.seen for part in self.parts.values())


def draw_pixels(g: np.random.Generator, width: int, height: int,
                count: int):
    """(xs, ys) of `count` distinct pixels of a frame, in raster order."""
    flat = np.sort(g.choice(width * height, size=min(count, width * height),
                            replace=False))
    ys, xs = np.divmod(flat, width)
    return xs, ys


def take(call, frames: list, g: np.random.Generator, width: int,
         height: int, pixels: int) -> list:
    """The program's answers of a call at `pixels` pixels of each of its
    frames, drawn from `g`: [(call, frame index, xs, ys, {name: (P, 3)
    float32 CPU tensor})]."""
    items = []
    for f, outs in enumerate(frames):
        xs, ys = draw_pixels(g, width, height, pixels)
        got = {}
        for name, arr in outs.items():
            a = torch.as_tensor(arr)
            yi = torch.as_tensor(ys, device=a.device)
            xi = torch.as_tensor(xs, device=a.device)
            got[name] = a[yi, xi].float().cpu()
        items.append((call, f, xs, ys, got))
    return items


def reference_answers(items: list, config: dict, tables,
                      dtype=torch.float32) -> list:
    """The reference's answers of each sampled item (`take`)."""
    from rtbench import reference

    settings = dict(config["settings"], max_depth=config["max_depth"])
    out = []
    for call, f, xs, ys, _ in items:
        ref = reference.render_pixels(
            tables, call.cameras[f], call.rho, config["width"],
            config["height"], settings, xs, ys, int(config.get("spp", 1)),
            call.seed, f, dtype)
        out.append({k: v.float().cpu() for k, v in ref.items()})
    return out


def numbers(items: list, refs: list) -> dict:
    """The compared numbers over every sampled pixel (names in the module
    docstring); a number whose answers no call gave is left out."""
    got = {k: torch.cat([it[4][k] for it in items if k in it[4]])
           for k in frontdoor.OUTPUT_KEYS
           if any(k in it[4] for it in items)}
    want = {k: torch.cat([r[k] for it, r in zip(items, refs) if k in it[4]])
            for k in got}
    out = {}
    if "image" in got:
        a, b = got["image"], want["image"]
        diff = (a - b).abs()
        off = (diff > TOL * b.abs().clamp(min=1.0)).any(dim=-1)
        out["image_off_pct"] = 100.0 * float(off.float().mean())
        rest = diff[~off]
        out["image_rmse_rest"] = (float(rest.pow(2).mean().sqrt())
                                  if rest.numel() else 0.0)
    if "hit_position" in got:
        a, b = got["hit_position"], want["hit_position"]
        dist = (a - b).norm(dim=-1)
        off = ~(dist <= TOL * b.norm(dim=-1).clamp(min=1.0))
        out["hit_off_pct"] = 100.0 * float(off.float().mean())
    rays = [k for k in ("ray_origin", "ray_dir") if k in got]
    if rays:
        out["ray_err"] = max(float((got[k] - want[k]).abs().max())
                             for k in rays)
    return out


def verdict(nums: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): each limit's number at most
    the limit; a number the sample did not give (value None), a NaN, or a
    number with no limit fails."""
    checks = {}
    ok = True
    for name in {**limits, **nums}:
        value, limit = nums.get(name), limits.get(name)
        passed = (value is not None and limit is not None and value == value
                  and value <= limit)
        ok &= passed
        checks[name] = {"value": value, "limit": limit}
    return ok and bool(checks), checks
