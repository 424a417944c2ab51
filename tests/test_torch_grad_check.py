"""`experiments/grad_check.py`'s rule for the minor radius's gradient, on
the CPU at small sizes: each ray's recorded path, the per-pixel
contributions from forward-mode AD and their one-ulp spreads, and the
rule on a frame of mirror tori (config 3) and a mesh frame (config 6).

Bounds: the contributions sum to the reverse-mode gradient within rtol
1e-5; paths and contributions do not depend on the tile size (bit for
bit); the rule as chip_smoke phase 9 applies it (RTOL 1e-3)."""

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu_torch.experiments import grad_check as gc
from toroidal_ray_tracing_tpu_torch.trace import shade, wavefront

torch.set_num_threads(2)

CELLS = {3: (40, 24), 6: (32, 18)}


@pytest.fixture(scope="module", params=sorted(CELLS))
def frame(request):
    num = request.param
    scene, st, o, d, depth = gc.setup(num, *CELLS[num], "cpu")
    return num, scene, st, o, d, depth


def test_contributions_sum_to_the_gradient(frame):
    num, scene, st, o, d, depth = frame
    n = o.shape[0]
    contrib = gc.radius_contributions(scene, st, o, d, depth, n)
    _, g = gc.grad_loss(scene, st, o, d, depth, "torch", n)
    want = float(g[gc.PARAMS[0]])
    assert contrib.shape == (n,)
    assert abs(float(contrib.sum()) - want) <= 1e-5 * abs(want)
    if num == 3:
        assert want != 0.0 and float(contrib.abs().sum()) > abs(want)
    else:       # no torus in view: no pixel's value moves with the radius
        assert float(contrib.abs().sum()) == 0.0


def test_spread_is_where_the_radius_reaches(frame):
    """The one-ulp spread is 0 exactly where a pixel's contribution is 0,
    and small against the contributions it accompanies."""
    num, scene, st, o, d, depth = frame
    n = o.shape[0]
    contrib = gc.radius_contributions(scene, st, o, d, depth, n)
    spread = gc.radius_spread(scene, st, o, d, depth, n, contrib)
    assert spread.shape == (n,) and bool((spread >= 0).all())
    assert bool((spread[contrib == 0] == 0).all())
    if num == 3:
        assert 0.0 < float(spread.sum()) < 0.1 * float(contrib.abs().sum())
    else:
        assert float(spread.sum()) == 0.0


def test_paths_and_contributions_ignore_the_tile(frame):
    _, scene, st, o, d, depth = frame
    n = o.shape[0]
    for backend in ("torch", "kernel"):
        whole = gc.paths(scene, st, o, d, depth, backend, n)
        assert whole.shape == (max(depth, 1), 4, n)
        assert torch.equal(whole, gc.paths(scene, st, o, d, depth, backend,
                                           n // 4 + 1))
    assert torch.equal(gc.radius_contributions(scene, st, o, d, depth, n),
                       gc.radius_contributions(scene, st, o, d, depth,
                                               n // 3 + 1))


def test_paths_restore_the_queries(frame):
    _, scene, st, o, d, depth = frame
    before = (wavefront.closest_hit, wavefront.closest_hit_diff,
              shade.any_hit)
    with pytest.raises(RuntimeError, match="inside"):
        with gc._recorded([]):
            raise RuntimeError("inside")
    gc.paths(scene, st, o[:8], d[:8], depth, "kernel", 8)
    assert (wavefront.closest_hit, wavefront.closest_hit_diff,
            shade.any_hit) == before


def test_paths_see_a_moved_torus():
    """A thicker torus takes some pixels onto other paths and leaves the
    rest: the recorded paths part exactly there."""
    scene, st, o, d, depth = gc.setup(3, *CELLS[3], "cpu")
    n = o.shape[0]
    thick = gc._scaled_radius(scene, torch.tensor(1.05))
    a = gc.paths(scene, st, o, d, depth, "torch", n)
    b = gc.paths(thick, st, o, d, depth, "torch", n)
    parted = (a != b).any(dim=1).any(dim=0)
    assert 0 < int(parted.sum()) < n // 2
    kind = a[:, 0]
    assert bool((kind[0, parted] >= 0).any() | (b[0, 0, parted] >= 0).any())


def test_radius_rule_holds_on_both_frames(frame):
    num, scene, st, o, d, depth = frame
    rad = gc.radius_check(scene, st, o, d, depth, o.shape[0] // 2 + 1)
    assert rad["ok"], rad
    assert rad["parted"] <= gc.PARTED_MAX * o.shape[0]
    assert rad["gap"] <= rad["bound"]
    assert rad["bound"] == rad["bound_rtol"] + rad["bound_spread"]
    assert np.isfinite(rad["kernel"]) and np.isfinite(rad["torch"])
    if num == 3:
        assert rad["bound"] > 0.0 and rad["margin"] > 1.0
