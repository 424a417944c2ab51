"""K2's work counts in the program's record, on the card: inside
`utils.profiling.record_segments` each K2 launch (`csrc/torus_hit.cu`
`torus_closest_hit`) adds its (ray, box) slab tests and (ray, torus)
quartics to a counters tensor of the record's, read once at the block's
exit into the call's `HitCall.box_tests` and `.quartics`. At config 4's
1080p frame (1,024 tori in gated chunks of 16: primary and shadow rays)
and config 3's (the fly-through's four tori, depth 3):

* the frame rendered inside the block is bit-equal to the one rendered
  outside it;
* each counted launch's outputs (and its occlusion byte) are bit-equal to
  the same launch's without counters, on clones of its arguments;
* each recorded call's counts equal the counters a standalone counted
  launch on the same arguments returns.

Needs a CUDA card and nvcc; skips without a card. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_k2_count_card.py -q

(`--noconftest`: tests/conftest.py sets JAX up, which the card's machine
need not have; this file imports none of it.)"""

import pytest
import torch

W, H = 1920, 1080


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


@pytest.mark.cuda
@pytest.mark.parametrize("num", [4, 3])
def test_counted_k2_launches_are_the_main_builds(card, num, monkeypatch):
    import toroidal_ray_tracing_tpu_torch as trt
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.ops import torus_kernel
    from toroidal_ray_tracing_tpu_torch.utils import profiling

    sc = SCENARIOS[num]
    scene = sc.build()
    st = sc.settings()

    def frame():
        return trt.render(scene, sc.camera, W, H, st, backend="kernel",
                          device=card)

    bare = frame()
    real = torus_kernel.torus_closest_hit_chunked
    seen = []

    def spy(origins, dirs, tmax, tables, **kw):
        args = [_clone(a) for a in (origins, dirs, tmax)]
        before = {k: _clone(kw.get(k)) for k in ("rank", "occ_out")}
        out = real(origins, dirs, tmax, tables, **kw)
        seen.append((args, tables, kw, before, [_clone(o) for o in out],
                     _clone(kw.get("occ_out"))))
        return out

    monkeypatch.setattr(torus_kernel, "torus_closest_hit_chunked", spy)
    segments = []
    with profiling.record_segments(segments):
        counted = frame()
    monkeypatch.undo()
    torch.cuda.synchronize(card)

    for key, value in bare.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, counted[key]), key
    calls = [c for s in segments for c in s[2]
             if c.kernel == "torus_closest_hit"]
    assert len(calls) == len(seen) >= 2
    if num == 4:
        assert {c.tori for c in calls} == {1024}
        assert any(c.occ_out for c in calls)      # the shadow rays
    for c, (args, tables, kw, before, outs, occ_after) in zip(calls, seen):
        assert c.box_tests > 0 and c.quartics >= 0
        for counting in (False, True):
            work = (torch.zeros((2,), dtype=torch.int64, device=card)
                    if counting else None)
            occ = _clone(before["occ_out"])
            got = real(*[a.clone() for a in args], tables,
                       want_attrs=kw.get("want_attrs", False),
                       occlusion=kw.get("occlusion", False),
                       rank=before["rank"], occ_out=occ,
                       occ_or=kw.get("occ_or", False), counters=work)
            for a, b in zip(got, outs):
                assert torch.equal(a, b)
            if occ is not None:
                assert torch.equal(occ, occ_after)
            if counting:
                assert tuple(work.tolist()) == (c.box_tests, c.quartics)
