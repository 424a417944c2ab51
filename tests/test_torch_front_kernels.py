"""The front-door kernels' CPU paths (R1 raygen, G1 span_gather, F1
frame_finish, `ops.front_kernel`) against the JAX package, on the same
seeded NumPy inputs, and the front doors that run them.

Bounds: R1 against the JAX cameras' `device_rays(xp=np)` at atol 1e-6
(tests/test_torch_cameras.py's bound); G1 and F1 against the JAX bounce
loop's `prow` gather and `unrow` inverse (trace/wavefront.py:218-231,
:250-255) and `block_unswizzle`, exactly; the spp 2 renders and a
`render_frames` group against the JAX package's within 5e-4
(tests/test_golden.py's bound). On a CUDA tensor each wrapper launches its
kernel; chip_smoke.py phase 14 holds the kernels to these twins on the
card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import ToroidalCamera as JaxToroidal
from toroidal_ray_tracing_tpu.cameras import pinhole as jax_pinhole
from toroidal_ray_tracing_tpu.render import render as jax_render
from toroidal_ray_tracing_tpu.render import render_frames as jax_frames
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch import render, render_frames
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera)
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
from toroidal_ray_tracing_tpu_torch.ops import front_kernel as fk
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import LAUNCHES, SEG_TMAX
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                  scene_from_numpy,
                                                  settings_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace import wavefront

torch.set_num_threads(2)

SIZES = [(24, 16), (33, 17), (48, 24), (30, 18)]   # 33x17: block 1
# F1 stages a CTA's 256 pixels: 35x9 (block 1) has a pixel count that is
# no multiple of 4, 72x24 (block 24) a short last CTA of 192 pixels
F1_SIZES = SIZES + [(35, 9), (72, 24)]
SPAN = 128


def _cams(kind, **st):
    """(port camera, JAX camera, port settings, JAX settings)."""
    if kind == "pinhole":
        kw = dict(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
        return (PinholeCamera(**kw), JaxPinhole(**kw),
                RenderSettings.default(**st), JaxSettings.default(**st))
    kw = dict(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0))
    return (ToroidalCamera(**kw), JaxToroidal(**kw),
            RenderSettings.default(rho=4.0, **st),
            JaxSettings.default(rho=4.0, **st))


@pytest.mark.parametrize("jittered", [False, True])
@pytest.mark.parametrize("rows", [True, False])
@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("kind", ["pinhole", "toroidal"])
def test_raygen_matches_jax(kind, w, h, rows, jittered):
    """R1's CPU path (the wrapper on a CPU device: its twin) against the
    JAX camera's device_rays, both layouts, the block the front door
    picks, with and without a seeded jitter."""
    cam, jcam, st, jst = _cams(kind)
    block = pick_block(w, h)
    assert (block == 1) == ((w, h) == (33, 17))
    jit = (np.random.default_rng(7).random((w * h, 2), dtype=np.float32)
           if jittered else None)
    o_ref, d_ref = type(jcam).device_rays(
        jcam.ray_params(w, h, jst), w, h, jst, xp=np, jitter=jit,
        block=block, rows=rows)
    before = LAUNCHES["raygen"]
    o, d = fk.raygen(cam.KIND, cam.ray_params(w, h, st), w, h,
                     None if jit is None else torch.from_numpy(jit), block,
                     rows, "cpu")
    assert LAUNCHES["raygen"] == before            # no launch on the CPU
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-6, rtol=0)
    # the camera's own device_rays is the same wrapper
    o2, d2 = cam.device_rays(cam.ray_params(w, h, st), w, h, st,
                             jitter=None if jit is None
                             else torch.from_numpy(jit), block=block,
                             rows=rows, device="cpu")
    assert torch.equal(o2, o) and torch.equal(d2, d)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("kind", ["pinhole", "toroidal"])
def test_raygen_state_fills_the_loop_state(kind, w, h):
    """R1 into the state writes what trace_rays' own fill writes: the rays
    at their columns, color 0, attenuation 1, active, and the dead tail
    lanes of the kernel backend's span padding; the first-hit rows, which
    segment 0 writes, keep what they held."""
    cam, _, st, _ = _cams(kind)
    n, block = w * h, pick_block(w, h)
    params = cam.ray_params(w, h, st)
    lanes = -(-2 * n // SPAN) * SPAN          # whole spans: a dead tail
    state, active = wavefront.new_state(lanes, "cpu")
    state.fill_(float("nan"))
    for g in range(2):                       # a two-frame group
        fk.raygen_state(cam.KIND, params, w, h, None, block, state, active,
                        g * n, lanes - 2 * n if g == 1 else 0)
    o, d = fk.raygen_plain(cam.KIND, params, w, h, None, block, rows=True)
    ref, ref_act = wavefront.new_state(lanes, "cpu")
    fk.fill_state_plain(ref, ref_act, torch.cat([o, o], 1),
                        torch.cat([d, d], 1), 0, lanes - 2 * n)
    assert torch.equal(state[:12], ref[:12]) and torch.equal(active, ref_act)
    assert bool(state[12:].isnan().all())
    assert bool(active[:2 * n].all()) and not bool(active[2 * n:].any())


def _jax_prow(live, rows):
    """The JAX loop's compaction of one shrink: the stable live-first span
    order and every row gathered through it (trace/wavefront.py:218-225)."""
    n_spans = live.shape[0]
    perm = jnp.argsort(~jnp.asarray(live), stable=True)
    r = jnp.asarray(rows)
    return (np.asarray(perm),
            np.asarray(r.reshape(r.shape[0], n_spans, SPAN)[:, perm]
                       .reshape(r.shape[0], -1)))


@pytest.mark.parametrize("case", ["random", "all_live", "all_dead",
                                  "one_live", "second_shrink"])
def test_span_gather_matches_jax_prow(case):
    """G1's CPU path against the JAX loop's `prow` rule on the prefix:
    the spans in argsort(~live, stable=True) order, the spans past the
    prefix kept; rows 0-11 and the active mask on the new prefix (the
    next segments' lanes), origin and color (the rows read there again)
    past it, nothing else written; each slot's original span and each
    original span's slot (JAX's unpermute index, argsort(span_orig))."""
    rng = np.random.default_rng({"random": 1, "all_live": 2, "all_dead": 3,
                                 "one_live": 4, "second_shrink": 5}[case])
    s_total = 24
    s_old = 12 if case == "second_shrink" else s_total
    lanes, nb = s_total * SPAN, s_old * SPAN
    live = {"all_live": np.ones(s_old, bool),
            "all_dead": np.zeros(s_old, bool),
            "one_live": np.arange(s_old) == 7}.get(
        case, rng.random(s_old) < 0.4)
    cur = rng.standard_normal((15, lanes)).astype(np.float32)
    act = np.repeat(live, SPAN)
    act_full = np.zeros(lanes, bool)
    act_full[:nb] = act & (rng.random(nb) < 0.7)
    orig_in = (rng.permutation(s_total).astype(np.int32)
               if case == "second_shrink" else None)
    t = {k: torch.from_numpy(v.copy()) for k, v in
         dict(cur=cur, act=act_full).items()}
    n_live = int(live.sum())
    fit = SPAN * (s_old if case == "all_live" else min(s_old - 1, n_live + 2))
    spare, spare_act = wavefront.new_state(lanes, "cpu")
    spare.fill_(float("nan"))
    spare_act.fill_(True)
    orig_out = torch.empty(s_total, dtype=torch.int32)
    slot = torch.empty(s_total, dtype=torch.int32)
    spans = torch.from_numpy(np.concatenate([live, np.zeros(
        s_total - s_old, bool)]))
    count = torch.tensor(int(live.sum()), dtype=torch.int32)
    tmax = torch.full((lanes,), float("nan"))
    fk.span_gather(t["cur"], spare, t["act"], spare_act, spans, count,
                   None if orig_in is None else torch.from_numpy(orig_in),
                   orig_out, slot, nb, fit, tmax)

    perm, moved = _jax_prow(live, cur[:12, :nb])
    kept = [0, 1, 2, 6, 7, 8]
    np.testing.assert_array_equal(spare[:12, :fit].numpy(), moved[:, :fit])
    np.testing.assert_array_equal(spare[kept, fit:nb].numpy(),
                                  moved[kept, fit:])
    np.testing.assert_array_equal(spare[kept, nb:].numpy(), cur[kept, nb:])
    assert bool(spare[[3, 4, 5, 9, 10, 11], fit:].isnan().all())
    assert bool(spare[12:].isnan().all())
    np.testing.assert_array_equal(
        spare_act[:fit].numpy(),
        act_full[:nb].reshape(s_old, SPAN)[perm].reshape(-1)[:fit])
    assert bool(spare_act[fit:].all())
    span_orig = np.arange(s_total) if orig_in is None else orig_in
    want = np.concatenate([np.asarray(jnp.asarray(span_orig[:s_old])[perm]),
                           span_orig[s_old:]])
    np.testing.assert_array_equal(orig_out.numpy(), want)
    np.testing.assert_array_equal(
        slot.numpy(), np.asarray(jnp.argsort(jnp.asarray(want))))
    assert spare_act[n_live * SPAN:fit].sum() == 0   # dead spans behind
    # the new prefix's tmax row: SEG_TMAX where active, else 0
    np.testing.assert_array_equal(
        tmax[:fit].numpy(),
        np.where(spare_act[:fit].numpy(), np.float32(SEG_TMAX), np.float32(0)))
    assert bool(tmax[fit:].isnan().all())


@pytest.mark.parametrize("chw", [False, True])
@pytest.mark.parametrize("w,h", F1_SIZES)
@pytest.mark.parametrize("kind", ["pinhole", "toroidal"])
def test_frame_finish_matches_jax_unrow_and_unswizzle(kind, w, h, chw):
    """F1's CPU path against the JAX loop's `unrow` (the inverse of the
    span permutation, argsort(span_orig)), the front door's
    `block_unswizzle` and the spp accumulation, exactly: a frame at a
    column offset of a compacted two-frame batch, sample 0 with dumps
    (stored), then sample 1 of 2 (added and halved)."""
    cam, jcam, st, jst = _cams(kind)
    rng = np.random.default_rng(w * h)
    n, block = w * h, pick_block(w, h)
    lanes = -(-2 * n // SPAN) * SPAN
    s_total = lanes // SPAN
    span_orig = rng.permutation(s_total).astype(np.int32)
    state = rng.standard_normal((15, lanes)).astype(np.float32)
    first = rng.standard_normal((15, lanes)).astype(np.float32)
    off = n                                   # the group's second frame
    inv = jnp.argsort(jnp.asarray(span_orig))
    hv = np.asarray(jnp.asarray(state[6:9]).reshape(3, s_total, SPAN)[:, inv]
                    .reshape(3, lanes))

    def unsw(rows):
        a = np.asarray(jax_pinhole.block_unswizzle(
            jnp, jnp.asarray(rows[:, off:off + n].T), w, h, block))
        return a.transpose(2, 0, 1) if chw else a

    o, d = type(jcam).device_rays(jcam.ray_params(w, h, jst), w, h, jst,
                                  xp=np, block=block, rows=True)
    shape = (3, h, w) if chw else (h, w, 3)
    outs = [torch.full(shape, float("nan")) for _ in range(4)]
    args = (cam.KIND, cam.ray_params(w, h, st), w, h, block,
            torch.from_numpy(state), torch.from_numpy(first),
            torch.from_numpy(np.asarray(jnp.argsort(jnp.asarray(span_orig)),
                                        np.int32)), off)
    fk.frame_finish(*args, outs[0], 0, 2, tuple(outs[1:]), chw)
    c0 = unsw(hv)
    np.testing.assert_array_equal(outs[0].numpy(), c0)
    np.testing.assert_array_equal(outs[1].numpy(), unsw(first[12:15]))
    pad = np.zeros((3, off), np.float32)     # the frame's rays at `off`
    for got, ref in zip(outs[2:], (o, d)):
        np.testing.assert_allclose(
            got.numpy(), unsw(np.concatenate([pad, ref], 1)), atol=1e-6,
            rtol=0)
    fk.frame_finish(*args, outs[0], 1, 2, None, chw)
    want = np.asarray((jnp.asarray(c0) + jnp.asarray(c0)) / np.float32(2))
    np.testing.assert_array_equal(outs[0].numpy(), want)


@pytest.mark.parametrize("kind", ["pinhole", "toroidal"])
def test_spp2_render_matches_jax(kind):
    """render (spp 2, depth 3) on backend="kernel": R1, the loop with G1,
    F1, against the JAX package's render (jnp) with the same draw."""
    cam, jcam, _, jst = _cams(kind, max_depth=3)
    jscene = jax_build(jax_proc.scene_multi_torus(True))
    ref = jax_render(jscene, jcam, 48, 24, jst, spp=2, seed=5)
    out = render(scene_from_numpy(jscene), cam, 48, 24,
                 settings_from_numpy(jst), backend="kernel", spp=2, seed=5,
                 device="cpu")
    for key in ("image", "hit_position", "ray_origin", "ray_dir"):
        assert float(np.abs(out[key].numpy()
                            - np.asarray(ref[key])).max()) < 5e-4, key
    assert out["rays_traced"] == int(float(ref["rays_traced"]))


def test_render_frames_group_matches_jax():
    """render_frames with a 3-frame group on backend="kernel": each
    camera's rays at its column offset (R1), one bounce loop, F1 per
    frame in the stacked channel-major output, against the JAX front
    door. The ray count is the per-frame renders' sum; against the JAX
    count it may part by a ray a thousand (here 3,759 against 3,758, on
    the torch backend too and before the front-door kernels). The gap is
    the JAX package's own, not the port's: XLA rounds its jitted
    reference otherwise than the same functions run eagerly, near a
    shadow edge. For camera (-8, 4, 6) the jitted reference counts 1,230
    rays, where its own `closest_hit` and `shade` run eagerly, segment by
    segment, count 1,231, the port's count."""
    jscene = jax_build(jax_proc.scene_multi_torus(True))
    jst = JaxSettings.default(max_depth=3)
    eyes = [(8.0, 5.0, 8.0), (-8.0, 4.0, 6.0), (5.0, 6.0, -9.0)]
    center = (0.0, 0.5, 0.0)
    ref = jax_frames(jscene, [JaxPinhole(eye=e, center=center) for e in eyes],
                     30, 18, jst, frames_per_batch=3)
    scene, st = scene_from_numpy(jscene), settings_from_numpy(jst)
    cams = [PinholeCamera(eye=e, center=center) for e in eyes]
    out = render_frames(scene, cams, 30, 18, st, backend="kernel",
                        frames_per_batch=3, device="cpu")
    for key in ("images", "hit_positions", "ray_origins", "ray_dirs"):
        assert out[key].shape == (3, 3, 18, 30), key
        assert float(np.abs(out[key].numpy()
                            - np.asarray(ref[key])).max()) < 5e-4, key
    assert out["rays_traced"] == sum(
        render(scene, cam, 30, 18, st, backend="kernel",
               device="cpu")["rays_traced"] for cam in cams)
    jax_rays = int(float(ref["rays_traced"]))
    assert abs(out["rays_traced"] - jax_rays) <= jax_rays // 1000


def test_redesign_split_copies_only_the_scalar_store_source(tmp_path):
    """experiments/redesign_split.py times two edited copies of a frame.cu
    that stores every row-major output as three scalars a pixel; the
    shipped frame.cu stages its row-major dumps (frame_finish<kStaged>),
    so the script builds no copy of it (and needs no nvcc to say so)."""
    from toroidal_ray_tracing_tpu_torch.experiments import redesign_split

    assert redesign_split.f1_variants(str(tmp_path)) == {}
    assert not list(tmp_path.iterdir())
