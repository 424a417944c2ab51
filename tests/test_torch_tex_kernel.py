"""K4's plain PyTorch twin (the CPU side of `ops.tex_kernel.quad_gather`)
against the JAX package's Pallas texture gather run in interpret mode, on
config 7's atlas; and the port's `_sample_texture` on the kernel backend
against its torch backend.

Tolerances: none — gathered words are bit-equal on the valid rays (the TPU
kernel leaves invalid rays unspecified when their block is visited; the
port zeroes them), and the sampled colors of both backends are bit-equal
(they share the index and blend code; only the fetch differs)."""

import numpy as np
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.ops import tex_kernel as jax_tex
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu.trace import shade as jax_shade
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import LAUNCHES
from toroidal_ray_tracing_tpu_torch.ops.tex_kernel import (quad_gather,
                                                          quad_gather_plain)
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy
from toroidal_ray_tracing_tpu_torch.trace import shade

torch.set_num_threads(2)


def _atlas_indices(atlas, n, rng):
    """Seeded flat texel indices spread over every (texture, mip level)."""
    offsets = np.asarray(atlas.offsets)
    sizes = np.asarray(atlas.sizes)
    n_levels = np.asarray(atlas.n_levels)
    tid = rng.integers(0, offsets.shape[0], n)
    lv = np.minimum(rng.integers(0, offsets.shape[1], n), n_levels[tid] - 1)
    texels = sizes[tid, lv, 0] * sizes[tid, lv, 1]
    return (offsets[tid, lv] + rng.integers(0, 1 << 30, n) % texels).astype(
        np.int32), lv


def test_quad_gather_twin_matches_pallas():
    atlas = build_scene(procedural.scene_textured_mesh()).textures
    data4q = np.asarray(atlas.data4q, np.uint32)
    rng = np.random.default_rng(4)
    n = 3000                                  # not a whole TPU tile
    f0, lv0 = _atlas_indices(atlas, n, rng)
    f1, _ = _atlas_indices(atlas, n, rng)
    valid = rng.random(n) > 0.2
    assert len(set(lv0.tolist())) == np.asarray(atlas.offsets).shape[1]

    r0, r1 = (np.asarray(q).view(np.int32) for q in jax_tex.quad_gather_pallas(
        jnp.asarray(data4q), jnp.asarray(f0), jnp.asarray(f1),
        jnp.asarray(valid)))
    args = (torch.from_numpy(data4q.view(np.int32)), torch.from_numpy(f0),
            torch.from_numpy(f1), torch.from_numpy(valid))
    launches = dict(LAUNCHES)
    q0, q1 = (q.numpy() for q in quad_gather(*args))
    assert LAUNCHES == launches          # CPU tensors: the twin, no launch
    for got, ref, f in ((q0, r0, f0), (q1, r1, f1)):
        assert got.shape == (3, n) and got.dtype == np.int32
        np.testing.assert_array_equal(got[:, valid], ref[:, valid])
        np.testing.assert_array_equal(got[:, valid],
                                      data4q.view(np.int32)[f[valid]].T)
        assert (got[:, ~valid] == 0).all()
    for a, b in zip(quad_gather_plain(*args), (q0, q1)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_sample_texture_kernel_matches_torch():
    jscene = build_scene(procedural.scene_textured_mesh())
    scene = scene_from_numpy(jscene)
    rng = np.random.default_rng(7)
    n = 4096
    uv = rng.random((2, n), np.float32) * 3.0
    tid = rng.integers(0, np.asarray(jscene.textures.offsets).shape[0],
                       n).astype(np.int32)
    lod = rng.random(n, np.float32) * 9.0
    valid = rng.random(n) > 0.2
    t = torch.from_numpy
    a = shade._sample_texture(scene, t(tid), t(uv), t(lod), backend="torch")
    b = shade._sample_texture(scene, t(tid), t(uv), t(lod),
                              valid=t(valid), backend="kernel")
    assert a.shape == (3, n)
    np.testing.assert_array_equal(a.numpy()[:, valid], b.numpy()[:, valid])
    # and the torch backend is the JAX package's jnp sampling
    ref = np.asarray(jax_shade._sample_texture(
        jscene, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(lod)))
    np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-6)
