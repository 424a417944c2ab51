"""The port's graft entry `toroidal_ray_tracing_tpu_torch.entry.entry()`
against the JAX package's `__graft_entry__.entry()` on the CPU: the same
flagship rays (config 3's scene, eye (8, 5, 8), depth 3, 64x64), traced
by `fn` (the kernel backend, its plain twins here) and by the torch
backend, against `jax.jit(fn)(*args)` (jnp): max |color diff| < 5e-4
(tests/test_golden.py's bound), first-hit positions within 1e-4, ray
counts exact."""

import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from toroidal_ray_tracing_tpu_torch.entry import entry
from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    fn, args = graft.entry()
    color, hitpos, rays = jax.jit(fn)(*args)
    return args, np.asarray(color), np.asarray(hitpos), int(float(rays))


def test_entry_args_are_the_jax_entrys():
    """fn is trace_rays on the kernel backend; args hold the scene and
    settings on the device and the JAX entry's rays as (3, N) rows."""
    fn, (scene, settings, origins, dirs) = entry(device="cpu")
    assert isinstance(fn, functools.partial) and fn.func is trace_rays
    assert fn.keywords == {"backend": "kernel"}
    assert scene.device.type == "cpu" and int(settings.max_depth) == 3
    _, _, jorigins, jdirs = graft.entry()[1]
    for got, want in ((origins, jorigins), (dirs, jdirs)):
        assert tuple(got.shape) == (3, 64 * 64) and got.is_contiguous()
        np.testing.assert_allclose(got.T.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_entry_matches_jax(reference, backend):
    fn, args = entry(device="cpu")
    if backend == "torch":
        fn = functools.partial(trace_rays, backend="torch")
    color, hitpos, rays = fn(*args)
    _, jcolor, jhitpos, jrays = reference
    assert rays == jrays
    assert bool(torch.isfinite(color).all())
    err = float(np.abs(color.T.numpy() - jcolor).max())
    assert err < 5e-4, f"{backend}: max color diff {err}"
    np.testing.assert_allclose(hitpos.T.numpy(), jhitpos, rtol=0, atol=1e-4)


def test_entry_defaults_to_cuda():
    """entry() builds its args on the CUDA device unless asked for the
    CPU: with no GPU it raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        assert entry()[1][2].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
