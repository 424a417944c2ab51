"""The port's random streams (`utils.prng`) against `jax.random`, bit for
bit on the CPU: the threefry-2x32 hash, `PRNGKey`, `fold_in` and `split`
(keys as `jax.random.key_data` words) and `uniform` at odd and even sizes,
the config 5 jitter fingerprints that chip_smoke.py pins for its draw
on the card, derived again here from `jax.random`, and the threefry
kernel's wrapper (its checks, and the front doors' draws through it)."""

import jax
import jax.extend.random as jax_extend_random
import numpy as np
import pytest
import torch

import chip_smoke
from toroidal_ray_tracing_tpu_torch import (PinholeCamera, RenderSettings,
                                            render, render_frames,
                                            render_sequence)
from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel
from toroidal_ray_tracing_tpu_torch.scene import build_scene, procedural
from toroidal_ray_tracing_tpu_torch.utils import prng

torch.set_num_threads(2)

SEEDS = [0, 3, 123456, 2**31 - 1]
DATA = [0, 1, 15]
SIZES = [1, 37, 768, 4097]


def words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32_matches_jax(seed):
    """Random keys and counters over the whole 32-bit range, on int64
    tensors and on Python ints."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, (2, 64), dtype=np.uint32)
    want = np.asarray(jax_extend_random.threefry_2x32(key, x.ravel()))
    y0, y1 = prng.threefry2x32(int(key[0]), int(key[1]),
                               torch.from_numpy(x[0].astype(np.int64)),
                               torch.from_numpy(x[1].astype(np.int64)))
    got = np.concatenate([y0.numpy(), y1.numpy()])
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert prng.threefry2x32(int(key[0]), int(key[1]), int(x[0, 5]),
                             int(x[1, 5])) == (int(want[5]), int(want[69]))


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5])
def test_prng_key_matches_jax(seed):
    """Over [0, 2^31) as stated; -1 and 2^32 + 5 wrap modulo 2^32 as the
    docstring says JAX does with 64-bit types off."""
    assert prng.prng_key(seed) == words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed, data):
    key = jax.random.PRNGKey(seed)
    assert (prng.fold_in(prng.prng_key(seed), data)
            == words(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    """Two steps of the banded render's `key, sub = split(key)` chain."""
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for _ in range(2):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        assert (key, sub) == (words(jkey), words(jsub))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, n):
    """(n, 2) draws (the jitter's shape) from a fold_in key and from a
    split key, and (n,) draws, odd n included."""
    fold = prng.fold_in(prng.prng_key(seed), 1)
    jfold = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    sub = prng.split(prng.prng_key(seed))[1]
    jsub = jax.random.split(jax.random.PRNGKey(seed))[1]
    for key, jkey, shape in ((fold, jfold, (n, 2)), (sub, jsub, (n, 2)),
                             (fold, jfold, (n,))):
        got = prng.uniform(key, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        want = jax.random.uniform(jkey, shape, np.float32)
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("sample", sorted(chip_smoke.JITTER_PINS))
def test_config5_jitter_pins(sample):
    """chip_smoke.py's fingerprints of config 5's jitter (3840x2160, keys
    fold_in(PRNGKey(0), 1) and fold_in(PRNGKey(0), 15): sample 1 of frames
    0 and 7) equal `jax.random.uniform`'s draw."""
    shape = (chip_smoke.JITTER_PIXELS, 2)
    key = jax.random.fold_in(jax.random.PRNGKey(0), sample)
    w = bits(jax.random.uniform(key, shape, np.float32)).ravel()
    assert chip_smoke.jitter_fingerprint(w) == chip_smoke.JITTER_PINS[sample]


# The threefry kernel's wrapper (`ops.threefry_kernel.uniform`): on the
# CPU it returns its twin, so these hold the twin to `jax.random.uniform`
# at the sizes that give the kernel's 4-element stores tails of 1-3, and
# show that every spp > 1 front door draws through the wrapper. The kernel
# itself meets the twin on the card (chip_smoke.py phases 3 and 12).
KERNEL_SIZES = [1, 2, 3, 5, 127, 1025, 4099]
KERNEL_SEEDS = [0, 1, 2**31 - 1]


@pytest.mark.parametrize("n", KERNEL_SIZES)
@pytest.mark.parametrize("seed", KERNEL_SEEDS)
def test_kernel_wrapper_matches_jax(seed, n):
    """(n, 2) and (n,) draws under PRNGKey(seed), a fold_in key and a
    split key."""
    root, jroot = prng.prng_key(seed), jax.random.PRNGKey(seed)
    keys = ((root, jroot),
            (prng.fold_in(root, 3), jax.random.fold_in(jroot, 3)),
            (prng.split(root)[1], jax.random.split(jroot)[1]))
    for key, jkey in keys:
        for shape in ((n, 2), (n,)):
            got = threefry_kernel.uniform(key, shape, "cpu")
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            want = jax.random.uniform(jkey, shape, np.float32)
            np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("key, shape, device", [
    ((2**32, 0), (4, 2), "cuda"), ((0, -1), (4, 2), "cuda"),
    ((0, 1), (4, -2), "cuda"), ((0, 1), (4, 2), "meta")])
def test_kernel_wrapper_refuses(key, shape, device):
    """Key words outside [0, 2^32), a negative size and a device that is
    neither CUDA nor the CPU raise before anything is allocated."""
    with pytest.raises(ValueError):
        threefry_kernel.uniform(key, shape, device)


def test_kernel_wrapper_has_no_fallback(monkeypatch):
    """Without a card a CUDA draw raises; it never returns the twin."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        threefry_kernel.uniform((0, 1), (4, 2), "cuda")


def _front_door(name, scene, cams, st):
    kw = dict(backend="torch", spp=2, seed=5, device="cpu")
    if name == "render":
        return render(scene, cams[0], 8, 8, st, **kw)
    if name == "render_tile_rows":
        return render(scene, cams[0], 8, 8, st, tile_rows=3, **kw)
    fn = render_sequence if name == "render_sequence" else render_frames
    return fn(scene, cams, 8, 8, st, **kw)


@pytest.mark.parametrize("front", ["render", "render_tile_rows",
                                   "render_sequence", "render_frames"])
def test_front_doors_draw_through_kernel_wrapper(front, monkeypatch):
    """spp = 2 at 8x8: one wrapper call a jittered sample (one a frame),
    with the reference's key for it, and every draw of `utils.prng` made
    from inside the wrapper, none from the renderer directly."""
    calls, twin_calls = [], []
    wrapper, twin = threefry_kernel.uniform, prng.uniform

    def counted_wrapper(key, shape, device="cuda"):
        calls.append((key, tuple(shape)))
        return wrapper(key, shape, device)

    def counted_twin(*args, **kw):
        twin_calls.append(args[0])
        return twin(*args, **kw)

    monkeypatch.setattr(threefry_kernel, "uniform", counted_wrapper)
    monkeypatch.setattr(prng, "uniform", counted_twin)
    scene = build_scene(procedural.scene_multi_torus(True))
    cams = [PinholeCamera(eye=(8.0, 5.0 + f, 8.0), center=(0.0, 0.5, 0.0))
            for f in range(2)]
    st = RenderSettings.default(max_depth=1)
    out = _front_door(front, scene, cams, st)
    root = prng.prng_key(5)
    if front == "render":
        want = [prng.fold_in(root, 1)]
    elif front == "render_tile_rows":
        want = [prng.split(root)[1]]
    else:
        want = [prng.fold_in(root, f * 2 + 1) for f in range(2)]
    assert calls == [(k, (64, 2)) for k in want]
    assert twin_calls == want
    assert out["rays_traced"] > 0
