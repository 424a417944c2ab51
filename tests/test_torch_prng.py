"""The port's random streams (`utils.prng`) against `jax.random`, bit for
bit on the CPU: the threefry-2x32 hash, `PRNGKey`, `fold_in` and `split`
(keys as `jax.random.key_data` words) and `uniform` at odd and even sizes,
and the config 5 jitter fingerprints that chip_smoke.py pins for its draw
on the card, derived again here from `jax.random`."""

import jax
import jax.extend.random as jax_extend_random
import numpy as np
import pytest
import torch

import chip_smoke
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
