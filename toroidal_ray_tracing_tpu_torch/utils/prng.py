"""The JAX package's random streams, without JAX: the threefry-2x32 hash
and the `PRNGKey` / `fold_in` / `split` / `uniform` of `jax.random` (JAX
0.9.0, `jax_threefry_partitionable` on, its default), bit for bit.

The reference draws every jittered sample of an spp > 1 render from these
streams (`render`: `uniform(fold_in(PRNGKey(seed), s), (n, 2))`; the
sequence front doors: `fold_in(PRNGKey(seed), f * spp + s)`; the banded
path: a `split` chain). A key is a pair of Python ints (the two uint32
words of `jax.random.key_data`): key math is a few scalars on the host.
`uniform` draws on the device it is given.

The hash works on Python ints and on int64 tensors alike: every value is
held below 2^32 by masking after each add and shift, so nothing
overflows and shifts right are logical.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA          # threefry's key-schedule constant


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX `prng.py`'s
    `_threefry2x32_lowering`): key (k1, k2), counter words (x0, x1), each a
    Python int or an int64 tensor of values in [0, 2^32). Returns the two
    output words, masked to 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """`jax.random.PRNGKey(seed)`'s two words: (0, seed). Equal to JAX's
    over 0 <= seed < 2^31. Outside that range the seed is taken modulo
    2^32, as JAX 0.9.0 does with 64-bit types off (-1 gives (0, 2^32 - 1),
    2^32 + 5 gives (0, 5)); with `jax_enable_x64` JAX would keep a high
    word, which this does not."""
    return (0, int(seed) & MASK)


def fold_in(key: tuple, data: int) -> tuple:
    """`jax.random.fold_in(key, data)`: the hash of the counter
    (0, data mod 2^32) under `key`."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key: tuple) -> tuple:
    """`jax.random.split(key)` into two keys (the fold-like split: the
    hashes of counters (0, 0) and (0, 1)). `key, sub = split(key)` steps a
    chain as the reference's banded render does."""
    return (threefry2x32(key[0], key[1], 0, 0),
            threefry2x32(key[0], key[1], 0, 1))


def uniform(key: tuple, shape, device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32)` in [0, 1), drawn on
    `device`: element i (row-major) hashes the 64-bit counter i, split
    into its high and low words, and keeps the xor of the two outputs; its
    top 23 bits become the mantissa of a float in [1, 2), less 1."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    # the float bits are below 2^31, so int32 holds them and the view as
    # float32 reads the float they spell
    ones = bits.to(torch.int32).view(torch.float32)
    return (ones - 1.0).reshape(shape)
