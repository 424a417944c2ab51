"""The jitter draw: `jax.random.uniform(key, shape, float32)` on the card.

`uniform` is the wrapper: on a CUDA device it launches the hand-written
kernel `csrc/threefry.cu::threefry_uniform` (threefry-2x32 of each
element's 64-bit index, 4 elements a thread); on the CPU it returns
`utils.prng.uniform`, the kernel's plain twin, with the same contract. It
is the port's counterpart of the JAX package's `jax.random.uniform` draws
of the spp > 1 jitter (`toroidal_ray_tracing_tpu/render/renderer.py:53,
:243, :459`), which XLA fuses into one device pass; it replaces no Pallas
kernel.
"""

from __future__ import annotations

import math

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import F32, launch
from toroidal_ray_tracing_tpu_torch.utils import prng


def uniform(key: tuple, shape, device="cuda") -> torch.Tensor:
    """`prng.uniform(key, shape, device)`, bit for bit: float32 in [0, 1)
    of the given shape. key: the two uint32 words (Python ints). A CUDA
    device launches the kernel (or raises); the CPU runs the twin."""
    device = torch.device(device)
    if device.type == "cpu":
        return prng.uniform(key, shape, device)
    if device.type != "cuda":
        raise ValueError(f"threefry uniform on {device}: the kernel runs on "
                         "CUDA, its twin on the CPU")
    k1, k2 = (int(w) for w in key)
    if not (0 <= k1 <= prng.MASK and 0 <= k2 <= prng.MASK):
        raise ValueError(f"key words {key} not in [0, 2^32)")
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"shape {shape} has a negative size")
    if not torch.cuda.is_available():
        raise RuntimeError(f"threefry uniform on {device}: no CUDA device "
                           "available")
    out = torch.empty(shape, dtype=F32, device=device)
    n = math.prod(shape)
    if n:
        with torch.cuda.device(device):
            launch("trt_threefry_uniform", out, n, k1, k2)
    return out
