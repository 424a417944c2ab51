"""K4: the texture quad gather.

`quad_gather` is the wrapper: on CUDA tensors it launches the hand-written
kernel `csrc/tex_gather.cu::quad_gather` (one thread per ray); on CPU
tensors it runs `quad_gather_plain`, the plain PyTorch twin with the same
inputs and outputs. It replaces the JAX package's TPU kernel
`ops/tex_kernel.py:57` (`_tex_kernel`, launched by `quad_gather_pallas`).

Contract: per ray, the quad-packed atlas rows (`TextureAtlas.data4q`, int32
bits of the packed words) at the two trilinear texel indices f0 and f1;
rays that are not valid, or whose index lies outside the atlas, get zero
words. The TPU kernel's atlas-size cap, its off switch and its span-range
prepass exist for the TPU's memory and gathers and are not carried over:
every atlas of more than one texel takes this kernel on `backend="kernel"`.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (I32,
                                                              check_args,
                                                              fill, launch)


def quad_gather_plain(data4q, f0, f1, valid):
    """Plain PyTorch twin: ((3, N), (3, N)) int32 words."""
    T = data4q.shape[0]
    out = []
    for f in (f0, f1):
        ok = valid & (f >= 0) & (f < T)
        q = data4q[torch.where(ok, f, 0).long()].T
        out.append(torch.where(ok[None, :], q, 0).contiguous())
    return tuple(out)


def check_quad_gather(data4q, f0, f1, valid, out=None) -> None:
    """`quad_gather`'s argument checks (a segment plan runs them once on
    its own arguments and outputs)."""
    n = f0.shape[0]
    T = data4q.shape[0]
    check_args(f0.device, data4q=(data4q, (T, 3), I32), f0=(f0, (n,), I32),
               f1=(f1, (n,), I32), valid=(valid, (n,), torch.bool))
    if out is not None:
        check_args(f0.device, q0=(out[0], (3, n), I32),
                   q1=(out[1], (3, n), I32))


def quad_gather(data4q, f0, f1, valid, out=None):
    """K4 wrapper. data4q: (T, 3) int32; f0/f1: (N,) int32 flat texel
    indices; valid: (N,) bool. out: (q0, q1) from a segment plan
    (`kernel_common.Planned`; no check, no allocation). Returns (q0, q1),
    each (3, N) int32."""
    n = f0.shape[0]
    if out is None:
        check_quad_gather(data4q, f0, f1, valid)
    if not f0.is_cuda:
        got = quad_gather_plain(data4q, f0, f1, valid)
        return got if out is None else fill(out, got)
    if out is None:
        out = (torch.empty((3, n), dtype=I32, device=f0.device),
               torch.empty((3, n), dtype=I32, device=f0.device))
    if n:
        launch("trt_quad_gather", data4q, data4q.shape[0], f0, f1, valid, n,
               *out, stream=getattr(out, "stream", None))
    return out
