"""The collectives of the multi-device path, on `torch.distributed`.

A group whose backend is gloo moves host memory: the tensors of a
collective on such a group are copied to the host, reduced or gathered
there, and copied back to their device. That staging is how the backend
works (ranks that share one card cannot form an NCCL group), not a
fallback. NCCL groups take device tensors as they are.

Every function returns a new tensor and leaves its input as it was
(`all_reduce` works in place, so the input is cloned first).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

MIN = dist.ReduceOp.MIN
MAX = dist.ReduceOp.MAX
SUM = dist.ReduceOp.SUM


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """The reduction `op` (MIN, MAX, SUM) of `t` over `group`; bool tensors
    reduce as int32 (MAX is any, MIN is all)."""
    src = t.to(torch.int32) if t.dtype == torch.bool else t
    buf = src.cpu().clone() if _staged(src, group) else src.clone()
    dist.all_reduce(buf, op=op, group=group)
    buf = buf.to(t.device)
    return buf.bool() if t.dtype == torch.bool else buf


def all_gather_cols(t: torch.Tensor, group) -> torch.Tensor:
    """(C, n) on every rank of `group` -> (C, n * size): the ranks' columns
    side by side in group-rank order."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(t.device)
