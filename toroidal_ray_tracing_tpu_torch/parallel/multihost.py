"""Meshes across nodes (the JAX package's `parallel/multihost.py`).

Rendering over "rays" is pure data parallelism: nothing crosses a node
while tracing, only the finished bands at the end. The per-bounce merge
over "prims" is latency-bound and stays inside a node. So the hybrid
mesh orders "rays" node-major (each node owns one contiguous band of the
frame) and keeps every "prims" row within one node.

A node is what the launcher calls one (torchrun's `GROUP_RANK`, with
`LOCAL_RANK` and `LOCAL_WORLD_SIZE` inside it); a process without those
variables is one node holding every rank.

Usage on each rank of a job started by torchrun:

    from toroidal_ray_tracing_tpu_torch.parallel import multihost
    multihost.init_distributed()              # env:// from the launcher
    mesh = multihost.make_hybrid_mesh(n_prim_shards=2)
    out = render_sharded(scene, cam, W, H, settings, mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from toroidal_ray_tracing_tpu_torch.parallel.sharding import AXES


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group (idempotent).

    With no arguments it joins only when the environment describes a
    multi-process job (a launcher's WORLD_SIZE > 1 with MASTER_ADDR), over
    `env://`; a single process is left alone. backend: default NCCL when
    a GPU is present, else gloo. A real failure raises: a job whose ranks
    silently rendered as single processes would return wrong bands."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None:
        env = os.environ
        if int(env.get("WORLD_SIZE", "1")) <= 1 or "MASTER_ADDR" not in env:
            return
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def _node() -> tuple:
    """(node, local rank, ranks per node) of this process, from the
    launcher's environment."""
    env = os.environ
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    local_size = int(env.get("LOCAL_WORLD_SIZE", world))
    return (int(env.get("GROUP_RANK", rank // local_size)),
            int(env.get("LOCAL_RANK", rank % local_size)), local_size)


def make_hybrid_mesh(n_prim_shards: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """("rays", "prims") mesh over every rank, node-major: ranks ordered
    by (node, local rank), so each node's ranks fill whole mesh rows and
    the frame's band of a node is contiguous. n_prim_shards must divide
    the ranks per node (the "prims" merge stays inside a node)."""
    world = dist.get_world_size()
    node, local, _ = _node()
    ids = [None] * world
    dist.all_gather_object(ids, (node, local, dist.get_rank()))
    per_node: dict = {}
    for nd, _, r in ids:
        per_node.setdefault(nd, []).append(r)
    sizes = {len(v) for v in per_node.values()}
    if len(sizes) != 1:
        raise ValueError("uneven nodes: "
                         f"{ {k: len(v) for k, v in per_node.items()} }")
    per = sizes.pop()
    if per % n_prim_shards:
        raise ValueError(f"prims axis {n_prim_shards} must divide the ranks "
                         f"per node ({per}): it must stay inside a node")
    order = [r for _, _, r in sorted(ids)]
    mesh = torch.tensor(order, dtype=torch.int64).reshape(
        world // n_prim_shards, n_prim_shards)
    return DeviceMesh(device_type, mesh, mesh_dim_names=AXES)


def host_band(height: int, width: int) -> tuple:
    """(row0, rows) of the frame band this node's "rays" ranks cover under
    the node-major mesh: `render_sharded` splits the flat pixel batch
    evenly, so the band is whole rows only when the height divides over
    the nodes; anything else raises (band-streamed dumps would write
    another node's pixels)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    node, _, per = _node()
    nodes = world // per
    if height % nodes:
        raise ValueError(f"host_band: height {height} must be divisible by "
                         f"the node count {nodes}")
    rows = height // nodes
    return node * rows, rows
