"""Named device meshes over the ranks of a torch.distributed world
(counterpart of isac_tpu/parallel/mesh.py).

A JAX `Mesh` of named axes becomes a `DeviceMesh` with `mesh_dim_names`, one
device per rank. A `shard_map` body becomes per-rank code: the rank takes its
block of a global argument (`shard`), computes on it and reduces (`psum`) or
gathers (`gather`) over the axis's process group, NCCL on the card and gloo
on the CPU. The collectives move complex tensors as their real view and
booleans as bytes, which every backend takes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_sizes: dict | None = None, device_type: str | None = None) -> DeviceMesh:
    """Build a named mesh over the world's ranks. axis_sizes: ordered
    {axis_name: size}; the sizes must multiply to the world size (one axis
    `cell` of all ranks by default). device_type: None takes the process
    group's ('cuda' under NCCL, else 'cpu'). Needs an initialised process
    group (parallel/distributed.py init_distributed)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"cell": world}
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh axes {axis_sizes} != {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=tuple(axis_sizes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_info(mesh: DeviceMesh, axis: str) -> tuple:
    """(process group, this rank's index on the axis, the axis's size)."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def shard(x: torch.Tensor, index: int, size: int, dim: int = 0) -> torch.Tensor:
    """Block `index` of `size` equal blocks of x along dim (shard_map's
    P(axis) split; the length must divide, as there)."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of length {n} does not split into {size} blocks")
    b = n // size
    return x.narrow(dim, index * b, b)


def _wire(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.view_as_real(x.contiguous())
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x.contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(y.contiguous())
    if like.dtype == torch.bool:
        return y.bool()
    return y


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The axis's blocks concatenated along dim in rank order, on every rank
    (all_gather(tiled=True))."""
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return _unwire(torch.cat(parts, dim=dim), x)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the axis, on every rank (a copy; x is left as it is)."""
    w = _wire(x).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return _unwire(w, x)
