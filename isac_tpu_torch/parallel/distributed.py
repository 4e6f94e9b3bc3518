"""Joining a torch.distributed world (counterpart of
isac_tpu/parallel/distributed.py).

Every process runs the same program on its own device: one rank per card
under NCCL, or one per CPU process under gloo. `init_distributed` joins the
process group, `global_mesh` lays named axes over all ranks, and the
per-rank functions of parallel/links.py, cells.py and time_blocks.py then
reduce and gather over the axes' groups.

Launch, one process per rank (torchrun sets the variables that
init_distributed reads):

    torchrun --nproc-per-node 4 your_app.py

or by hand, every process with its own rank:

    init_distributed("10.0.0.1:29500", num_processes=N, process_id=K)

then build the mesh and hand it to the engine and network layers:

    mesh = global_mesh({"cell": n_cells, "time": -1})
    CellSimulator(cell, mesh=mesh)              # sharded sensing RDM
    network_dl_step(mesh, axis="cell")          # inter-cell interference step
    make_link_step(grant, mesh=mesh)            # link-axis CRC-pass count

Unlike jax.distributed, a single process still joins a group (a world of one
on an in-memory store, no network), because a torch mesh needs one.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from isac_tpu_torch.parallel.mesh import make_mesh
from isac_tpu_torch.utils.device import resolve_device


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> dict:
    """Join this process to the world: NCCL when `device` is the card (None
    means the card), gloo for device='cpu'.

    All-None arguments read torchrun's variables (MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK). A process with neither arguments nor those
    variables joins a world of one on an in-memory HashStore. Calling it again
    in a joined process returns the same information; asking then for
    another backend raises.

    Returns {"process_id", "num_processes", "global_devices",
    "local_devices"} (one device per rank)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not {backend} for {dev}")
    else:
        env = os.environ
        coord = coordinator_address
        if coord is None and "MASTER_ADDR" in env:
            coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        n = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
        rank = process_id if process_id is not None else int(env.get("RANK", "0"))
        if dev.type == "cuda":
            local = dev.index if dev.index is not None else int(
                env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        if coord is None:
            if n != 1:
                raise ValueError(f"a world of {n} processes needs a coordinator address")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                    world_size=n, rank=rank)
    world = dist.get_world_size()
    return {
        "process_id": dist.get_rank(),
        "num_processes": world,
        "global_devices": world,
        "local_devices": 1,
    }


def global_mesh(axes: dict, device_type: str | None = None) -> DeviceMesh:
    """A named mesh over ALL ranks of the world.

    `axes` maps axis name -> size; at most one size may be -1 (inferred).
    The LAST axis varies fastest over ranks, so put the axis with the most
    traffic (e.g. `time`, whose RDM all_reduce is the largest) last and the
    one with the least (e.g. `cell`, one all_gather of transmit grids per
    slot) first."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    sizes = list(axes.values())
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if n_infer:
        if world % known:
            raise ValueError(f"{world} ranks not divisible by {known}")
        sizes = [world // known if s == -1 else s for s in sizes]
    return make_mesh(dict(zip(axes, sizes)), device_type)
