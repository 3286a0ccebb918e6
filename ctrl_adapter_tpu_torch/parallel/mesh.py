"""Data parallelism over ``torch.distributed`` (``ctrl_adapter_tpu/parallel/mesh.py``'s counterpart).

The reference trains data-parallel only (DDP over NCCL through accelerate); the
JAX package shards the batch over a 1-D ``data`` mesh and XLA all-reduces the
gradients. Here each process (one per card, started by ``torchrun``) holds the
whole model and takes its slice of the global batch (``shard_batch``); the
trainer averages its fp32 gradients over the processes (``all_reduce_mean_``)
before the clip and AdamW, as optax runs after XLA's all-reduce. A run that
joins no group is a world of one process (``Mesh()``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (``group`` None: one
    process, no group)."""
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None


def local_rank() -> int:
    """The process's card on its host, as ``torchrun`` sets it."""
    return int(os.environ.get("LOCAL_RANK", 0))


def join(device: torch.device) -> Mesh:
    """Join the process group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), a world of one included: ``nccl`` for a
    CUDA device, ``gloo`` for the CPU."""
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return Mesh(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)


def leave(mesh: Mesh) -> None:
    """Destroy the group ``join`` joined."""
    if mesh.group is not None:
        dist.destroy_process_group()


def shard_batch(mesh: Mesh, batch: Dict[str, torch.Tensor], axis: int = 0
                ) -> Dict[str, torch.Tensor]:
    """This rank's slice of each tensor of a global batch along ``axis``: the
    ``rank``-th of ``world_size`` equal parts."""
    out = {}
    for name, x in batch.items():
        n, rem = divmod(x.shape[axis], mesh.world_size)
        if rem:
            raise ValueError(f"{name}: {x.shape[axis]} rows along axis {axis} do not split "
                             f"over {mesh.world_size} processes")
        out[name] = x.narrow(axis, mesh.rank * n, n)
    return out


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite each tensor, in place, with rank 0's."""
    if mesh.group is not None:
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)


def all_reduce_mean_(flat: torch.Tensor, group) -> torch.Tensor:
    """In place: the sum over the group's processes, divided by their number."""
    dist.all_reduce(flat, group=group)
    return flat.div_(dist.get_world_size(group))
