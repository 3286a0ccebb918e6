"""Data parallelism over ``torch.distributed`` (``ctrl_adapter_tpu/parallel/mesh.py``'s counterpart).

The reference trains data-parallel only (DDP over NCCL through accelerate); the
JAX package shards the batch over a 1-D ``data`` mesh and XLA all-reduces the
gradients. Here each process (one per card, started by ``torchrun``) holds the
whole model and takes its slice of the global batch (``shard_batch``); the
trainer averages its fp32 gradients over the processes (``all_reduce_mean_``)
before the clip and AdamW, as optax runs after XLA's all-reduce. A run that
joins no group is a world of one process (``Mesh()``).

Generation (the pipelines' ``generate(..., mesh=...)``, the JAX ``mesh=``
argument): JAX shards the batch over the ``data`` axis and XLA keeps the
global program's semantics, so the sharded output equals the one-process run.
Here each rank takes its slice of the videos (``batch_rows``) and builds its
own CFG batch [negatives; positives] (``take_cfg``), and the outputs are
gathered into the global batch on every rank (``gather``). Where the global
computation mixes videos, a rank is handed what it needs of the global batch:
the conditional routers' batch mean (``all_reduce_mean``), and the temporal
transformers' single-key time context, which pairs the block's batch-major
rows with the spatial-major context of the whole CFG batch
(``global_rows``, read by ``time_context``).
"""

from __future__ import annotations

import contextlib
import contextvars
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


# ------------------------------------------------------------------ generation
def batch_rows(mesh: Mesh, b: int) -> slice:
    """This rank's videos of a global batch of ``b``: the ``rank``-th of
    ``world_size`` equal parts; raises where ``b`` does not divide."""
    if b % mesh.world_size:
        raise ValueError(f"batch {b} not divisible by data-axis size {mesh.world_size}")
    n = b // mesh.world_size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def cfg_index(mesh: Mesh, b: int, device=None) -> torch.Tensor:
    """The global rows of this rank's CFG batch [its negatives; its positives]
    in the global [negatives; positives] batch of 2b rows."""
    rows = batch_rows(mesh, b)
    local = torch.arange(rows.start, rows.stop, device=device)
    return torch.cat([local, local + b])


def take_cfg(mesh: Mesh, x: torch.Tensor, b: int) -> torch.Tensor:
    """This rank's rows of a global CFG-doubled (2b, ...) tensor."""
    return x.index_select(0, cfg_index(mesh, b, x.device))


def gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' (b_local, ...) tensors concatenated in rank order along axis
    0, on every rank: the global batch (``x`` itself without a group)."""
    if mesh.group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def all_reduce_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a (b_local, D) tensor, (D,) fp32 on
    every rank: the local rows' sum all-reduced, over the global row count."""
    total = x.float().sum(dim=0)
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    return total / (x.shape[0] * mesh.world_size)


@dataclasses.dataclass(frozen=True)
class GlobalRows:
    """Where a rank's batch sits in the global one, for the single-key time
    context: ``context`` the global batch's first-frame encoder states
    (B, n, d), ``index`` (B_local,) the global row of each local row."""
    context: torch.Tensor
    index: torch.Tensor


_GLOBAL_ROWS: contextvars.ContextVar = contextvars.ContextVar("global_rows", default=None)


@contextlib.contextmanager
def global_rows(rows: Optional[GlobalRows]):
    """Within the block, ``time_context`` pairs rows as the global batch
    ``rows`` describes (None: the local batch is the whole batch)."""
    token = _GLOBAL_ROWS.set(rows)
    try:
        yield
    finally:
        _GLOBAL_ROWS.reset(token)


def time_context(encoder_hidden_states: torch.Tensor, b: int, num_frames: int,
                 hw: int) -> torch.Tensor:
    """The temporal transformers' single-key context, (hw * b, n, d): each
    video's first-frame encoder states broadcast over the hw pixels,
    spatial-major (row p * B + v), as diffusers and the JAX package build it,
    while the block's rows are batch-major (v * hw + p): at batch > 1 a row
    pairs with another video's context. Under ``global_rows`` the rows pair as
    they do in the global batch: local row (v, p), global row g(v) * hw + p,
    takes global context (g(v) * hw + p) mod B."""
    d = encoder_hidden_states.shape[-1]
    first = encoder_hidden_states.reshape(b, num_frames, -1, d)[:, 0]
    rows = _GLOBAL_ROWS.get()
    if rows is None:
        return first[None].expand(hw, *first.shape).reshape(hw * b, -1, d)
    if rows.index.numel() != b:
        raise ValueError(f"global_rows: {rows.index.numel()} local rows, the block has {b}")
    index = rows.index.to(first.device)
    pixel = torch.arange(hw, device=first.device)
    pick = (index[:, None] * hw + pixel[None]) % rows.context.shape[0]
    return rows.context.to(first.device, first.dtype)[pick.reshape(-1)]
