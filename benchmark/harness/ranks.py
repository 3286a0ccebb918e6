"""A cell's processes: one per card, ranks of one process group.

A one-card cell runs its body once, in the process that was started, on
``cuda:0``, with no process group. For a cell of n > 1 cards the process that
was started is the launcher (``launch``): it runs the same script with the
same arguments as n ranks under torch's elastic launcher, as ``torchrun
--standalone --nproc-per-node=n`` would, and waits for them. Each rank joins
the group that the launcher describes with the program's own
``parallel/mesh.py:join`` (NCCL on ``cuda:<LOCAL_RANK>``; gloo on the CPU, in
the rehearsal of ``tests/``). Rank 0 prints the result; the others print
nothing on standard output. When a rank exits with an error the launcher
stops the others at once (SIGTERM, then SIGKILL after its grace of 30 s) and
raises ``ChildFailed``, so a rank that fails never leaves the run hanging in
a collective.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, List

import torch

FAILED = 5  # the launcher's exit code when a rank failed


class ChildFailed(RuntimeError):
    """A rank ended with an error."""


def rank() -> int:
    """This process's rank; 0 outside a cell of several cards."""
    return int(os.environ.get("RANK", 0))


def launcher(chips: int) -> bool:
    """Whether this process has to start the ranks: a cell of several cards,
    and not itself started by the launcher."""
    return chips > 1 and "TORCHELASTIC_RUN_ID" not in os.environ


def launch(chips: int, script: str, argv: List[str], log: Callable = print) -> None:
    """``script`` with ``argv`` as ``chips`` ranks on this host; returns when
    every rank exited with 0, else logs each failed rank and raises
    ``ChildFailed``."""
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    config = LaunchConfig(min_nodes=1, max_nodes=1, nproc_per_node=chips, run_id="benchmark",
                          rdzv_backend="c10d", rdzv_endpoint="localhost:0", max_restarts=0,
                          local_addr="localhost")
    try:
        elastic_launch(config, sys.executable)(script, *argv)
    except ChildFailedError as err:
        log("; ".join(f"rank {r} exited with {f.exitcode}"
                      for r, f in sorted(err.failures.items())) + ": the run ended")
        raise ChildFailed("a rank failed") from None


def device(local_rank: int, cuda: bool) -> torch.device:
    if cuda:
        torch.cuda.set_device(local_rank)
        return torch.device("cuda", local_rank)
    return torch.device("cpu")


def run(body: Callable, chips: int, cuda: bool = True):
    """``body(device, group)`` in this process: with no group on a one-card
    cell, else as the rank the launcher started, in the program's group."""
    if chips == 1:
        return body(device(0, cuda), None)
    from ctrl_adapter_tpu_torch.parallel import mesh

    dev = device(mesh.local_rank(), cuda)
    group = mesh.join(dev)
    try:
        return body(dev, group.group)
    finally:
        mesh.leave(group)


class Ranks:
    """The collectives a mode makes over its cell's ranks. Without a group (a
    one-card cell) each returns its own argument and makes no collective."""

    def __init__(self, group, dev: torch.device):
        import torch.distributed as dist

        self.dist, self.group, self.dev = dist, group, dev
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    def _reduce(self, values, op, dtype=torch.float64) -> List:
        if self.group is None:
            return list(values)
        t = torch.tensor(list(values), dtype=dtype, device=self.dev)
        self.dist.all_reduce(t, op=op, group=self.group)
        return t.tolist()

    def lead(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank: one one-element broadcast."""
        if self.group is None:
            return go
        t = torch.tensor([int(go)], device=self.dev)
        self.dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def mean(self, values) -> List[float]:
        """Each of ``values`` averaged over the ranks, in float64."""
        return [v / self.world for v in self._reduce(values, self.dist.ReduceOp.SUM)]

    def max(self, value: int) -> int:
        return int(self._reduce([value], self.dist.ReduceOp.MAX, torch.int64)[0])

    def all(self, ok: bool) -> bool:
        return bool(self._reduce([int(ok)], self.dist.ReduceOp.MIN, torch.int64)[0])

    def gather(self, value: int) -> List[int]:
        """``value`` of every rank, in rank order."""
        if self.group is None:
            return [value]
        out = [torch.zeros(1, dtype=torch.int64, device=self.dev) for _ in range(self.world)]
        self.dist.all_gather(out, torch.tensor([value], device=self.dev), group=self.group)
        return [int(t.item()) for t in out]

    def differ(self, tensors) -> int:
        """The number of ranks whose ``tensors`` are not rank 0's to the bit."""
        if self.group is None:
            return 0
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors]).view(torch.int32)
        ref = flat.clone()
        self.dist.broadcast(ref, 0, group=self.group)
        return int(self._reduce([int(not torch.equal(flat, ref))], self.dist.ReduceOp.SUM,
                                torch.int64)[0])

    def average(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients averaged over the ranks in fp32, in one flat all-reduce."""
        if self.group is None:
            return grads
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        self.dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
