"""Data-parallel check of ``train_torch.py`` over several processes.

    torchrun --nproc_per_node 4 tools/train_ddp_check.py \\
        --yaml_file configs/svd_train_depth.yaml --fake_weights --max_train_steps 2

Every process runs ``train_torch.main(argv + ["--multihost"])`` (one card
each, NCCL); after each training step the processes gather a SHA-256 digest of
their fp32 masters, the step's ms (host clock, card synchronised) and their
peak GiB so far. Rank 0 prints one line per step and, last, one JSON object:
whether every process held the same masters after every step, the logged
losses (averaged over the processes) and, per step, each process's ms and
peak GiB, beside the card's name and power limit. It exits non-zero when the
masters differ.

``--device cpu --thin`` runs the same on the CPU (gloo) with the thin towers
of ``tests/torch_cli_common.py``, as a rehearsal:

    python -m torch.distributed.run --nproc_per_node 4 tools/train_ddp_check.py \\
        --device cpu --thin --model_name svd --height 64 --width 64 \\
        --n_sample_frames 3 --mixed_precision no --fake_weights --max_train_steps 2
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import train_torch  # noqa: E402
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer  # noqa: E402


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    parser.add_argument("--thin", action="store_true")
    own, argv = parser.parse_known_args()
    if own.thin:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import torch_cli_common

        train_torch.build_modules = torch_cli_common.thin_train_modules
    steps = []
    train_step = CtrlAdapterTrainer.train_step

    def checked(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = train_step(self, *args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ms = 1000 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                if self.device.type == "cuda" else None)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (digest(self.optimizer.masters), ms, peak))
        steps.append(gathered)
        if dist.get_rank() == 0:
            same = len({d for d, _, _ in gathered}) == 1
            print(f"step {len(steps)}: masters {'equal' if same else 'DIFFER'} over "
                  f"{len(gathered)} processes; ms {[round(m, 1) for _, m, _ in gathered]}",
                  flush=True)
        return out

    CtrlAdapterTrainer.train_step = checked
    run = train_torch.main(argv + ["--multihost"], device=own.device)
    same = all(len({d for d, _, _ in g}) == 1 for g in steps)
    if run.mesh.rank == 0:
        card = "CPU"
        if run.trainer.device.type == "cuda":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip().replace("\n", "; ")
        print(json.dumps({"processes": run.mesh.world_size, "masters_equal": same,
                          "losses": [r["loss"] for r in run.records],
                          "ms": [[m for _, m, _ in g] for g in steps],
                          "peak_gib": [[p for _, _, p in g] for g in steps],
                          "cards": card}))
    return 0 if same and steps else 1


if __name__ == "__main__":
    sys.exit(main())
