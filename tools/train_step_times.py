"""ms per SVD training step of one package tree on one Hopper card, with the
device's busy time and K2 backward's share of it.

    python tools/train_step_times.py [--root DIR] [--tag NAME] [--runs N]

Builds the trainer of ``chip_smoke.py`` phase 8 (``configs/svd_train_depth.yaml``
at full width: 1 x 14 x 512 x 512, skip_conv_in, bf16 towers, fp32 adapter
masters, gradient checkpointing; seeded random weights and batch) from the
``ctrl_adapter_tpu_torch`` package under ``--root`` (default: this repository;
e.g. an unpacked ``git archive`` of another commit, whose kernels build into
its own ``build/kernels/``), takes one warm-up step, then ``--runs`` steps:

- on the host clock around ``torch.cuda.synchronize()``: ms per step;
- ``--runs`` more under ``torch.profiler`` (``chip_smoke.py:device_activity``):
  the device's busy time per step (the union of its kernels' spans), the idle
  share between the first and last kernel, and K2 backward's device time and
  launches per step (kernels whose names hold ``flash_bwd``).

Prints every run and the medians as one JSON line with the card's name and
power limit. Compare two trees only within one call, in turns. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_step_times: no CUDA device")
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(_REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"train_step_times: imported the package from {_build.CSRC_DIR}, "
                         f"not from {root}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pipe, _ = smoke.build_pipeline(dev, torch.bfloat16)
    cfg = TrainConfig(model_name="svd", n_sample_frames=smoke.FRAMES, output_fps=14,
                      control_latent_size=smoke.SIZE // 8, skip_conv_in=True,
                      gradient_checkpointing=True)
    trainer = CtrlAdapterTrainer(cfg, pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae,
                                 device=dev)
    del pipe
    batch = smoke.train_batch(dev, smoke.FRAMES, smoke.SIZE, smoke.SEED + 5)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
    step = lambda: trainer.train_step(batch, generator=gen)  # noqa: E731

    step()  # warm-up
    host_ms = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms.append(1000 * (time.perf_counter() - t0))
    device = {"busy_ms": [], "idle_share": [], "k2_bwd_ms": [], "k2_bwd_launches": []}
    for _ in range(args.runs):
        activity = smoke.device_activity(step)
        if activity is None:  # every trace partial: this run is not measured
            continue
        busy, span, per_name = activity
        bwd = [v for name, v in per_name.items() if "flash_bwd" in name]
        device["busy_ms"].append(busy / 1000)
        device["idle_share"].append(1 - busy / span)
        device["k2_bwd_ms"].append(sum(us for us, _ in bwd) / 1000)
        device["k2_bwd_launches"].append(sum(n for _, n in bwd))
    print(json.dumps({"tree": args.tag or root, "host_ms": host_ms,
                      "median_host_ms": statistics.median(host_ms), "device": device,
                      "device_median": {k: statistics.median(v) if v else None
                                        for k, v in device.items()},
                      "card": smoke.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
