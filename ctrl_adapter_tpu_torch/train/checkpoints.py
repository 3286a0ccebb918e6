"""Checkpoints in the reference's directory layout.

Counterpart of ``ctrl_adapter_tpu/train/checkpoints.py``: per step a
``checkpoint-{step}/`` directory holding ``adapter_{step}/`` (the adapter's
weights), ``router_{step}/`` (the router's, when one trains), ``optimizer/``
(the optimizer's state, over both modules' masters) and ``config.json``. The
weights are state dicts keyed by the diffusers parameter names
(``adapter_{step}/diffusion_pytorch_model.bin``; the router's
``down_blocks_router.{i}.wg.weight`` and ``mid_block_router.wg.weight``),
written with ``torch.save``; the optimizer's state is
``optimizer/optimizer.bin``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

WEIGHTS_NAME = "diffusion_pytorch_model.bin"
OPTIMIZER_NAME = "optimizer.bin"


def save_checkpoint(output_dir: str, step: int, adapter_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[dict] = None,
                    config: Optional[dict] = None,
                    router_state: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write one checkpoint; returns its ``checkpoint-{step}`` directory."""
    ckpt_dir = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    for name, state in (("adapter", adapter_state), ("router", router_state)):
        if state is None:
            continue
        weights_dir = os.path.join(ckpt_dir, f"{name}_{step}")
        os.makedirs(weights_dir, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   os.path.join(weights_dir, WEIGHTS_NAME))
    if optimizer_state is not None:
        os.makedirs(os.path.join(ckpt_dir, "optimizer"), exist_ok=True)
        torch.save(optimizer_state, os.path.join(ckpt_dir, "optimizer", OPTIMIZER_NAME))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as fh:
            json.dump(config, fh, indent=2)
    return ckpt_dir


def load_checkpoint(ckpt_dir: str, step: int, map_location=None) -> dict:
    """{"adapter": state dict, "router": state dict or absent, "optimizer":
    state or absent, "config": dict or absent} of the checkpoint
    ``save_checkpoint`` wrote into ``ckpt_dir``."""
    out = {"adapter": torch.load(os.path.join(ckpt_dir, f"adapter_{step}", WEIGHTS_NAME),
                                 map_location=map_location, weights_only=True)}
    router_path = os.path.join(ckpt_dir, f"router_{step}", WEIGHTS_NAME)
    if os.path.exists(router_path):
        out["router"] = torch.load(router_path, map_location=map_location, weights_only=True)
    opt_path = os.path.join(ckpt_dir, "optimizer", OPTIMIZER_NAME)
    if os.path.exists(opt_path):
        out["optimizer"] = torch.load(opt_path, map_location=map_location, weights_only=True)
    cfg_path = os.path.join(ckpt_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            out["config"] = json.load(fh)
    return out
