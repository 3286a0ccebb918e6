"""The model FLOPs of one clip, counted once by ``FlopCounterMode`` over the
benchmark's own float32 reference on the ``meta`` device: a controlled step,
a UNet-only step (both over the CFG-doubled batch, as the published algorithm
computes them) and the decode. The count does not depend on which kernels the
program runs."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


@torch.no_grad()
def step_flops(fam, cfg: dict, window, steps: int) -> dict:
    """{"controlled", "unet_only", "decode"}: FLOPs of one of each."""
    lo, hi = window
    meta = torch.device("meta")
    towers = fam.reference_towers(cfg, meta)
    inputs = fam.inputs(cfg, meta)
    smp = fam.sampler(towers, inputs, cfg)
    x = smp.start(inputs["latents"])
    out = {}
    for kind, i in (("controlled", lo), ("unet_only", hi if hi < steps else 0)):
        with FlopCounterMode(display=False) as counter:
            smp.step(x, i)
        out[kind] = counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        smp.decode(inputs["latents"])
    out["decode"] = counter.get_total_flops()
    return out


def clip_flops(fam, cfg: dict, window, steps: int) -> float:
    per = step_flops(fam, cfg, window, steps)
    n_ctrl = window[1] - window[0]
    return n_ctrl * per["controlled"] + (steps - n_ctrl) * per["unet_only"] + per["decode"]


def train_step_flops(fam, cfg: dict) -> float:
    """FLOPs of one training step: the reference's loss and its backward to the
    adapter's parameters, with no recompute."""
    from reference.ops import RECOMPUTE

    meta = torch.device("meta")
    towers = fam.reference_towers(cfg, meta)
    trainer = fam.reference_trainer(towers, cfg)
    batch, draws = fam.train_inputs(cfg, meta)
    token = RECOMPUTE.set(False)
    try:
        with FlopCounterMode(display=False) as counter:
            from reference.svd_train import loss

            loss(towers, batch, draws, cfg["train"]["config"]).backward()
    finally:
        RECOMPUTE.reset(token)
    del trainer
    return counter.get_total_flops()
