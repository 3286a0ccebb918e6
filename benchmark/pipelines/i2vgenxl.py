"""The I2VGen-XL family: the program's ``I2VGenXLControlNetAdapterPipeline``
with one ControlNet and no router at a configuration's widths, the
reference's towers and sampler beside it (``reference/i2vgenxl_pipeline.py``),
and the shared clip inputs (``harness/towers.py``)."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from harness.towers import decode, fill, frames_per_clip, generate_kwargs, inputs, make_towers

__all__ = ["TOWERS", "build", "reference_towers", "sampler", "inputs", "generate_kwargs",
           "decode", "frames_per_clip"]
TOWERS = ("unet", "controlnet", "adapter", "vae")


def build(cfg: dict, device, seed: int):
    """(the program's pipeline, its parameter count)."""
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline

    towers = make_towers(cfg, I2VGenXLUNet, I2VGenXLUNetConfig, ControlNetModel, ControlNetConfig,
                     ControlNetAdapter, AutoencoderKL, VAEConfig, device=device,
                     dtype=getattr(torch, cfg["dtype"]))
    n = fill(towers, cfg, seed, device)
    return I2VGenXLControlNetAdapterPipeline(**towers), n


def reference_towers(cfg: dict, device, seed=None):
    from reference.adapter import ControlNetAdapter
    from reference.controlnet import ControlNetConfig, ControlNetModel
    from reference.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
    from reference.vae import AutoencoderKL, VAEConfig

    towers = make_towers(cfg, I2VGenXLUNet, I2VGenXLUNetConfig, ControlNetModel, ControlNetConfig,
                     ControlNetAdapter, AutoencoderKL, VAEConfig, device=device,
                     dtype=torch.float32)
    if seed is not None:
        fill(towers, cfg, seed, device)
    return SimpleNamespace(**towers)


def sampler(towers, clip_inputs: dict, cfg: dict):
    from reference.i2vgenxl_pipeline import I2VGenXLSampler

    return I2VGenXLSampler(towers, clip_inputs, cfg["generate"])
