"""The SVD family: the program's ``SVDControlNetAdapterPipeline`` at a
configuration's widths, the reference's towers and sampler beside it
(``reference/svd_pipeline.py``), and the shared clip inputs
(``harness/towers.py``). Both sides' towers are filled from the run's seed, so
they hold the same values."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from harness.towers import (decode, fill, frames_per_clip, generate_kwargs, inputs,
                            make_towers, train_inputs)

__all__ = ["TOWERS", "build", "reference_towers", "sampler", "inputs", "generate_kwargs",
           "decode", "frames_per_clip", "build_trainer", "reference_trainer", "train_inputs"]
TOWERS = ("unet", "controlnet", "adapter", "vae")


def build(cfg: dict, device, seed: int):
    """(the program's pipeline, its parameter count)."""
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_svd import (SVDUNetConfig,
                                                        UNetSpatioTemporalConditionModel)
    from ctrl_adapter_tpu_torch.models.vae import VAEConfig
    from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

    towers = make_towers(cfg, UNetSpatioTemporalConditionModel, SVDUNetConfig, ControlNetModel,
                     ControlNetConfig, ControlNetAdapter, AutoencoderKLTemporalDecoder,
                     VAEConfig, device=device, dtype=getattr(torch, cfg["dtype"]))
    n = fill(towers, cfg, seed, device)
    return SVDControlNetAdapterPipeline(**towers), n


def reference_towers(cfg: dict, device, seed=None):
    """The reference's float32 towers, filled from ``seed`` unless it is None
    (on the ``meta`` device, for counting operations)."""
    from reference.adapter import ControlNetAdapter
    from reference.controlnet import ControlNetConfig, ControlNetModel
    from reference.unet_svd import SVDUNetConfig, UNetSpatioTemporalConditionModel
    from reference.vae import VAEConfig
    from reference.vae_temporal import AutoencoderKLTemporalDecoder

    towers = make_towers(cfg, UNetSpatioTemporalConditionModel, SVDUNetConfig, ControlNetModel,
                     ControlNetConfig, ControlNetAdapter, AutoencoderKLTemporalDecoder,
                     VAEConfig, device=device, dtype=torch.float32)
    if seed is not None:
        fill(towers, cfg, seed, device)
    return SimpleNamespace(**towers)


def sampler(towers, clip_inputs: dict, cfg: dict):
    from reference.svd_pipeline import SVDSampler

    return SVDSampler(towers, clip_inputs, cfg["generate"])


def build_trainer(cfg: dict, device, seed: int):
    """(the program's ``CtrlAdapterTrainer`` at the configuration's training
    settings, on towers filled from ``seed``, its parameter count)."""
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

    pipe, n = build(cfg, device, seed)
    trainer = CtrlAdapterTrainer(TrainConfig(**cfg["train"]["config"]), pipe.unet,
                                 pipe.controlnet, pipe.adapter, pipe.vae, device=device)
    return trainer, n


def reference_trainer(towers, cfg: dict):
    from reference.svd_train import Trainer

    return Trainer(towers, cfg["train"]["config"], served=getattr(torch, cfg["dtype"]))
