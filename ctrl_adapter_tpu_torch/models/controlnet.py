"""Frozen SD-v1.5 ControlNet feature tower (NCHW).

Counterpart of ``ctrl_adapter_tpu/models/controlnet.py``: conv_in -> time
embedding -> conditioning-embedding CNN -> 4 down blocks -> mid block -> 12+1
zero-conv heads, with the reference's ``skip_conv_in`` (latents skipping) and
the guess-mode residual ramp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.embeddings import TimestepEmbedding, Timesteps, timestep_tensor
from ..nn.unet_blocks import CrossAttnDownBlock2D, DownBlock2D, UNetMidBlock2DCrossAttn
from ..utils import profiling


@dataclass(frozen=True)
class ControlNetConfig:
    """SD-v1.5 ControlNet hyperparameters (defaults = lllyasviel/control_v11*)."""

    in_channels: int = 4
    conditioning_channels: int = 3
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    mid_block_scale_factor: float = 1.0


class ControlNetConditioningEmbedding(nn.Module):
    """4-stage CNN from the condition image down to latent resolution."""

    def __init__(self, conditioning_embedding_channels: int,
                 conditioning_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256), device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_in = nn.Conv2d(conditioning_channels, block_out_channels[0], 3, padding=1,
                                 **kw)
        blocks = []
        for i in range(len(block_out_channels) - 1):
            cin, cout = block_out_channels[i], block_out_channels[i + 1]
            blocks.append(nn.Conv2d(cin, cin, 3, padding=1, **kw))
            blocks.append(nn.Conv2d(cin, cout, 3, padding=1, stride=2, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(block_out_channels[-1], conditioning_embedding_channels, 3,
                                  padding=1, **kw)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(conditioning))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(nn.Module):
    def __init__(self, config: ControlNetConfig = ControlNetConfig(), device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        self.time_proj = Timesteps(ch0, cfg.flip_sin_to_cos, cfg.freq_shift)
        self.time_embedding = TimestepEmbedding(ch0, temb, **kw)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **kw)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            ch0, cfg.conditioning_channels, cfg.conditioning_embedding_out_channels, **kw)

        res_channels = [ch0]
        self.down_blocks = nn.ModuleList()
        out_ch = ch0
        for i, block_type in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, cfg.block_out_channels[i]
            is_final = i == len(cfg.block_out_channels) - 1
            common = dict(num_layers=cfg.layers_per_block, resnet_eps=cfg.norm_eps,
                          resnet_groups=cfg.norm_num_groups, add_downsample=not is_final, **kw)
            if block_type == "CrossAttnDownBlock2D":
                block = CrossAttnDownBlock2D(
                    in_ch, out_ch, temb,
                    transformer_layers_per_block=cfg.transformer_layers_per_block[i],
                    num_attention_heads=cfg.num_attention_heads[i],
                    cross_attention_dim=cfg.cross_attention_dim, **common)
            else:
                block = DownBlock2D(in_ch, out_ch, temb, **common)
            self.down_blocks.append(block)
            res_channels += [out_ch] * (cfg.layers_per_block + (0 if is_final else 1))
        self.mid_block = UNetMidBlock2DCrossAttn(
            cfg.block_out_channels[-1], temb,
            transformer_layers_per_block=cfg.transformer_layers_per_block[-1],
            num_attention_heads=cfg.num_attention_heads[-1],
            cross_attention_dim=cfg.cross_attention_dim, resnet_eps=cfg.norm_eps,
            resnet_groups=cfg.norm_num_groups, output_scale_factor=cfg.mid_block_scale_factor,
            **kw)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1, **kw) for c in res_channels])
        mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                controlnet_cond: torch.Tensor, conditioning_scale: float = 1.0,
                skip_conv_in: bool = False, guess_mode: bool = False,
                skip_time_emb: bool = False) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """sample (n, 4, h, w); controlnet_cond (n, 3, 8h, 8w); encoder_hidden_states
        (n, 77, 768). Returns the 12 down residuals and the mid residual.
        ``skip_time_emb`` zeroes the time embedding (an experimental flag of the
        reference)."""
        with profiling.span("tower.controlnet"):
            dtype = self.dtype
            n = sample.shape[0]
            timesteps = timestep_tensor(timestep, sample.device).reshape(-1).expand(n)
            emb = self.time_embedding(self.time_proj(timesteps).to(dtype))
            if skip_time_emb:
                emb = torch.zeros_like(emb)
            if skip_conv_in:
                # latents skipping: the conv_in path is zeroed, only the condition counts
                ch0 = self.conv_in.out_channels
                sample = torch.zeros((n, ch0, *sample.shape[-2:]), dtype=dtype,
                                     device=sample.device)
            else:
                sample = self.conv_in(sample.to(dtype))
            sample = sample + self.controlnet_cond_embedding(controlnet_cond.to(dtype))
            ehs = encoder_hidden_states.to(dtype)

            down_res: Tuple[torch.Tensor, ...] = (sample,)
            for i, block in enumerate(self.down_blocks):
                with profiling.span(profiling.BLOCK_DOWN[i]):
                    if isinstance(block, CrossAttnDownBlock2D):
                        sample, res = block(sample, emb, ehs)
                    else:
                        sample, res = block(sample, emb)
                down_res += res
            with profiling.span("block.mid"):
                sample = self.mid_block(sample, emb, ehs)

            n_res = len(down_res)
            if guess_mode:
                scales = [float(s) for s in 10.0 ** np.linspace(-1.0, 0.0, n_res + 1)]
            else:
                scales = [1.0] * (n_res + 1)
            downs = [conv(r) * conditioning_scale * scales[k]
                     for k, (conv, r) in enumerate(zip(self.controlnet_down_blocks, down_res))]
            mid = self.controlnet_mid_block(sample) * conditioning_scale * scales[-1]
            return downs, mid
