"""SVD UNet (UNetSpatioTemporalConditionModel), diffusers layout.

Counterpart of ``ctrl_adapter_tpu/models/unet_svd.py``: 8-channel conv_in
(noisy latents concatenated with the image latents), time embedding plus the
added-time-ids embedding, spatio-temporal down/mid/up blocks and ControlNet
residual injection at the skips and the mid block.

Input ``sample`` (b, f, in_channels, h, w); output (b, f, out_channels, h, w).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..nn.embeddings import TimestepEmbedding, Timesteps, timestep_tensor
from ..nn.resnet import GroupNorm
from ..nn.unet_st_blocks import (CrossAttnDownBlockSpatioTemporal,
                                 CrossAttnUpBlockSpatioTemporal, DownBlockSpatioTemporal,
                                 UNetMidBlockSpatioTemporal, UpBlockSpatioTemporal)
from ..utils import profiling


@dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal", "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal")
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768  # 3 time ids x 256


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, config: SVDUNetConfig = SVDUNetConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        n_blocks = len(cfg.block_out_channels)
        self.time_proj = Timesteps(ch0, True, 0.0)
        self.time_embedding = TimestepEmbedding(ch0, temb, **kw)
        self.add_time_proj = Timesteps(cfg.addition_time_embed_dim, True, 0.0)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb,
                                               **kw)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **kw)

        self.down_blocks = nn.ModuleList()
        out_ch = ch0
        for i, block_type in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, cfg.block_out_channels[i]
            add_down = i != n_blocks - 1
            if block_type == "CrossAttnDownBlockSpatioTemporal":
                block = CrossAttnDownBlockSpatioTemporal(
                    in_ch, out_ch, temb, cfg.layers_per_block,
                    cfg.transformer_layers_per_block[i], cfg.num_attention_heads[i],
                    cfg.cross_attention_dim, add_down, **kw)
            else:
                block = DownBlockSpatioTemporal(in_ch, out_ch, temb, cfg.layers_per_block,
                                                add_down, **kw)
            self.down_blocks.append(block)

        self.mid_block = UNetMidBlockSpatioTemporal(
            cfg.block_out_channels[-1], temb,
            transformer_layers_per_block=cfg.transformer_layers_per_block[-1],
            num_attention_heads=cfg.num_attention_heads[-1],
            cross_attention_dim=cfg.cross_attention_dim, **kw)

        rev_out = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.num_attention_heads))
        rev_tlpb = list(reversed(cfg.transformer_layers_per_block))
        self.up_blocks = nn.ModuleList()
        out_ch = rev_out[0]
        for i, block_type in enumerate(cfg.up_block_types):
            prev, out_ch = out_ch, rev_out[i]
            in_ch = rev_out[min(i + 1, n_blocks - 1)]
            add_up = i != n_blocks - 1
            layers = cfg.layers_per_block + 1
            if block_type == "CrossAttnUpBlockSpatioTemporal":
                block = CrossAttnUpBlockSpatioTemporal(
                    in_ch, prev, out_ch, temb, layers, rev_tlpb[i], rev_heads[i],
                    cfg.cross_attention_dim, add_up, **kw)
            else:
                block = UpBlockSpatioTemporal(in_ch, prev, out_ch, temb, layers, add_up, **kw)
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm(32, ch0, 1e-5, **kw)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                added_time_ids: torch.Tensor,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (b, f, c, h, w); timestep scalar or (b,) (EDM t = 0.25 log sigma);
        encoder_hidden_states (b, 1, 1024); added_time_ids (b, 3); residuals
        (b*f, c, h, w)."""
        with profiling.span("tower.unet"):
            dtype = self.dtype
            b, num_frames, c, height, width = sample.shape
            device = sample.device
            timesteps = timestep_tensor(timestep, device).reshape(-1).expand(b)
            emb = self.time_embedding(self.time_proj(timesteps).to(dtype))
            time_embeds = self.add_time_proj(added_time_ids.reshape(-1)).reshape(b, -1)
            emb = emb + self.add_embedding(time_embeds.to(emb.dtype))

            sample = sample.reshape(b * num_frames, c, height, width).to(dtype)
            emb = emb.repeat_interleave(num_frames, dim=0)
            ehs = encoder_hidden_states.repeat_interleave(num_frames, dim=0).to(dtype)
            indicator = torch.zeros((b, num_frames), dtype=torch.float32, device=device)

            sample = self.conv_in(sample)
            down_res: Tuple[torch.Tensor, ...] = (sample,)
            for i, block in enumerate(self.down_blocks):
                with profiling.span(profiling.BLOCK_DOWN[i]):
                    if isinstance(block, CrossAttnDownBlockSpatioTemporal):
                        sample, res = block(sample, emb, ehs, indicator)
                    else:
                        sample, res = block(sample, emb, indicator)
                down_res += res
            if down_block_additional_residuals is not None:
                down_res = tuple(skip + r.to(skip.dtype)
                                 for skip, r in zip(down_res, down_block_additional_residuals))

            with profiling.span("block.mid"):
                sample = self.mid_block(sample, emb, ehs, indicator)
            if mid_block_additional_residual is not None:
                sample = sample + mid_block_additional_residual.to(sample.dtype)

            for i, block in enumerate(self.up_blocks):
                n = len(block.resnets)
                res, down_res = down_res[-n:], down_res[:-n]
                with profiling.span(profiling.BLOCK_UP[i]):
                    if isinstance(block, CrossAttnUpBlockSpatioTemporal):
                        sample = block(sample, res, emb, ehs, indicator)
                    else:
                        sample = block(sample, res, emb, indicator)

            sample = self.conv_out(self.conv_norm_out(sample, silu=True))
            return sample.reshape(b, num_frames, -1, height, width)
