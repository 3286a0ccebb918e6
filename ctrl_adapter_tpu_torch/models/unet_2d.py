"""UNet2DConditionModel (SD-v1.5 and SDXL architectures), NCHW.

Counterpart of ``ctrl_adapter_tpu/models/unet_2d.py``:

- time embedding, with LCM's ``timestep_cond`` through the bias-free
  ``time_embedding.cond_proj`` when ``time_cond_proj_dim`` is set;
- SDXL's ``text_time`` add-embedding: the 6 time ids through ``add_time_proj``,
  concatenated after the pooled text embedding, then ``add_embedding``;
- IP-Adapter image tokens (``encoder_hid_dim_type="ip_image_proj"``) from
  ``added_cond_kwargs["image_embeds"]`` through ``encoder_hid_proj``, attended by
  every cross-attention with ``ip_scale``;
- ControlNet residuals added to the down-block skips with zip semantics (the
  adapter's 12 residuals feed SDXL's 9 skips, the last 3 ignored), each cast to
  the skip's dtype, and ``mid_block_additional_residual`` (which may be a 0-d
  zero) to the mid block's output;
- ``transformer_layers_per_block`` per level, read in reverse by the up blocks.

``sample`` is (n, 4, h, w); residuals are (n, c, h, w).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..nn.embeddings import (MultiIPAdapterImageProjection, TimestepEmbedding, Timesteps,
                             timestep_tensor)
from ..nn.resnet import GroupNorm
from ..nn.unet_blocks import (CrossAttnDownBlock2D, CrossAttnUpBlock2D, DownBlock2D,
                              UNetMidBlock2DCrossAttn, UpBlock2D)
from ..utils import profiling


@dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    use_linear_projection: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    addition_embed_type: Optional[str] = None  # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None
    time_cond_proj_dim: Optional[int] = None
    encoder_hid_dim_type: Optional[str] = None  # None | "ip_image_proj"
    # the CLIP image embedding's width (diffusers ``encoder_hid_dim``); the JAX
    # module reads it off its input
    encoder_hid_dim: Optional[int] = None
    ip_num_image_text_embeds: int = 4
    ip_scale: float = 1.0


SD15_CONFIG = UNet2DConfig()

SDXL_CONFIG = UNet2DConfig(
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(320, 640, 1280),
    transformer_layers_per_block=(1, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNet2DConfig = SD15_CONFIG, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        n_blocks = len(cfg.block_out_channels)
        self.time_proj = Timesteps(ch0, cfg.flip_sin_to_cos, cfg.freq_shift)
        self.time_embedding = TimestepEmbedding(ch0, temb, cond_proj_dim=cfg.time_cond_proj_dim,
                                                **kw)
        self.add_time_proj = self.add_embedding = None
        if cfg.addition_embed_type == "text_time":
            self.add_time_proj = Timesteps(cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                           cfg.freq_shift)
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   temb, **kw)
        ip = cfg.encoder_hid_dim_type == "ip_image_proj"
        self.encoder_hid_proj = None
        if ip:
            if cfg.encoder_hid_dim is None:
                raise ValueError("encoder_hid_dim_type='ip_image_proj' needs encoder_hid_dim")
            self.encoder_hid_proj = MultiIPAdapterImageProjection(
                cfg.encoder_hid_dim, cfg.cross_attention_dim, cfg.ip_num_image_text_embeds, **kw)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **kw)

        common = dict(resnet_eps=cfg.norm_eps, resnet_groups=cfg.norm_num_groups, **kw)
        attn = dict(cross_attention_dim=cfg.cross_attention_dim,
                    use_linear_projection=cfg.use_linear_projection, ip_adapter=ip)
        self.down_blocks = nn.ModuleList()
        out_ch = ch0
        for i, kind in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, cfg.block_out_channels[i]
            args = (in_ch, out_ch, temb, cfg.layers_per_block)
            add_down = i != n_blocks - 1
            if kind == "CrossAttnDownBlock2D":
                self.down_blocks.append(CrossAttnDownBlock2D(
                    *args, cfg.transformer_layers_per_block[i], cfg.num_attention_heads[i],
                    add_downsample=add_down, **attn, **common))
            else:
                self.down_blocks.append(DownBlock2D(*args, add_downsample=add_down, **common))
        self.mid_block = UNetMidBlock2DCrossAttn(
            cfg.block_out_channels[-1], temb,
            transformer_layers_per_block=cfg.transformer_layers_per_block[-1],
            num_attention_heads=cfg.num_attention_heads[-1], **attn, **common)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            prev, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, n_blocks - 1)]
            args = (in_ch, prev, out_ch, temb, cfg.layers_per_block + 1)
            add_up = i != n_blocks - 1
            rev_idx = n_blocks - 1 - i
            if kind == "CrossAttnUpBlock2D":
                self.up_blocks.append(CrossAttnUpBlock2D(
                    *args, cfg.transformer_layers_per_block[rev_idx],
                    cfg.num_attention_heads[rev_idx], add_upsample=add_up, **attn, **common))
            else:
                self.up_blocks.append(UpBlock2D(*args, add_upsample=add_up, **common))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0, cfg.norm_eps, **kw)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                added_cond_kwargs: Optional[dict] = None,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                timestep_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (n, 4, h, w); timestep scalar or (n,); encoder_hidden_states
        (n, seq, cross); added_cond_kwargs {"text_embeds" (n, d), "time_ids" (n, 6)}
        for SDXL, and "image_embeds" (n, d) with IP-Adapter; timestep_cond
        (n, time_cond_proj_dim) for LCM."""
        with profiling.span("tower.unet"):
            cfg = self.config
            dtype = self.dtype
            n = sample.shape[0]
            timesteps = timestep_tensor(timestep, sample.device).reshape(-1).expand(n)
            emb = self.time_embedding(self.time_proj(timesteps).to(dtype), timestep_cond)
            if self.add_embedding is not None:
                if added_cond_kwargs is None:
                    raise ValueError("the text_time add-embedding needs text_embeds and time_ids")
                text_embeds = added_cond_kwargs["text_embeds"]
                time_ids = added_cond_kwargs["time_ids"]
                time_embeds = self.add_time_proj(time_ids.reshape(-1)).reshape(text_embeds.shape[0],
                                                                               -1)
                add_embeds = torch.cat([text_embeds, time_embeds.to(text_embeds.dtype)], dim=-1)
                emb = emb + self.add_embedding(add_embeds.to(dtype))
            ip_hidden_states = None
            if self.encoder_hid_proj is not None:
                if added_cond_kwargs is None or "image_embeds" not in added_cond_kwargs:
                    raise ValueError("ip_image_proj needs added_cond_kwargs['image_embeds']")
                ip_hidden_states = self.encoder_hid_proj(
                    added_cond_kwargs["image_embeds"].to(dtype))
            ehs = encoder_hidden_states.to(dtype)
            ip_scale = cfg.ip_scale

            sample = self.conv_in(sample.to(dtype))
            down_res: Tuple[torch.Tensor, ...] = (sample,)
            for i, block in enumerate(self.down_blocks):
                with profiling.span(profiling.BLOCK_DOWN[i]):
                    if isinstance(block, CrossAttnDownBlock2D):
                        sample, res = block(sample, emb, ehs, ip_hidden_states, ip_scale)
                    else:
                        sample, res = block(sample, emb)
                down_res += res
            if down_block_additional_residuals is not None:
                down_res = tuple(skip + r.to(skip.dtype)
                                 for skip, r in zip(down_res, down_block_additional_residuals))

            with profiling.span("block.mid"):
                sample = self.mid_block(sample, emb, ehs, ip_hidden_states, ip_scale)
            if mid_block_additional_residual is not None:
                sample = sample + mid_block_additional_residual.to(sample.dtype)

            for i, block in enumerate(self.up_blocks):
                k = len(block.resnets)
                res, down_res = down_res[-k:], down_res[:-k]
                with profiling.span(profiling.BLOCK_UP[i]):
                    if isinstance(block, CrossAttnUpBlock2D):
                        sample = block(sample, res, emb, ehs, ip_hidden_states, ip_scale)
                    else:
                        sample = block(sample, res, emb)
            return self.conv_out(self.conv_norm_out(sample, silu=True))
