"""I2VGen-XL UNet (conditional 3D UNet), diffusers layout.

Counterpart of ``ctrl_adapter_tpu/models/unet_i2vgen.py``:

- time embedding plus fps embedding (``time_proj`` serves both), repeated per
  frame;
- context = 77 text tokens, 64 image-latent tokens (conv, SiLU, adaptive
  average pool to 32x32, two stride-2 convs on the first frame's latents) and
  4 projected CLIP image tokens, repeated per frame;
- the image latents through three convs and a per-pixel temporal encoder
  (LayerNorm, self-attention and a feed-forward with exact erf gelu, whatever
  the dtype and ``CTRL_ADAPTER_EXACT_GELU``), concatenated to the sample;
- ``conv_in`` over 8 channels, ``transformer_in`` (8 heads of 64), 3D down,
  mid and up blocks, ControlNet residual injection at the skips and the mid
  block (each residual cast to the skip's dtype).

``sample`` and ``image_latents`` are (b, f, 4, h, w); the output is
(b, f, 4, h, w); residuals are (b*f, c, h, w).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.attention import Attention, LayerNorm
from ..nn.embeddings import TimestepEmbedding, Timesteps, timestep_tensor
from ..nn.resnet import GroupNorm
from ..nn.unet_3d_blocks import (CrossAttnDownBlock3D, CrossAttnUpBlock3D, DownBlock3D,
                                 TransformerTemporalModel, UNetMidBlock3DCrossAttn, UpBlock3D)
from ..ops.resize import adaptive_avg_pool2d


@dataclass(frozen=True)
class I2VGenXLUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64  # heads per block = channels // this


class _GELUProj(nn.Module):
    """diffusers ``GELU``: Linear ``proj``, then exact (erf) gelu."""

    def __init__(self, dim_in: int, dim_out: int, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="none")


class _GELUFeedForward(nn.Module):
    """Feed-forward with plain exact gelu: ``net.0.proj``, ``net.2``."""

    def __init__(self, dim: int, dim_out: int, inner_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.net = nn.ModuleList([_GELUProj(dim, inner_dim, **kw), nn.Dropout(0.0),
                                  nn.Linear(inner_dim, dim_out, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class I2VGenXLTransformerTemporalEncoder(nn.Module):
    """LayerNorm -> self-attention (+res) -> gelu FF (+res) over (b*h*w, f, c)."""

    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int,
                 ff_inner_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = Attention(dim, num_attention_heads, attention_head_dim, **kw)
        self.ff = _GELUFeedForward(dim, dim, ff_inner_dim, **kw)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        hidden_states = self.attn1(self.norm1(hidden_states)) + hidden_states
        return self.ff(hidden_states) + hidden_states


class I2VGenXLUNet(nn.Module):
    def __init__(self, config: I2VGenXLUNetConfig = I2VGenXLUNetConfig(), device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = self.config = config
        ch0, cin, cross = cfg.block_out_channels[0], cfg.in_channels, cfg.cross_attention_dim
        temb = ch0 * 4
        head_dim = cfg.attention_head_dim
        groups = cfg.norm_num_groups
        n_blocks = len(cfg.block_out_channels)
        conv = lambda i, o, stride=1: nn.Conv2d(i, o, 3, stride, 1, **kw)  # noqa: E731
        self.time_proj = Timesteps(ch0, True, 0.0)
        self.time_embedding = TimestepEmbedding(ch0, temb, **kw)
        self.fps_embedding = nn.ModuleList([nn.Linear(ch0, temb, **kw), nn.SiLU(),
                                            nn.Linear(temb, temb, **kw)])
        # indices as diffusers' Sequential (conv, SiLU, 32x32 pool, conv, SiLU, conv);
        # forward runs them with ops.resize.adaptive_avg_pool2d
        self.image_latents_context_embedding = nn.ModuleList([
            conv(cin, cin * 8), nn.SiLU(), nn.AdaptiveAvgPool2d((32, 32)),
            conv(cin * 8, cin * 16, 2), nn.SiLU(), conv(cin * 16, cross, 2)])
        self.context_embedding = nn.ModuleList([nn.Linear(cross, temb, **kw), nn.SiLU(),
                                                nn.Linear(temb, cross * cin, **kw)])
        self.image_latents_proj_in = nn.ModuleList([
            conv(cin, cin * 4), nn.SiLU(), conv(cin * 4, cin * 4), nn.SiLU(),
            conv(cin * 4, cin)])
        self.image_latents_temporal_encoder = I2VGenXLTransformerTemporalEncoder(
            cin, 2, cin, cin * 4, **kw)
        self.conv_in = conv(2 * cin, ch0)
        self.transformer_in = TransformerTemporalModel(8, head_dim, ch0,
                                                       norm_num_groups=groups, **kw)

        common = dict(resnet_groups=groups, **kw)
        attn = dict(num_attention_heads=head_dim, cross_attention_dim=cross)
        self.down_blocks = nn.ModuleList()
        out_ch = ch0
        for i in range(n_blocks):
            in_ch, out_ch = out_ch, cfg.block_out_channels[i]
            if i < n_blocks - 1:
                self.down_blocks.append(CrossAttnDownBlock3D(
                    in_ch, out_ch, temb, cfg.layers_per_block, add_downsample=True, **attn,
                    **common))
            else:
                self.down_blocks.append(DownBlock3D(in_ch, out_ch, temb, cfg.layers_per_block,
                                                    add_downsample=False, **common))
        self.mid_block = UNetMidBlock3DCrossAttn(cfg.block_out_channels[-1], temb, **attn,
                                                 **common)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(n_blocks):
            prev, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, n_blocks - 1)]
            args = (in_ch, prev, out_ch, temb, cfg.layers_per_block + 1)
            add_up = i != n_blocks - 1
            self.up_blocks.append(UpBlock3D(*args, add_upsample=add_up, **common) if i == 0
                                  else CrossAttnUpBlock3D(*args, add_upsample=add_up, **attn,
                                                          **common))
        self.conv_norm_out = GroupNorm(groups, ch0, 1e-5, **kw)
        self.conv_out = conv(ch0, cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def _context(self, encoder_hidden_states, image_latents, image_embeddings):
        """(b, 77 + 64 + in_channels, cross) context tokens."""
        b = encoder_hidden_states.shape[0]
        cfg = self.config
        emb = self.image_latents_context_embedding
        x = F.silu(emb[0](image_latents[:, 0]))
        x = adaptive_avg_pool2d(x, (32, 32))
        x = emb[5](F.silu(emb[3](x)))  # (b, cross, 8, 8)
        il_context = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.cross_attention_dim)
        ce = self.context_embedding
        ie = ce[2](F.silu(ce[0](image_embeddings)))
        ie = ie.reshape(b, cfg.in_channels, cfg.cross_attention_dim)
        return torch.cat([encoder_hidden_states, il_context, ie], dim=1)

    def _encode_image_latents(self, image_latents: torch.Tensor) -> torch.Tensor:
        """(b, f, c, h, w) -> the per-pixel temporally encoded (b, f, c, h, w)."""
        b, f, c, h, w = image_latents.shape
        proj = self.image_latents_proj_in
        il = image_latents.reshape(b * f, c, h, w)
        il = proj[4](F.silu(proj[2](F.silu(proj[0](il)))))
        il = il.reshape(b, f, c, h, w).permute(0, 3, 4, 1, 2).reshape(b * h * w, f, c)
        il = self.image_latents_temporal_encoder(il)
        return il.reshape(b, h, w, f, c).permute(0, 3, 4, 1, 2)

    def forward(self, sample: torch.Tensor, timestep, fps, image_latents: torch.Tensor,
                image_embeddings: torch.Tensor, encoder_hidden_states: torch.Tensor,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample, image_latents (b, f, 4, h, w); timestep scalar or (b,); fps
        scalar or (b,); image_embeddings (b, 1, cross) CLIP image embedding;
        encoder_hidden_states (b, 77, cross) text embedding."""
        dtype = self.dtype
        b, num_frames, c, height, width = sample.shape
        device = sample.device
        timesteps = timestep_tensor(timestep, device).reshape(-1).expand(b)
        emb = self.time_embedding(self.time_proj(timesteps).to(dtype))
        fps = timestep_tensor(fps, device).reshape(-1).expand(b)
        fe = self.fps_embedding
        emb = emb + fe[2](F.silu(fe[0](self.time_proj(fps).to(dtype))))
        emb = emb.repeat_interleave(num_frames, dim=0)

        image_latents = image_latents.to(dtype)
        context = self._context(encoder_hidden_states.to(dtype), image_latents,
                                image_embeddings.to(dtype))
        context = context.repeat_interleave(num_frames, dim=0)

        il = self._encode_image_latents(image_latents)
        sample = torch.cat([sample.to(dtype), il], dim=2)
        sample = sample.reshape(b * num_frames, 2 * c, height, width)
        sample = self.transformer_in(self.conv_in(sample), num_frames)

        down_res: Tuple[torch.Tensor, ...] = (sample,)
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock3D):
                sample, res = block(sample, emb, context, num_frames)
            else:
                sample, res = block(sample, emb, num_frames)
            down_res += res
        if down_block_additional_residuals is not None:
            down_res = tuple(skip + r.to(skip.dtype)
                             for skip, r in zip(down_res, down_block_additional_residuals))

        sample = self.mid_block(sample, emb, context, num_frames)
        if mid_block_additional_residual is not None:
            sample = sample + mid_block_additional_residual.to(sample.dtype)

        for block in self.up_blocks:
            n = len(block.resnets)
            res, down_res = down_res[-n:], down_res[:-n]
            if isinstance(block, CrossAttnUpBlock3D):
                sample = block(sample, res, emb, context, num_frames)
            else:
                sample = block(sample, res, emb, num_frames)

        sample = self.conv_out(self.conv_norm_out(sample, silu=True))
        return sample.reshape(b, num_frames, -1, height, width)
