"""SD VAE (NCHW): config, single-head mid-block attention, encoder, decoder
and ``AutoencoderKL``.

Counterpart of ``ctrl_adapter_tpu/models/vae.py``. The SVD temporal-decoder
VAE reuses the encoder; the I2VGen-XL pipeline decodes with
:class:`AutoencoderKL`. The mid-block attention is one head over all h*w
positions, plain (not flash-eligible: one head of 512).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..nn.resnet import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D
from ..ops.flash_attention import _torch_attention


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # 0.13025 for SDXL


class VAEAttention(nn.Module):
    """Single-head attention with residual (diffusers Attention in the VAE mid)."""

    def __init__(self, channels: int, norm_num_groups: int = 32, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.group_norm = GroupNorm(norm_num_groups, channels, 1e-6, **kw)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, 1, h * w, c)
        out = _torch_attention(self.to_q(hidden), self.to_k(hidden), self.to_v(hidden))
        out = self.to_out[0](out.reshape(n, h * w, c))
        return out.reshape(n, h, w, c).permute(0, 3, 1, 2) + x


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 2,
                 add_downsample: bool = True, norm_num_groups: int = 32, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels, None,
                          groups=norm_num_groups, eps=1e-6, **kw) for j in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, padding=0, **kw)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int = 32, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, groups=norm_num_groups, eps=1e-6, **kw)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_num_groups, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = config
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0], 3, padding=1, **kw)
        self.down_blocks = nn.ModuleList()
        out_ch = cfg.block_out_channels[0]
        for i, ch in enumerate(cfg.block_out_channels):
            in_ch, out_ch = out_ch, ch
            self.down_blocks.append(DownEncoderBlock2D(
                in_ch, out_ch, cfg.layers_per_block, i != len(cfg.block_out_channels) - 1,
                cfg.norm_num_groups, **kw))
        self.mid_block = VAEMidBlock(cfg.block_out_channels[-1], cfg.norm_num_groups, **kw)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, cfg.block_out_channels[-1], 1e-6,
                                       **kw)
        self.conv_out = nn.Conv2d(cfg.block_out_channels[-1], 2 * cfg.latent_channels, 3,
                                  padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3,
                 add_upsample: bool = True, norm_num_groups: int = 32, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels, None,
                          groups=norm_num_groups, eps=1e-6, **kw) for j in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = config
        mid = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, mid, 3, padding=1, **kw)
        self.mid_block = VAEMidBlock(mid, cfg.norm_num_groups, **kw)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i, ch in enumerate(rev):
            prev, out_ch = out_ch, ch
            self.up_blocks.append(UpDecoderBlock2D(
                prev, out_ch, cfg.layers_per_block + 1, i != len(rev) - 1, cfg.norm_num_groups,
                **kw))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, cfg.block_out_channels[0], 1e-6,
                                       **kw)
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, padding=1,
                                  **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    """Encoder + quant_conv and post_quant_conv + decoder; latents unscaled."""

    def __init__(self, config: VAEConfig = VAEConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        lat = config.latent_channels
        self.encoder = Encoder(config, **kw)
        self.decoder = Decoder(config, **kw)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1, **kw)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of the latent distribution of x (n, 3, H, W) in [-1, 1],
        logvar clipped to [-30, 20]; not yet scaled."""
        mean, logvar = self.quant_conv(self.encoder(x.to(self.dtype))).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latent mean (or a sample, given noise), not yet scaled; x in [-1, 1]."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (n, 4, h, w) unscaled latents -> (n, 3, 8h, 8w)."""
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
