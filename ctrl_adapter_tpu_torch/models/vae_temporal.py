"""AutoencoderKL with temporal decoder (the SVD VAE), NCHW.

Counterpart of ``ctrl_adapter_tpu/models/vae_temporal.py``: 2D encoder +
quant_conv; decoder with spatio-temporal res blocks (merge_strategy "learned",
switched mix, no time embedding) and a final (3,1,1) time conv. There is no
post_quant_conv in this VAE.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..nn.resnet import GroupNorm, Upsample2D
from ..nn.unet_st_blocks import SpatioTemporalResBlock, from_5d, to_5d
from ..utils import profiling
from .vae import Encoder, VAEAttention, VAEConfig


def _st_resblock(cin: int, cout: int, kw) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, temporal_eps=1e-5,
                                  merge_factor=0.0, merge_strategy="learned",
                                  switch_spatial_to_temporal_mix=True, **kw)


class MidBlockTemporalDecoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 2, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([_st_resblock(in_channels if i == 0 else out_channels,
                                                   out_channels, kw)
                                      for i in range(num_layers)])
        # one attention, applied before each resnet after the first
        self.attentions = nn.ModuleList(
            [VAEAttention(out_channels, **kw)] if num_layers > 1 else [])

    def forward(self, x: torch.Tensor, image_only_indicator: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x, None, image_only_indicator)
        for resnet in self.resnets[1:]:
            x = resnet(self.attentions[0](x), None, image_only_indicator)
        return x


class UpBlockTemporalDecoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3,
                 add_upsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([_st_resblock(in_channels if i == 0 else out_channels,
                                                   out_channels, kw)
                                      for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor, image_only_indicator: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x, None, image_only_indicator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class TemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = config
        mid = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, mid, 3, padding=1, **kw)
        self.mid_block = MidBlockTemporalDecoder(mid, mid, cfg.layers_per_block, **kw)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i, ch in enumerate(rev):
            prev, out_ch = out_ch, ch
            self.up_blocks.append(UpBlockTemporalDecoder(
                prev, out_ch, cfg.layers_per_block + 1, i != len(rev) - 1, **kw))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, cfg.block_out_channels[0], 1e-6,
                                       **kw)
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, padding=1,
                                  **kw)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                       padding=(1, 0, 0), **kw)

    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        b = z.shape[0] // num_frames
        indicator = torch.zeros((b, num_frames), dtype=torch.float32, device=z.device)
        x = self.mid_block(self.conv_in(z), indicator)
        for block in self.up_blocks:
            x = block(x, indicator)
        x = self.conv_out(self.conv_norm_out(x, silu=True))
        return from_5d(self.time_conv_out(to_5d(x, num_frames)))


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig(), device=None, dtype=None):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, device=device, dtype=dtype)
        self.decoder = TemporalDecoder(config, device=device, dtype=dtype)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1,
                                    device=device, dtype=dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of the latent distribution of x (n, 3, H, W) in [-1, 1],
        logvar clipped to [-30, 20]; not yet scaled."""
        with profiling.span("tower.vae_encode"):
            mean, logvar = self.quant_conv(self.encoder(x.to(self.dtype))).chunk(2, dim=1)
            return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latent mean (or a sample, given noise), not yet scaled; x in [-1, 1]."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor, num_frames: int = 1) -> torch.Tensor:
        """z (b*f, 4, h, w) unscaled latents -> (b*f, 3, 8h, 8w)."""
        with profiling.span("tower.vae_decode"):
            return self.decoder(z.to(self.dtype), num_frames)
