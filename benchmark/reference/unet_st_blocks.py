"""Spatio-temporal UNet blocks for SVD (frames folded into the batch, NCHW).

Plain float32 reference of the program's (diffusers'
SpatioTemporalResBlock / TransformerSpatioTemporalModel and the down, mid and up
blocks). Temporal layers see (b, c, f, h, w). The diffusers eps asymmetry is
kept: plain down/up blocks use resnet eps 1e-5, cross-attention blocks 1e-6.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from . import ops
from .attention import BasicTransformerBlock, TemporalBasicTransformerBlock
from .embeddings import TimestepEmbedding, get_timestep_embedding
from .resnet import (AlphaBlender, Downsample2D, GroupNorm, ResnetBlock2D,
                     TemporalResnetBlock, Upsample2D)


def to_5d(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(b*f, c, h, w) -> (b, c, f, h, w)."""
    bf, c, h, w = x.shape
    x = x.reshape(bf // num_frames, num_frames, c, h, w)
    return x.permute(0, 2, 1, 3, 4).contiguous()


def from_5d(x: torch.Tensor) -> torch.Tensor:
    """(b, c, f, h, w) -> (b*f, c, h, w)."""
    b, c, f, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)


class SpatioTemporalResBlock(nn.Module):
    """Spatial ResnetBlock2D -> TemporalResnetBlock -> AlphaBlender."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, eps: float = 1e-6,
                 temporal_eps: Optional[float] = None, merge_factor: float = 0.5,
                 merge_strategy: str = "learned_with_images",
                 switch_spatial_to_temporal_mix: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        out_channels = out_channels or in_channels
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, temb_channels,
                                               eps=eps, **kw)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, out_channels, temb_channels,
            eps=temporal_eps if temporal_eps is not None else eps, **kw)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy,
                                       switch_spatial_to_temporal_mix, **kw)

    def forward(self, hidden_states: torch.Tensor, temb: Optional[torch.Tensor],
                image_only_indicator: torch.Tensor) -> torch.Tensor:
        num_frames = image_only_indicator.shape[-1]
        hidden_states = self.spatial_res_block(hidden_states, temb)
        hs_5d = to_5d(hidden_states, num_frames)
        temb_3d = None if temb is None else temb.reshape(-1, num_frames, temb.shape[-1])
        temporal = self.temporal_res_block(hs_5d, temb_3d)
        return from_5d(self.time_mixer(hs_5d, temporal, image_only_indicator))


class TransformerSpatioTemporalModel(nn.Module):
    """Spatial + temporal transformer pair with a frame positional embedding and
    learned time mixing."""

    def __init__(self, num_attention_heads: int, attention_head_dim: int, in_channels: int,
                 num_layers: int = 1, cross_attention_dim: Optional[int] = None, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_attention_heads * attention_head_dim
        self.in_channels = in_channels
        self.norm = GroupNorm(32, in_channels, 1e-6, **kw)
        self.proj_in = nn.Linear(in_channels, inner, **kw)
        self.time_pos_embed = TimestepEmbedding(in_channels, in_channels * 4, in_channels, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_attention_heads, attention_head_dim,
                                  cross_attention_dim, **kw) for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(inner, inner, num_attention_heads,
                                          attention_head_dim, cross_attention_dim, **kw)
            for _ in range(num_layers)])
        self.time_mixer = AlphaBlender(0.5, "learned_with_images", **kw)
        self.proj_out = nn.Linear(inner, in_channels, **kw)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                image_only_indicator: torch.Tensor) -> torch.Tensor:
        bf, c, h, w = hidden_states.shape
        num_frames = image_only_indicator.shape[-1]
        b = bf // num_frames
        residual = hidden_states
        # time context: first-frame embedding broadcast over pixels, spatial-major
        # rows as in diffusers
        time_context = ops.time_context(encoder_hidden_states, b, num_frames, h * w)

        x = self.norm(hidden_states).permute(0, 2, 3, 1).reshape(bf, h * w, c)
        x = self.proj_in(x)
        frame_idx = torch.arange(num_frames, dtype=torch.float32,
                                 device=x.device).repeat(b)
        emb = get_timestep_embedding(frame_idx, self.in_channels, True, 0.0)
        emb = self.time_pos_embed(emb.to(x.dtype))[:, None, :]
        for block, temporal in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            x = block(x, encoder_hidden_states)
            x_mix = temporal(x + emb, num_frames, time_context)
            x = self.time_mixer(x, x_mix, image_only_indicator)
        x = self.proj_out(x)
        return x.reshape(bf, h, w, c).permute(0, 3, 1, 2) + residual


class DownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, add_downsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(in_channels if i == 0 else out_channels, out_channels,
                                   temb_channels, eps=1e-5, **kw) for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states, temb, image_only_indicator):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet in self.resnets:
            hidden_states = resnet(hidden_states, temb, image_only_indicator)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class CrossAttnDownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, transformer_layers_per_block: int = 1,
                 num_attention_heads: int = 5, cross_attention_dim: int = 1024,
                 add_downsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(in_channels if i == 0 else out_channels, out_channels,
                                   temb_channels, eps=1e-6, **kw) for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(num_attention_heads,
                                           out_channels // num_attention_heads, out_channels,
                                           transformer_layers_per_block, cross_attention_dim,
                                           **kw) for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states, temb, encoder_hidden_states, image_only_indicator):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = resnet(hidden_states, temb, image_only_indicator)
            hidden_states = attn(hidden_states, encoder_hidden_states, image_only_indicator)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, num_layers: int = 1,
                 transformer_layers_per_block: int = 1, num_attention_heads: int = 20,
                 cross_attention_dim: int = 1024, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(in_channels, in_channels, temb_channels, eps=1e-5, **kw)
            for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(num_attention_heads,
                                           in_channels // num_attention_heads, in_channels,
                                           transformer_layers_per_block, cross_attention_dim,
                                           **kw) for _ in range(num_layers)])

    def forward(self, hidden_states, temb, encoder_hidden_states, image_only_indicator):
        hidden_states = self.resnets[0](hidden_states, temb, image_only_indicator)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            hidden_states = attn(hidden_states, encoder_hidden_states, image_only_indicator)
            hidden_states = resnet(hidden_states, temb, image_only_indicator)
        return hidden_states


class UpBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, add_upsample: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList()
        for i in range(num_layers):
            skip = in_channels if i == num_layers - 1 else out_channels
            cin = prev_output_channel if i == 0 else out_channels
            self.resnets.append(SpatioTemporalResBlock(cin + skip, out_channels, temb_channels,
                                                       eps=1e-5, **kw))
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, hidden_states, res_hidden_states_tuple: Sequence[torch.Tensor], temb,
                image_only_indicator):
        res = list(res_hidden_states_tuple)
        for resnet in self.resnets:
            hidden_states = torch.cat([hidden_states, res.pop()], dim=1)
            hidden_states = resnet(hidden_states, temb, image_only_indicator)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class CrossAttnUpBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, transformer_layers_per_block: int = 1,
                 num_attention_heads: int = 5, cross_attention_dim: int = 1024,
                 add_upsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList()
        for i in range(num_layers):
            skip = in_channels if i == num_layers - 1 else out_channels
            cin = prev_output_channel if i == 0 else out_channels
            self.resnets.append(SpatioTemporalResBlock(cin + skip, out_channels, temb_channels,
                                                       eps=1e-6, **kw))
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(num_attention_heads,
                                           out_channels // num_attention_heads, out_channels,
                                           transformer_layers_per_block, cross_attention_dim,
                                           **kw) for _ in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, hidden_states, res_hidden_states_tuple: Sequence[torch.Tensor], temb,
                encoder_hidden_states, image_only_indicator):
        res = list(res_hidden_states_tuple)
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = torch.cat([hidden_states, res.pop()], dim=1)
            hidden_states = resnet(hidden_states, temb, image_only_indicator)
            hidden_states = attn(hidden_states, encoder_hidden_states, image_only_indicator)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states
