"""3D UNet blocks of I2VGen-XL (NCHW, frames folded into the batch).

Counterpart of ``ctrl_adapter_tpu/nn/unet_3d_blocks.py`` (diffusers'
unet_3d_blocks as the reference's I2VGen-XL UNet builds them):
``TemporalConvLayer``, ``TransformerTemporalModel``, ``{CrossAttn,}DownBlock3D``,
``UNetMidBlock3DCrossAttn`` and ``{CrossAttn,}UpBlock3D``.

Hidden states are (b*f, c, h, w); the temporal layers see (b, c, f, h, w) or
per-pixel frame sequences (b*h*w, f, c). The blocks' ``num_attention_heads``
is a head *dim*, as in diffusers' 3D blocks: heads = channels //
num_attention_heads. So at head dim 64 the spatial self-attentions at 64x64
and 32x32 are flash-eligible and go to kernel K2 through ``Attention``; the
frame attentions (f <= 32 tokens) are plain. No GroupNorm here asks for K1:
each follows ``CTRL_ADAPTER_FUSED_GN`` as its JAX counterpart does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .attention import BasicTransformerBlock
from .resnet import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D
from .unet_blocks import Transformer2DModel
from .unet_st_blocks import from_5d, to_5d


class TemporalConvLayer(nn.Module):
    """Four (GroupNorm + SiLU, (3,1,1) conv) stages over the frame axis with a
    residual; the last conv starts at zero, so a fresh layer is the identity.
    Keys as torch's Sequential indices: ``conv1.0``/``conv1.2`` (norm, conv),
    ``conv{2,3,4}.0``/``.3`` (norm, conv; a dropout sits at .2)."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None, norm_num_groups: int = 32,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        out_dim = out_dim or in_dim

        def stage(cin, cout, dropout):
            conv = nn.Conv3d(cin, cout, (3, 1, 1), padding=(1, 0, 0), **kw)
            extra = [nn.Dropout(0.0)] if dropout else []
            return nn.ModuleList([GroupNorm(norm_num_groups, cin, 1e-5, **kw), nn.SiLU(),
                                  *extra, conv])

        self.conv1 = stage(in_dim, out_dim, False)
        self.conv2 = stage(out_dim, in_dim, True)
        self.conv3 = stage(in_dim, in_dim, True)
        self.conv4 = stage(in_dim, in_dim, True)
        nn.init.zeros_(self.conv4[-1].weight)
        nn.init.zeros_(self.conv4[-1].bias)

    def forward(self, hidden_states: torch.Tensor, num_frames: int) -> torch.Tensor:
        identity = to_5d(hidden_states, num_frames)
        x = identity
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = stage[-1](stage[0](x, silu=True))
        return from_5d(identity + x)


class TransformerTemporalModel(nn.Module):
    """GroupNorm (eps 1e-6, statistics over (f, h, w, group) per video) ->
    proj_in -> BasicTransformerBlocks over the frame axis of (b*h*w, f, c) ->
    proj_out, plus the input."""

    def __init__(self, num_attention_heads: int, attention_head_dim: int, in_channels: int,
                 num_layers: int = 1, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_attention_heads * attention_head_dim
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6, **kw)
        self.proj_in = nn.Linear(in_channels, inner, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_attention_heads, attention_head_dim,
                                  cross_attention_dim, **kw) for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels, **kw)

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        bf, c, h, w = hidden_states.shape
        b = bf // num_frames
        x = self.norm(to_5d(hidden_states, num_frames))  # (b, c, f, h, w)
        x = x.permute(0, 3, 4, 2, 1).reshape(b * h * w, num_frames, c)
        x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states)
        x = self.proj_out(x)
        x = x.reshape(b, h, w, num_frames, c).permute(0, 3, 4, 1, 2).reshape(bf, c, h, w)
        return x + hidden_states


def _resnets(in_channels: int, out_channels: int, temb_channels: int, num_layers: int,
             eps: float, groups: int, kw) -> nn.ModuleList:
    return nn.ModuleList([
        ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                      groups=groups, eps=eps, **kw) for i in range(num_layers)])


def _temp_convs(channels: int, num_layers: int, groups: int, kw) -> nn.ModuleList:
    return nn.ModuleList([TemporalConvLayer(channels, channels, groups, **kw)
                          for _ in range(num_layers)])


def _attentions(channels: int, head_dim: int, cross_attention_dim: int, num_layers: int,
                groups: int, kw) -> Tuple[nn.ModuleList, nn.ModuleList]:
    """The spatial and the temporal transformers of a cross-attention block."""
    heads = channels // head_dim
    return (nn.ModuleList([Transformer2DModel(heads, head_dim, channels, 1,
                                              cross_attention_dim, groups, **kw)
                           for _ in range(num_layers)]),
            nn.ModuleList([TransformerTemporalModel(heads, head_dim, channels,
                                                    norm_num_groups=groups, **kw)
                           for _ in range(num_layers)]))


def _up_resnets(in_channels: int, prev_output_channel: int, out_channels: int,
                temb_channels: int, num_layers: int, eps: float, groups: int,
                kw) -> nn.ModuleList:
    """Each resnet takes the hidden state concatenated with one skip tensor."""
    return nn.ModuleList([
        ResnetBlock2D((prev_output_channel if i == 0 else out_channels)
                      + (in_channels if i == num_layers - 1 else out_channels),
                      out_channels, temb_channels, groups=groups, eps=eps, **kw)
        for i in range(num_layers)])


class DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, resnet_eps: float = 1e-5, resnet_groups: int = 32,
                 add_downsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets(in_channels, out_channels, temb_channels, num_layers,
                                resnet_eps, resnet_groups, kw)
        self.temp_convs = _temp_convs(out_channels, num_layers, resnet_groups, kw)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor, num_frames: int):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet, temp_conv in zip(self.resnets, self.temp_convs):
            hidden_states = temp_conv(resnet(hidden_states, temb), num_frames)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class CrossAttnDownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, num_attention_heads: int = 8,
                 cross_attention_dim: int = 1024, resnet_eps: float = 1e-5,
                 resnet_groups: int = 32, add_downsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets(in_channels, out_channels, temb_channels, num_layers,
                                resnet_eps, resnet_groups, kw)
        self.temp_convs = _temp_convs(out_channels, num_layers, resnet_groups, kw)
        self.attentions, self.temp_attentions = _attentions(
            out_channels, num_attention_heads, cross_attention_dim, num_layers, resnet_groups,
            kw)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: torch.Tensor, num_frames: int):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet, temp_conv, attn, temp_attn in zip(self.resnets, self.temp_convs,
                                                      self.attentions, self.temp_attentions):
            hidden_states = temp_conv(resnet(hidden_states, temb), num_frames)
            hidden_states = attn(hidden_states, encoder_hidden_states)
            hidden_states = temp_attn(hidden_states, num_frames)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, num_layers: int = 1,
                 num_attention_heads: int = 8, cross_attention_dim: int = 1024,
                 resnet_eps: float = 1e-5, resnet_groups: int = 32, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets(in_channels, in_channels, temb_channels, num_layers + 1,
                                resnet_eps, resnet_groups, kw)
        self.temp_convs = _temp_convs(in_channels, num_layers + 1, resnet_groups, kw)
        self.attentions, self.temp_attentions = _attentions(
            in_channels, num_attention_heads, cross_attention_dim, num_layers, resnet_groups,
            kw)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: torch.Tensor, num_frames: int) -> torch.Tensor:
        hidden_states = self.temp_convs[0](self.resnets[0](hidden_states, temb), num_frames)
        for attn, temp_attn, resnet, temp_conv in zip(self.attentions, self.temp_attentions,
                                                      self.resnets[1:], self.temp_convs[1:]):
            hidden_states = temp_attn(attn(hidden_states, encoder_hidden_states), num_frames)
            hidden_states = temp_conv(resnet(hidden_states, temb), num_frames)
        return hidden_states


class UpBlock3D(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, resnet_eps: float = 1e-5,
                 resnet_groups: int = 32, add_upsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _up_resnets(in_channels, prev_output_channel, out_channels,
                                   temb_channels, num_layers, resnet_eps, resnet_groups, kw)
        self.temp_convs = _temp_convs(out_channels, num_layers, resnet_groups, kw)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor, res_hidden_states: Sequence[torch.Tensor],
                temb: torch.Tensor, num_frames: int) -> torch.Tensor:
        res = list(res_hidden_states)
        for resnet, temp_conv in zip(self.resnets, self.temp_convs):
            hidden_states = torch.cat([hidden_states, res.pop()], dim=1)
            hidden_states = temp_conv(resnet(hidden_states, temb), num_frames)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class CrossAttnUpBlock3D(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, num_attention_heads: int = 8,
                 cross_attention_dim: int = 1024, resnet_eps: float = 1e-5,
                 resnet_groups: int = 32, add_upsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _up_resnets(in_channels, prev_output_channel, out_channels,
                                   temb_channels, num_layers, resnet_eps, resnet_groups, kw)
        self.temp_convs = _temp_convs(out_channels, num_layers, resnet_groups, kw)
        self.attentions, self.temp_attentions = _attentions(
            out_channels, num_attention_heads, cross_attention_dim, num_layers, resnet_groups,
            kw)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor, res_hidden_states: Sequence[torch.Tensor],
                temb: torch.Tensor, encoder_hidden_states: torch.Tensor,
                num_frames: int) -> torch.Tensor:
        res = list(res_hidden_states)
        for resnet, temp_conv, attn, temp_attn in zip(self.resnets, self.temp_convs,
                                                      self.attentions, self.temp_attentions):
            hidden_states = torch.cat([hidden_states, res.pop()], dim=1)
            hidden_states = temp_conv(resnet(hidden_states, temb), num_frames)
            hidden_states = temp_attn(attn(hidden_states, encoder_hidden_states), num_frames)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states
