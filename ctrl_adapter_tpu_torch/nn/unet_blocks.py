"""2D UNet blocks (NCHW) used by the SD-v1.5 ControlNet: Transformer2DModel and
the down / mid blocks (Transformer2DModel also in the I2VGen-XL 3D blocks). Counterpart of ``ctrl_adapter_tpu/nn/unet_blocks.py``;
the up blocks come with the SDXL slice."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .attention import BasicTransformerBlock
from .resnet import Downsample2D, GroupNorm, ResnetBlock2D


class Transformer2DModel(nn.Module):
    """GroupNorm -> 1x1 conv proj_in -> N x BasicTransformerBlock -> 1x1 conv
    proj_out (+residual)."""

    def __init__(self, num_attention_heads: int, attention_head_dim: int, in_channels: int,
                 num_layers: int = 1, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_attention_heads * attention_head_dim
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6, **kw)
        self.proj_in = nn.Conv2d(in_channels, inner, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_attention_heads, attention_head_dim,
                                  cross_attention_dim, **kw) for _ in range(num_layers)])
        self.proj_out = nn.Conv2d(inner, in_channels, 1, **kw)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, _, h, w = hidden_states.shape
        x = self.proj_in(self.norm(hidden_states))
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(n, h * w, inner)
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states)
        x = x.reshape(n, h, w, inner).permute(0, 3, 1, 2).contiguous()
        return self.proj_out(x) + hidden_states


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, resnet_eps: float = 1e-5, resnet_groups: int = 32,
                 add_downsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups=resnet_groups, eps=resnet_eps, **kw)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet in self.resnets:
            hidden_states = resnet(hidden_states, temb)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, transformer_layers_per_block: int = 1,
                 num_attention_heads: int = 8, cross_attention_dim: int = 768,
                 resnet_eps: float = 1e-5, resnet_groups: int = 32, add_downsample: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups=resnet_groups, eps=resnet_eps, **kw)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(num_attention_heads, out_channels // num_attention_heads,
                               out_channels, transformer_layers_per_block, cross_attention_dim,
                               **kw)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = attn(resnet(hidden_states, temb), encoder_hidden_states)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, num_layers: int = 1,
                 transformer_layers_per_block: int = 1, num_attention_heads: int = 8,
                 cross_attention_dim: int = 768, resnet_eps: float = 1e-5,
                 resnet_groups: int = 32, output_scale_factor: float = 1.0, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        resnet = lambda: ResnetBlock2D(  # noqa: E731
            in_channels, in_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
            output_scale_factor=output_scale_factor, **kw)
        self.resnets = nn.ModuleList([resnet() for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(num_attention_heads, in_channels // num_attention_heads,
                               in_channels, transformer_layers_per_block, cross_attention_dim,
                               **kw)
            for _ in range(num_layers)])

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            hidden_states = resnet(attn(hidden_states, encoder_hidden_states), temb)
        return hidden_states
