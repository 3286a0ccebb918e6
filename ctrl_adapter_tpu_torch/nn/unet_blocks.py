"""2D UNet blocks (NCHW): Transformer2DModel and the down, mid and up blocks of
the SD-v1.5 ControlNet and the SD / SDXL UNets (Transformer2DModel also in the
I2VGen-XL 3D blocks). Counterpart of ``ctrl_adapter_tpu/nn/unet_blocks.py``.

The cross-attention blocks take ``use_linear_projection`` (SDXL: ``proj_in`` and
``proj_out`` are Linear layers on the (n, h*w, c) sequence, the GroupNorm before
the reshape; SD-v1.5: 1x1 convs) and ``ip_adapter`` (each cross-attention also
attends IP-Adapter image tokens, ``ip_hidden_states``). The up blocks
concatenate each skip after the hidden state along the channels, as the JAX
blocks do along NHWC's last axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .attention import BasicTransformerBlock
from .resnet import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in -> N x BasicTransformerBlock -> proj_out (+residual);
    the projections are 1x1 convs, or Linear layers with ``use_linear_projection``."""

    def __init__(self, num_attention_heads: int, attention_head_dim: int, in_channels: int,
                 num_layers: int = 1, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32, use_linear_projection: bool = False,
                 ip_adapter: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_attention_heads * attention_head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6, **kw)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner, **kw)
            self.proj_out = nn.Linear(inner, in_channels, **kw)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1, **kw)
            self.proj_out = nn.Conv2d(inner, in_channels, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_attention_heads, attention_head_dim,
                                  cross_attention_dim, ip_adapter, **kw)
            for _ in range(num_layers)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        n, c, h, w = hidden_states.shape
        x = self.norm(hidden_states)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(n, h * w, c))
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(n, h * w, x.shape[1])
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states, ip_hidden_states, ip_scale)
        if self.use_linear_projection:
            x = self.proj_out(x)
        x = x.reshape(n, h, w, x.shape[-1]).permute(0, 3, 1, 2).contiguous()
        if not self.use_linear_projection:
            x = self.proj_out(x)
        return x + hidden_states


def _resnets(channels_in: Sequence[int], out_channels: int, temb_channels: int, groups: int,
             eps: float, kw) -> nn.ModuleList:
    return nn.ModuleList([ResnetBlock2D(c, out_channels, temb_channels, groups=groups, eps=eps,
                                        **kw) for c in channels_in])


def _transformers(count: int, channels: int, heads: int, layers: int, cross: int,
                  linear: bool, ip_adapter: bool, kw) -> nn.ModuleList:
    """The blocks' transformers; their GroupNorm keeps 32 groups whatever the
    resnets' count, as in the JAX blocks."""
    return nn.ModuleList([
        Transformer2DModel(heads, channels // heads, channels, layers, cross,
                           use_linear_projection=linear, ip_adapter=ip_adapter, **kw)
        for _ in range(count)])


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, resnet_eps: float = 1e-5, resnet_groups: int = 32,
                 add_downsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets([in_channels] + [out_channels] * (num_layers - 1),
                                out_channels, temb_channels, resnet_groups, resnet_eps, kw)
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
                 use_linear_projection: bool = False, ip_adapter: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets([in_channels] + [out_channels] * (num_layers - 1),
                                out_channels, temb_channels, resnet_groups, resnet_eps, kw)
        self.attentions = _transformers(num_layers, out_channels, num_attention_heads,
                                        transformer_layers_per_block, cross_attention_dim,
                                        use_linear_projection, ip_adapter, kw)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, **kw)])
                             if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None, ip_scale: float = 1.0):
        output_states: Tuple[torch.Tensor, ...] = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = attn(resnet(hidden_states, temb), encoder_hidden_states,
                                 ip_hidden_states, ip_scale)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, num_layers: int = 1,
                 transformer_layers_per_block: int = 1, num_attention_heads: int = 8,
                 cross_attention_dim: int = 768, resnet_eps: float = 1e-5,
                 resnet_groups: int = 32, output_scale_factor: float = 1.0,
                 use_linear_projection: bool = False, ip_adapter: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        resnet = lambda: ResnetBlock2D(  # noqa: E731
            in_channels, in_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
            output_scale_factor=output_scale_factor, **kw)
        self.resnets = nn.ModuleList([resnet() for _ in range(num_layers + 1)])
        self.attentions = _transformers(num_layers, in_channels, num_attention_heads,
                                        transformer_layers_per_block, cross_attention_dim,
                                        use_linear_projection, ip_adapter, kw)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            hidden_states = resnet(attn(hidden_states, encoder_hidden_states, ip_hidden_states,
                                        ip_scale), temb)
        return hidden_states


def _up_resnet_channels(in_channels: int, prev_output_channel: int, out_channels: int,
                        num_layers: int):
    """Input widths of an up block's resnets: the hidden state (the previous
    block's output, then this block's) plus the skip it concatenates (the last
    one is the down block's input width)."""
    return [(prev_output_channel if i == 0 else out_channels)
            + (in_channels if i == num_layers - 1 else out_channels) for i in range(num_layers)]


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, resnet_eps: float = 1e-5,
                 resnet_groups: int = 32, add_upsample: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets(
            _up_resnet_channels(in_channels, prev_output_channel, out_channels, num_layers),
            out_channels, temb_channels, resnet_groups, resnet_eps, kw)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor, res_hidden_states_tuple, temb: torch.Tensor
                ) -> torch.Tensor:
        for i, resnet in enumerate(self.resnets):
            skip = res_hidden_states_tuple[-1 - i]
            hidden_states = resnet(torch.cat([hidden_states, skip], dim=1), temb)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class CrossAttnUpBlock2D(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, transformer_layers_per_block: int = 1,
                 num_attention_heads: int = 8, cross_attention_dim: int = 768,
                 resnet_eps: float = 1e-5, resnet_groups: int = 32, add_upsample: bool = True,
                 use_linear_projection: bool = False, ip_adapter: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = _resnets(
            _up_resnet_channels(in_channels, prev_output_channel, out_channels, num_layers),
            out_channels, temb_channels, resnet_groups, resnet_eps, kw)
        self.attentions = _transformers(num_layers, out_channels, num_attention_heads,
                                        transformer_layers_per_block, cross_attention_dim,
                                        use_linear_projection, ip_adapter, kw)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, **kw)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor, res_hidden_states_tuple, temb: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            skip = res_hidden_states_tuple[-1 - i]
            hidden_states = attn(resnet(torch.cat([hidden_states, skip], dim=1), temb),
                                 encoder_hidden_states, ip_hidden_states, ip_scale)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states
