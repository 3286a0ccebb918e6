"""ResNet blocks, up/down sampling and AlphaBlender, NCHW / NCFHW.

Counterpart of ``ctrl_adapter_tpu/nn/resnet.py``. ``GroupNorm``'s ``kernel``
flag is the JAX ``use_pallas``: None (the default) sends the norm to kernel K1
(``ops/group_norm.py``) under ``CTRL_ADAPTER_FUSED_GN=1``, "prefer" (the
adapter's norms) always, False never; in each case only where the JAX shape
rule ``group_norm.eligible`` holds. Every other norm runs the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import group_norm as gn
from ..ops.resize import nearest_resize


class GroupNorm(nn.Module):
    """GroupNorm over dim 1 (contiguous groups, fp32 statistics) with an
    optionally fused SiLU; keys ``weight``/``bias``. ``kernel``: None, "prefer"
    or False, as ``group_norm.use_kernel`` reads it."""

    def __init__(self, num_groups: int, num_channels: int, eps: float,
                 kernel: Optional[object] = None, device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.kernel = kernel
        self.weight = nn.Parameter(torch.ones(num_channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if gn.use_kernel(self.kernel, x.shape, self.num_groups, x.element_size()):
            return gn.group_norm_silu(x.contiguous(), self.weight, self.bias, self.num_groups,
                                      self.eps, silu)
        return gn._torch_group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps, silu)


class Upsample2D(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv (key ``conv``)."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_resize(x, (2 * x.shape[-2], 2 * x.shape[-1])))


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv (key ``conv``); ``padding=0`` pads right/bottom by one
    first, as diffusers does in the VAE encoder."""

    def __init__(self, channels: int, padding: int = 1, device=None, dtype=None):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=padding, device=device,
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> (nearest upsample) -> conv3x3 -> +temb -> GN -> SiLU ->
    conv3x3 (+shortcut). With ``up``, the hidden state and the input are both
    resized to ``output_size`` (default 2x) after the first norm, the
    reference fork's arbitrary-size upsample."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32, eps: float = 1e-6,
                 output_scale_factor: float = 1.0, use_in_shortcut: Optional[bool] = None,
                 gn_kernel: Optional[object] = None, up: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        out_channels = out_channels or in_channels
        self.output_scale_factor = output_scale_factor
        self.up = up
        self.norm1 = GroupNorm(groups, in_channels, eps, gn_kernel, **kw)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels, **kw)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(groups, out_channels, eps, gn_kernel, **kw)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        if use_in_shortcut is None:
            use_in_shortcut = in_channels != out_channels
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, **kw)
                              if use_in_shortcut else None)

    def forward(self, input_tensor: torch.Tensor, temb: Optional[torch.Tensor] = None,
                output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        hidden = self.norm1(input_tensor, silu=True)
        if self.up:
            target = output_size or (2 * hidden.shape[-2], 2 * hidden.shape[-1])
            input_tensor = nearest_resize(input_tensor, target)
            hidden = nearest_resize(hidden, target)
        hidden = self.conv1(hidden)
        if temb is not None and self.time_emb_proj is not None:
            hidden = hidden + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        hidden = self.conv2(self.norm2(hidden, silu=True))
        if self.conv_shortcut is not None:
            input_tensor = self.conv_shortcut(input_tensor)
        return (input_tensor + hidden) / self.output_scale_factor


class TemporalResnetBlock(nn.Module):
    """(3,1,1)-kernel ResNet block over (B, C, F, H, W); ``temb`` is (B, F, Ct)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, eps: float = 1e-6,
                 gn_kernel: Optional[object] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(32, in_channels, eps, gn_kernel, **kw)
        self.conv1 = nn.Conv3d(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0), **kw)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels, **kw)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(32, out_channels, eps, gn_kernel, **kw)
        self.conv2 = nn.Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0), **kw)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def forward(self, input_tensor: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.conv1(self.norm1(input_tensor, silu=True))
        if temb is not None and self.time_emb_proj is not None:
            t = self.time_emb_proj(F.silu(temb))  # (B, F, C)
            hidden = hidden + t.permute(0, 2, 1)[:, :, :, None, None]
        hidden = self.conv2(self.norm2(hidden, silu=True))
        if self.conv_shortcut is not None:
            input_tensor = self.conv_shortcut(input_tensor)
        return input_tensor + hidden


class AlphaBlender(nn.Module):
    """``alpha * x_spatial + (1 - alpha) * x_temporal`` with alpha =
    sigmoid(mix_factor) ("learned"), forced to 1 on image-only frames
    ("learned_with_images").

    Layouts: 5-D (B, C, F, H, W) or 3-D (B*F, S, C); ``image_only_indicator``
    is (B, F)."""

    def __init__(self, alpha: float = 0.5, merge_strategy: str = "learned_with_images",
                 switch_spatial_to_temporal_mix: bool = False, device=None, dtype=None):
        super().__init__()
        if merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(merge_strategy)
        self.merge_strategy = merge_strategy
        self.switch = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.full((1,), alpha, device=device, dtype=dtype))

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
                image_only_indicator: Optional[torch.Tensor] = None) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float())
        if self.merge_strategy == "learned_with_images":
            if image_only_indicator is None:
                raise ValueError("learned_with_images needs image_only_indicator")
            alpha = torch.where(image_only_indicator.bool(),
                                torch.ones_like(image_only_indicator, dtype=torch.float32),
                                alpha[..., None])
            if x_spatial.dim() == 5:
                alpha = alpha[:, None, :, None, None]
            elif x_spatial.dim() == 3:
                alpha = alpha.reshape(-1)[:, None, None]
            else:
                raise ValueError(f"unexpected ndim {x_spatial.dim()}")
        alpha = alpha.to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return x_spatial * alpha + x_temporal * (1.0 - alpha)
