"""The SwinV2 backbone of the MiDaS ``dpt_swin2_*`` depth models.

Counterpart of ``ctrl_adapter_tpu/conditions/swin2.py`` (timm's
``swinv2_large_window12to24_192to384``): res-post-norm blocks; cosine window
attention with a learned per-head temperature (``logit_scale``, clamped at
log 100); a continuous relative-position bias, ``16 * sigmoid`` of a small MLP
(``cpb_mlp``) over a log-spaced table of relative coordinates; shifted
windows with an additive -100 mask; ``PatchMergingV2`` (reduce, then norm).
The features are the last block of each stage before its downsample, the
four levels at /4 /8 /16 /32 with C, 2C, 4C, 8C channels, as (B, C, h, w).

The parameters carry timm's names (``layers.0.blocks.1.attn.qkv.weight``).
The relative-position index, the coordinate table and the shift masks are
non-persistent buffers made when the module is built, on its device: they
move with ``.to()`` and are never copied from the host during a call (the
checkpoint's own copies of them are dropped on loading). The attention is
plain fp32, as the JAX module's einsums compute it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    img_size: int = 384
    patch_size: int = 4
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 24
    pretrained_window_sizes: Tuple[int, ...] = (12, 12, 12, 6)
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5


SWIN2_LARGE_384 = SwinV2Config()


def _relative_coords_table(window: int, pretrained_window: int) -> np.ndarray:
    """Log-spaced normalised relative coordinates, (1, 2W-1, 2W-1, 2) float32."""
    coords = np.arange(-(window - 1), window, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)[None]
    denom = (pretrained_window - 1) if pretrained_window > 0 else (window - 1)
    table = table / max(denom, 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def _relative_position_index(window: int) -> np.ndarray:
    """(W^2, W^2) index into the flattened (2W-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Additive mask (-100 between tokens of different regions) per window,
    (num_windows, W^2, W^2) float32."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // window, window, w // window, window, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, window^2, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class WindowAttentionV2(nn.Module):
    """Cosine attention with the continuous position bias (timm SwinV2)."""

    def __init__(self, dim: int, num_heads: int, window: int, pretrained_window: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.num_heads = dim, num_heads
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0), **kw))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512, **kw), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False, **kw))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, **kw)
        self.q_bias = nn.Parameter(torch.zeros(dim, **kw))
        self.v_bias = nn.Parameter(torch.zeros(dim, **kw))
        self.proj = nn.Linear(dim, dim, **kw)
        self.register_buffer("relative_coords_table", torch.tensor(
            _relative_coords_table(window, pretrained_window), device=device), persistent=False)
        self.register_buffer("relative_position_index", torch.tensor(
            _relative_position_index(window).reshape(-1), device=device), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        bw, n, _ = x.shape
        heads = self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = (q + self.q_bias).reshape(bw, n, heads, -1).transpose(1, 2).float()
        k = k.reshape(bw, n, heads, -1).transpose(1, 2).float()
        v = (v + self.v_bias).reshape(bw, n, heads, -1).transpose(1, 2)
        qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        kn = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        attn = torch.matmul(qn, kn.transpose(-1, -2))
        attn = attn * torch.exp(self.logit_scale.float().clamp(max=math.log(1.0 / 0.01)))
        table = self.cpb_mlp(self.relative_coords_table.to(self.qkv.weight.dtype)).float()
        bias = table.reshape(-1, heads)[self.relative_position_index]
        attn = attn + 16.0 * torch.sigmoid(bias.reshape(n, n, heads).permute(2, 0, 1))
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]
                    ).reshape(bw, heads, n, n)
        out = torch.matmul(torch.softmax(attn, dim=-1).to(v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(bw, n, self.dim))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinV2Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, resolution: int, window: int, shift: int,
                 pretrained_window: int, mlp_ratio: float = 4.0, eps: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.resolution, self.window, self.shift = dim, resolution, window, shift
        self.attn = WindowAttentionV2(dim, num_heads, window, pretrained_window, **kw)
        self.norm1 = nn.LayerNorm(dim, eps=eps, **kw)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), **kw)
        self.norm2 = nn.LayerNorm(dim, eps=eps, **kw)
        mask = (torch.tensor(_shift_attn_mask(resolution, resolution, window, shift),
                             device=device) if shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        r, window, shift = self.resolution, self.window, self.shift
        xg = x.reshape(b, r, r, c)
        if shift:
            xg = torch.roll(xg, (-shift, -shift), dims=(1, 2))
        xg = _window_reverse(self.attn(_window_partition(xg, window), self.attn_mask),
                             window, r, r)
        if shift:
            xg = torch.roll(xg, (shift, shift), dims=(1, 2))
        x = x + self.norm1(xg.reshape(b, length, c))  # res-post-norm
        return x + self.norm2(self.mlp(x))


class PatchMergingV2(nn.Module):
    def __init__(self, dim: int, resolution: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.resolution = dim, resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, **kw)
        self.norm = nn.LayerNorm(2 * dim, eps=eps, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        r = self.resolution
        xg = x.reshape(b, r, r, self.dim)
        xg = torch.cat([xg[:, 0::2, 0::2], xg[:, 1::2, 0::2], xg[:, 0::2, 1::2],
                        xg[:, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(xg.reshape(b, (r // 2) ** 2, 4 * self.dim)))


class _PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int, eps: float, **kw):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size, **kw)
        self.norm = nn.LayerNorm(embed_dim, eps=eps, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class _Stage(nn.Module):
    """timm's ``BasicLayer``: blocks, then an optional downsample."""

    def __init__(self, dim: int, depth: int, num_heads: int, resolution: int, window_size: int,
                 pretrained_window: int, mlp_ratio: float, eps: float, add_downsample: bool,
                 **kw):
        super().__init__()
        self.dim, self.resolution = dim, resolution
        window = min(window_size, resolution)
        self.blocks = nn.ModuleList(
            SwinV2Block(dim, num_heads, resolution, window,
                        0 if (j % 2 == 0 or resolution <= window) else window // 2,
                        pretrained_window, mlp_ratio, eps, **kw)
            for j in range(depth))
        self.downsample = PatchMergingV2(dim, resolution, eps, **kw) if add_downsample else None

    def forward(self, x: torch.Tensor):
        for block in self.blocks:
            x = block(x)
        r = self.resolution
        feature = x.transpose(1, 2).reshape(x.shape[0], self.dim, r, r)
        if self.downsample is not None:
            x = self.downsample(x)
        return x, feature


class SwinV2Backbone(nn.Module):
    """(B, 3, S, S) pixels -> the 4-level feature pyramid, each (B, C, h, w)."""

    def __init__(self, config: SwinV2Config = SWIN2_LARGE_384, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = self.config = config
        self.patch_embed = _PatchEmbed(cfg.embed_dim, cfg.patch_size, cfg.layer_norm_eps, **kw)
        dim, res = cfg.embed_dim, cfg.img_size // cfg.patch_size
        stages = []
        for i, depth in enumerate(cfg.depths):
            last = i == len(cfg.depths) - 1
            stages.append(_Stage(dim, depth, cfg.num_heads[i], res, cfg.window_size,
                                 cfg.pretrained_window_sizes[i], cfg.mlp_ratio,
                                 cfg.layer_norm_eps, not last, **kw))
            if not last:
                dim, res = dim * 2, res // 2
        self.layers = nn.ModuleList(stages)

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(pixels)
        features = []
        for stage in self.layers:
            x, feature = stage(x)
            features.append(feature)
        return features
