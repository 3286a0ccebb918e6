"""Timestep embeddings and the IP-Adapter image projection (counterpart of
``ctrl_adapter_tpu/nn/embeddings.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import LayerNorm


def timestep_tensor(value, device=None) -> torch.Tensor:
    """``value`` (a number, an array or a tensor) as a tensor on ``device``. A
    Python number is filled in on the device: ``torch.as_tensor`` would copy
    it from the host, and that copy waits until the stream has drained."""
    if isinstance(value, (int, float)):
        return torch.full((), value, device=device)
    return torch.as_tensor(value, device=device)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False, downscale_freq_shift: float = 1.0,
                           scale: float = 1.0, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings of a 1-D tensor of (possibly fractional) timesteps,
    diffusers semantics; returns (N, embedding_dim) float32."""
    if timesteps.dim() != 1:
        raise ValueError("timesteps must be 1-D")
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Timesteps(nn.Module):
    """Stateless sinusoidal projection (diffusers ``Timesteps``)."""

    def __init__(self, num_channels: int, flip_sin_to_cos: bool = True,
                 downscale_freq_shift: float = 0.0):
        super().__init__()
        self.num_channels = num_channels
        self.flip_sin_to_cos = flip_sin_to_cos
        self.downscale_freq_shift = downscale_freq_shift

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return get_timestep_embedding(timesteps, self.num_channels, self.flip_sin_to_cos,
                                      self.downscale_freq_shift)


class TimestepEmbedding(nn.Module):
    """``linear_2(silu(linear_1(sample)))``; keys ``linear_1``/``linear_2``. With
    ``cond_proj_dim`` (LCM guidance conditioning), a bias-free ``cond_proj``
    maps a ``condition`` onto the sample before ``linear_1``."""

    def __init__(self, in_channels: int, time_embed_dim: int, out_dim: Optional[int] = None,
                 cond_proj_dim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cond_proj = (nn.Linear(cond_proj_dim, in_channels, bias=False, **kw)
                          if cond_proj_dim is not None else None)
        self.linear_1 = nn.Linear(in_channels, time_embed_dim, **kw)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim, **kw)

    def forward(self, sample: torch.Tensor,
                condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        sample = sample.to(self.linear_1.weight.dtype)
        if condition is not None and self.cond_proj is not None:
            sample = sample + self.cond_proj(condition.to(sample.dtype))
        return self.linear_2(F.silu(self.linear_1(sample)))


class ImageProjection(nn.Module):
    """diffusers ``ImageProjection``: a CLIP image embedding (b, d) to
    ``num_image_text_embeds`` context tokens (b, n, cross_attention_dim), a
    Linear ``image_embeds`` then a LayerNorm ``norm`` (fp32 statistics)."""

    def __init__(self, image_embed_dim: int, cross_attention_dim: int,
                 num_image_text_embeds: int = 4, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_image_text_embeds = num_image_text_embeds
        self.cross_attention_dim = cross_attention_dim
        self.image_embeds = nn.Linear(image_embed_dim,
                                      num_image_text_embeds * cross_attention_dim, **kw)
        self.norm = LayerNorm(cross_attention_dim, eps=1e-5, **kw)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.image_embeds(image_embeds.to(self.image_embeds.weight.dtype))
        return self.norm(x.reshape(x.shape[0], self.num_image_text_embeds,
                                   self.cross_attention_dim))


class MultiIPAdapterImageProjection(nn.Module):
    """diffusers' ``encoder_hid_proj``: one IP-Adapter's projection at
    ``image_projection_layers.0``."""

    def __init__(self, image_embed_dim: int, cross_attention_dim: int,
                 num_image_text_embeds: int = 4, device=None, dtype=None):
        super().__init__()
        self.image_projection_layers = nn.ModuleList([ImageProjection(
            image_embed_dim, cross_attention_dim, num_image_text_embeds, device=device,
            dtype=dtype)])

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        return self.image_projection_layers[0](image_embeds)
