"""Timestep embeddings (counterpart of ``ctrl_adapter_tpu/nn/embeddings.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    """``linear_2(silu(linear_1(sample)))``; keys ``linear_1``/``linear_2``."""

    def __init__(self, in_channels: int, time_embed_dim: int, out_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.linear_1 = nn.Linear(in_channels, time_embed_dim, **kw)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim, **kw)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        sample = sample.to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(sample)))
