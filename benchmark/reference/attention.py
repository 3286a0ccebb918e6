"""Attention and transformer blocks on (B, T, C) sequences, plain float32.

Parameter names are the diffusers ones (``to_q``, ``to_out.0``,
``ff.net.0.proj``, ``ff.net.2``), so a state dict of the program's towers loads
unchanged. Every attention is softmax attention (``ops.attention``); every
GEGLU uses the exact gelu.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from . import ops


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head attention, bias-free QKV, biased output projection."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False, **kw)
        self.to_k = nn.Linear(kv_dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(kv_dim, inner, bias=False, **kw)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, **kw), nn.Dropout(0.0)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, tq, _ = hidden_states.shape
        n, h = self.heads, self.dim_head
        context = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        context = context.to(hidden_states.dtype)
        tk = context.shape[1]
        q = self.to_q(hidden_states).view(b, tq, n, h)
        k = self.to_k(context).view(b, tk, n, h)
        v = self.to_v(context).view(b, tk, n, h)
        return self.to_out[0](ops.attention(q, k, v).reshape(b, tq, n * h))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.geglu(x, self.proj)


class FeedForward(nn.Module):
    """GEGLU feed-forward: ``net.0`` (GEGLU), ``net.1`` (dropout), ``net.2``."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        inner = dim * 4
        self.net = nn.ModuleList([
            GEGLU(dim, inner, device=device, dtype=dtype), nn.Dropout(0.0),
            nn.Linear(inner, dim_out or dim, device=device, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LayerNorm-sandwiched self-attention, cross-attention and GEGLU FF."""

    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int,
                 cross_attention_dim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = Attention(dim, num_attention_heads, attention_head_dim, **kw)
        self.norm2 = self.attn2 = None
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim, eps=1e-5, **kw)
            self.attn2 = Attention(dim, num_attention_heads, attention_head_dim,
                                   cross_attention_dim, **kw)
        self.norm3 = LayerNorm(dim, eps=1e-5, **kw)
        self.ff = FeedForward(dim, dim, **kw)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.attn1(self.norm1(hidden_states)) + hidden_states
        if self.attn2 is not None:
            hidden_states = self.attn2(self.norm2(hidden_states),
                                       encoder_hidden_states) + hidden_states
        return self.ff(self.norm3(hidden_states)) + hidden_states


class TemporalBasicTransformerBlock(nn.Module):
    """Per-pixel transformer over the frame axis of (b*f, s, c) activations."""

    def __init__(self, dim: int, time_mix_inner_dim: int, num_attention_heads: int,
                 attention_head_dim: int, cross_attention_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        tmid = time_mix_inner_dim
        self.dim, self.tmid = dim, tmid
        self.norm_in = LayerNorm(dim, eps=1e-5, **kw)
        self.ff_in = FeedForward(dim, tmid, **kw)
        self.norm1 = LayerNorm(tmid, eps=1e-5, **kw)
        self.attn1 = Attention(tmid, num_attention_heads, attention_head_dim, **kw)
        self.norm2 = self.attn2 = None
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(tmid, eps=1e-5, **kw)
            self.attn2 = Attention(tmid, num_attention_heads, attention_head_dim,
                                   cross_attention_dim, **kw)
        self.norm3 = LayerNorm(tmid, eps=1e-5, **kw)
        self.ff = FeedForward(tmid, tmid, **kw)

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        bf, s, c = hidden_states.shape
        b = bf // num_frames
        is_res = self.dim == self.tmid
        # (b*f, s, c) -> (b*s, f, c): frames become the attention sequence
        h = hidden_states.reshape(b, num_frames, s, c).permute(0, 2, 1, 3)
        h = h.reshape(b * s, num_frames, c)
        ff_in = self.ff_in(self.norm_in(h))
        h = ff_in + h if is_res else ff_in
        h = self.attn1(self.norm1(h)) + h
        if self.attn2 is not None:
            h = self.attn2(self.norm2(h), encoder_hidden_states) + h
        ff = self.ff(self.norm3(h))
        h = ff + h if is_res else ff
        h = h.reshape(b, s, num_frames, self.tmid).permute(0, 2, 1, 3)
        return h.reshape(bf, s, self.tmid)
