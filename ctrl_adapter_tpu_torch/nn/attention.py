"""Attention and transformer blocks on (B, T, C) sequences.

Counterpart of ``ctrl_adapter_tpu/nn/attention.py``. Parameter names are the
diffusers ones (``to_q``, ``to_out.0``, ``ff.net.0.proj``, ``ff.net.2``).

- ``Attention`` keeps the JAX paths: flash-eligible self-attention (the JAX
  shape rule alone) goes to kernel K2 on head-split views of the projections
  (no transposes); single-key
  attention returns V broadcast; sequences of 32 or fewer use an einsum with an
  fp32 softmax; everything else is plain attention.
- ``TemporalBasicTransformerBlock`` runs the "hybrid" decomposition (GEGLU FFs
  in plain torch on the (b, f, s, c) layout, the attention sub-block as kernel
  K3) wherever the JAX dispatch would (``nn/attention.py:480-496``, bf16 and
  at most 32 frames), and the transposing module path otherwise.

Each kernel's wrapper owns its checks: it runs the plain version for a tensor
on the CPU and launches the kernel, or raises, for a tensor on a card.
- GEGLU uses tanh-gelu under bf16 and exact gelu under fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops import fused_temporal as ft


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics whatever the storage dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


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
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, **kw),
                                     nn.Dropout(0.0)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, tq, _ = hidden_states.shape
        n, h = self.heads, self.dim_head
        if encoder_hidden_states is None and fa.flash_eligible(tq, tq, h):
            # (B, T, N*H) projections seen as (B, N, T, H): no head-split copies
            split = lambda t: t.view(b, tq, n, h).transpose(1, 2)  # noqa: E731
            out = fa.attention_bnth(split(self.to_q(hidden_states)),
                                 split(self.to_k(hidden_states)),
                                 split(self.to_v(hidden_states)))
            return self.to_out[0](out.transpose(1, 2).reshape(b, tq, n * h))
        context = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        context = context.to(hidden_states.dtype)
        tk = context.shape[1]
        q = self.to_q(hidden_states).view(b, tq, n, h)
        k = self.to_k(context).view(b, tk, n, h)
        v = self.to_v(context).view(b, tk, n, h)
        out = fa.dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, tq, n * h))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(x).chunk(2, dim=-1)
        approx = "tanh" if self.proj.weight.dtype == torch.bfloat16 else "none"
        return value * F.gelu(gate, approximate=approx)


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
        attn = lambda cross: Attention(  # noqa: E731
            dim, num_attention_heads, attention_head_dim, cross, **kw)
        self.norm1 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = attn(None)
        self.norm2 = self.attn2 = None
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim, eps=1e-5, **kw)
            self.attn2 = attn(cross_attention_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5, **kw)
        self.ff = FeedForward(dim, dim, **kw)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.attn1(self.norm1(hidden_states)) + hidden_states
        if self.attn2 is not None:
            hidden_states = self.attn2(self.norm2(hidden_states),
                                       encoder_hidden_states) + hidden_states
        return self.ff(self.norm3(hidden_states)) + hidden_states


def _ff_args(norm: LayerNorm, ff: FeedForward):
    proj, out = ff.net[0].proj, ff.net[2]
    return norm.weight, norm.bias, proj.weight, proj.bias, out.weight, out.bias


class TemporalBasicTransformerBlock(nn.Module):
    """Per-pixel transformer over the frame axis of (b*f, s, c) activations."""

    def __init__(self, dim: int, time_mix_inner_dim: int, num_attention_heads: int,
                 attention_head_dim: int, cross_attention_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        tmid = time_mix_inner_dim
        self.dim, self.tmid = dim, tmid
        self.heads = num_attention_heads
        self.norm_in = LayerNorm(dim, eps=1e-5, **kw)
        self.ff_in = FeedForward(dim, tmid, **kw)
        self.norm1 = LayerNorm(tmid, eps=1e-5, **kw)
        self.attn1 = Attention(tmid, num_attention_heads, attention_head_dim, **kw)
        self.norm2 = self.attn2 = None
        if cross_attention_dim is not None:
            # single-key cross-attention reads only to_v/to_out; norm2, to_q and
            # to_k exist so that released checkpoints load unchanged
            self.norm2 = LayerNorm(tmid, eps=1e-5, **kw)
            self.attn2 = Attention(tmid, num_attention_heads, attention_head_dim,
                                   cross_attention_dim, **kw)
        self.norm3 = LayerNorm(tmid, eps=1e-5, **kw)
        self.ff = FeedForward(tmid, tmid, **kw)

    def _hybrid(self, hidden_states, num_frames, ctx):
        bf, s, c = hidden_states.shape
        b = bf // num_frames
        approx = self.norm1.weight.dtype == torch.bfloat16
        x4 = hidden_states.reshape(b, num_frames, s, c)
        cur = ft.ln_geglu_ff(x4, *_ff_args(self.norm_in, self.ff_in), 1e-5, approx, True)
        cross_bias = None
        if self.attn2 is not None:
            # softmax over one key is 1: the output is to_out(to_v(ctx)) per (b, s)
            v = F.linear(ctx[:, 0].to(cur.dtype), self.attn2.to_v.weight)
            cross_bias = self.attn2.to_out[0](v).reshape(b, s, c).contiguous()
        a = self.attn1
        cur = ft.temporal_block(cur.contiguous(), cross_bias, self.norm1.weight,
                                self.norm1.bias, a.to_q.weight, a.to_k.weight, a.to_v.weight,
                                a.to_out[0].weight, a.to_out[0].bias, self.heads, 1e-5)
        out = ft.ln_geglu_ff(cur, *_ff_args(self.norm3, self.ff), 1e-5, approx, True)
        return out.reshape(bf, s, c)

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        bf, s, c = hidden_states.shape
        b = bf // num_frames
        is_res = self.dim == self.tmid
        ctx = encoder_hidden_states
        ctx_ok = (self.attn2 is None and ctx is None) or (
            self.attn2 is not None and ctx is not None and ctx.dim() == 3
            and ctx.shape[1] == 1 and ctx.shape[0] == b * s)
        if is_res and c == self.dim and ctx_ok and ft.eligible(num_frames, hidden_states.dtype):
            return self._hybrid(hidden_states, num_frames, ctx)

        # (b*f, s, c) -> (b*s, f, c): frames become the attention sequence
        h = hidden_states.reshape(b, num_frames, s, c).permute(0, 2, 1, 3)
        h = h.reshape(b * s, num_frames, c)
        approx = self.norm1.weight.dtype == torch.bfloat16
        h = ft.ln_geglu_ff(h, *_ff_args(self.norm_in, self.ff_in), 1e-5, approx, is_res)
        h = self.attn1(self.norm1(h)) + h
        if self.attn2 is not None:
            h = self.attn2(self.norm2(h), encoder_hidden_states) + h
        h = ft.ln_geglu_ff(h, *_ff_args(self.norm3, self.ff), 1e-5, approx, is_res)
        h = h.reshape(b, s, num_frames, self.tmid).permute(0, 2, 1, 3)
        return h.reshape(bf, s, self.tmid)
