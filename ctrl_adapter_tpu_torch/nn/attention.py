"""Attention and transformer blocks on (B, T, C) sequences.

Counterpart of ``ctrl_adapter_tpu/nn/attention.py``. Parameter names are the
diffusers ones (``to_q``, ``to_out.0``, ``ff.net.0.proj``, ``ff.net.2``).

- ``Attention`` keeps the JAX paths: flash-eligible self-attention (the JAX
  shape rule alone) goes to kernel K2 on head-split views of the projections
  (no transposes); single-key
  attention returns V broadcast; sequences of 32 or fewer use an einsum with an
  fp32 softmax; everything else is plain attention.
- ``TemporalBasicTransformerBlock`` branches three ways on the JAX
  ``dispatch_mode``, ``_plan`` included (``nn/attention.py:487-496``): "full"
  runs the whole block as kernel K3 "full" (one launch), "hybrid" the
  attention sub-block as kernel K3 with the GEGLU FFs in plain torch on the
  (b, f, s, c) layout, and None the transposing module path.
- The LayerNorm -> GEGLU FF (+residual) sub-blocks of ``BasicTransformerBlock``
  and of the temporal module path go through ``fused_block.ln_ff_residual``
  (kernel K4 under ``CTRL_ADAPTER_FUSED_BLOCK=1`` at the JAX shapes), and
  ``GEGLU`` through ``fused_ff.geglu`` (kernel K5 under ``CTRL_ADAPTER_FUSED_FF=1``).

Each kernel's wrapper owns its checks: it runs the plain version for a tensor
on the CPU and launches the kernel, or raises, for a tensor on a card.

Every GEGLU picks its gelu form by :func:`gelu_approximate`, the JAX rule:
tanh-gelu under bf16 unless ``CTRL_ADAPTER_EXACT_GELU=1`` (read per call),
exact (erf) gelu otherwise.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops import fused_block as fb
from ..ops import fused_ff
from ..ops import fused_temporal as ft


def gelu_approximate(dtype: torch.dtype) -> bool:
    """The JAX package's gelu rule (``nn/attention.py`` at ``GEGLU``, ``_ln_ff``
    and the fused temporal block): the tanh form under bf16, unless
    ``CTRL_ADAPTER_EXACT_GELU=1`` forces exact gelu everywhere."""
    return dtype == torch.bfloat16 and os.environ.get("CTRL_ADAPTER_EXACT_GELU") != "1"


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
        return fused_ff.geglu(x, self.proj.weight, self.proj.bias,
                              gelu_approximate(self.proj.weight.dtype))


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
        return fb.ln_ff_residual(hidden_states, *_ff_args(self.norm3, self.ff), 1e-5,
                                 gelu_approximate(self.norm3.weight.dtype), True)


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
        approx = gelu_approximate(self.norm1.weight.dtype)
        x4 = hidden_states.reshape(b, num_frames, s, c)
        cur = fb._torch_ln_ff_residual(x4, *_ff_args(self.norm_in, self.ff_in), 1e-5, approx,
                                       True)
        cur = ft.temporal_block(cur.contiguous(), self._cross_bias(ctx, b, s, c),
                                *self._attn_args(), self.heads, 1e-5)
        out = fb._torch_ln_ff_residual(cur, *_ff_args(self.norm3, self.ff), 1e-5, approx, True)
        return out.reshape(bf, s, c)

    def _full(self, hidden_states, num_frames, ctx):
        bf, s, c = hidden_states.shape
        b = bf // num_frames
        out = ft.temporal_block_full(
            hidden_states.reshape(b, num_frames, s, c).contiguous(),
            self._cross_bias(ctx, b, s, c), *self._attn_args(), self.heads, 1e-5,
            _ff_args(self.norm_in, self.ff_in), _ff_args(self.norm3, self.ff),
            gelu_approximate(self.norm1.weight.dtype))
        return out.reshape(bf, s, c)

    def _cross_bias(self, ctx, b, s, c):
        if self.attn2 is None:
            return None
        # softmax over one key is 1: the output is to_out(to_v(ctx)) per (b, s)
        v = F.linear(ctx[:, 0].to(self.norm1.weight.dtype), self.attn2.to_v.weight)
        return self.attn2.to_out[0](v).reshape(b, s, c).contiguous()

    def _attn_args(self):
        a = self.attn1
        return (self.norm1.weight, self.norm1.bias, a.to_q.weight, a.to_k.weight,
                a.to_v.weight, a.to_out[0].weight, a.to_out[0].bias)

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        bf, s, c = hidden_states.shape
        b = bf // num_frames
        is_res = self.dim == self.tmid
        ctx = encoder_hidden_states
        ctx_ok = (self.attn2 is None and ctx is None) or (
            self.attn2 is not None and ctx is not None and ctx.dim() == 3
            and ctx.shape[1] == 1 and ctx.shape[0] == b * s)
        mode = ft.dispatch_mode(b, num_frames, s, self.tmid, self.heads * self.attn1.dim_head,
                                4 * self.tmid, hidden_states.dtype)
        if is_res and c == self.dim and ctx_ok and mode is not None:
            run = self._full if mode == "full" else self._hybrid
            return run(hidden_states, num_frames, ctx)

        # (b*f, s, c) -> (b*s, f, c): frames become the attention sequence
        h = hidden_states.reshape(b, num_frames, s, c).permute(0, 2, 1, 3)
        h = h.reshape(b * s, num_frames, c)
        approx = gelu_approximate(self.norm1.weight.dtype)
        h = fb.ln_ff_residual(h, *_ff_args(self.norm_in, self.ff_in), 1e-5, approx, is_res)
        h = self.attn1(self.norm1(h)) + h
        if self.attn2 is not None:
            h = self.attn2(self.norm2(h), encoder_hidden_states) + h
        h = fb.ln_ff_residual(h, *_ff_args(self.norm3, self.ff), 1e-5, approx, is_res)
        h = h.reshape(b, s, num_frames, self.tmid).permute(0, 2, 1, 3)
        return h.reshape(bf, s, self.tmid)
