"""Temporal transformer block on (b, f, s, c): kernel K3 ("hybrid" mode).

Counterpart of ``ctrl_adapter_tpu/ops/fused_temporal.py``. The port runs the
TPU's "hybrid" decomposition of ``TemporalBasicTransformerBlock``:

    x -> [LN_in -> GEGLU FF_in (+res)]        plain torch, :func:`ln_geglu_ff`
      -> [LN1 -> Q,K,V -> attention over the f frames at each (b, s, head)
          -> out-proj (+bo) + res + cross bias]   :func:`temporal_block` (K3)
      -> [LN3 -> GEGLU FF (+res)]             plain torch, :func:`ln_geglu_ff`

all on the transpose-free (b, f, s, c) layout. The cross bias is the single-key
cross-attention ``to_out(to_v(ctx))`` per (b, s), computed by the caller.

Weights are in torch ``nn.Linear`` layout: ``wq/wk/wv`` (ia, c), ``wo`` (c, ia).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import Kernel, ptr, stream_of
from .backend import is_hopper

KERNEL = Kernel("cak_temporal_attention", [
    *([ctypes.c_void_p] * 11), *([ctypes.c_int] * 6), ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
])

KERNEL_HEAD_DIM = 64
_MAX_ROWS = 128  # f * ts rows per CTA of the kernel


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics (two-pass variance, clamped at 0)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def ln_geglu_ff(x: torch.Tensor, ln_w, ln_b, wg, bg, w2, b2, eps: float,
                approximate: bool, residual: bool) -> torch.Tensor:
    """``x + W2 (value * gelu(gate)) + b2`` with [value; gate] = LN(x) Wg + bg
    (the math of ``ops/fused_block.py:_xla_ln_ff_residual``)."""
    a = F.linear(_ln(x, ln_w, ln_b, eps), wg, bg)
    value, gate = a.chunk(2, dim=-1)
    h = value * F.gelu(gate, approximate="tanh" if approximate else "none")
    out = F.linear(h, w2, b2)
    return out + x if residual else out


def _torch_temporal_block(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int,
                          eps: float) -> torch.Tensor:
    """Plain version of K3 (``_xla_temporal_block`` with parts=("attn",))."""
    b, f, s, c = x.shape
    hd = wq.shape[0] // heads
    y = _ln(x, ln_w, ln_b, eps)
    q = F.linear(y, wq).reshape(b, f, s, heads, hd)
    k = F.linear(y, wk).reshape(b, f, s, heads, hd)
    v = F.linear(y, wv).reshape(b, f, s, heads, hd)
    logits = torch.einsum("bisnh,bjsnh->bsnij", q, k) * hd ** -0.5
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    o = torch.einsum("bsnij,bjsnh->bisnh", probs, v).reshape(b, f, s, heads * hd)
    out = x + F.linear(o, wo, bo)
    if cross_bias is not None:
        out = out + cross_bias[:, None]
    return out


def eligible(num_frames: int, dtype: torch.dtype) -> bool:
    """The JAX dispatch rule (``dispatch_mode``) without the TPU's VMEM plan:
    bf16 activations and at most 32 frames. :func:`temporal_block` raises for a
    shape on the card that its kernel does not take."""
    return dtype == torch.bfloat16 and num_frames <= 32


def _spatial_tile(f: int, s: int) -> int:
    ts = 1
    while f * ts * 2 <= _MAX_ROWS and s % (ts * 2) == 0:
        ts *= 2
    return ts


def temporal_block(x: torch.Tensor, cross_bias: Optional[torch.Tensor], ln_w, ln_b, wq,
                   wk, wv, wo, bo, heads: int, eps: float = 1e-5) -> torch.Tensor:
    """``x + to_out(attn_over_frames(LN1(x))) (+ cross_bias[:, None])`` on
    (b, f, s, c). Kernel K3 on a Hopper card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return _torch_temporal_block(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)
    if not is_hopper(x):
        raise RuntimeError(f"temporal_block: kernel needs an sm_90 device, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"temporal_block: x must be (b, f, s, c), got {tuple(x.shape)}")
    b, f, s, c = x.shape
    ia = heads * KERNEL_HEAD_DIM
    if f > 32 or c % 64 or wq.shape[0] != ia:
        raise ValueError(f"temporal_block: kernel needs f <= 32, c % 64 == 0 and head "
                         f"dim 64; got f={f} c={c} ia={wq.shape[0]} heads={heads}")
    expect = {"ln_w": (c,), "ln_b": (c,), "wq": (ia, c), "wk": (ia, c), "wv": (ia, c),
              "wo": (c, ia), "bo": (c,)}
    tensors = dict(x=x, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    if cross_bias is not None:
        expect["cross_bias"] = (b, s, c)
        tensors["cross_bias"] = cross_bias
    for name, t in tensors.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"temporal_block: {name} shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
        if t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"temporal_block: {name} must be contiguous bfloat16 on {x.device}")
    o = torch.empty((b, f, s, ia), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    KERNEL(ptr(x), ptr(ln_w), ptr(ln_b), ptr(wq), ptr(wk), ptr(wv), ptr(o), ptr(wo), ptr(bo),
           None if cross_bias is None else ptr(cross_bias), ptr(out),
           b, f, s, c, heads, _spatial_tile(f, s), float(eps),
           float(KERNEL_HEAD_DIM ** -0.5), stream_of(x))
    return out
