"""Attention dispatch: flash kernel K2 for large self-attention, plain torch else.

Counterpart of ``ctrl_adapter_tpu/ops/flash_attention.py``. The dispatch rule
is the JAX shape rule (``flash_eligible``/``_eligible``): self-attention with
T >= 1024, T % 512 == 0 and head_dim in {64, 128}, whatever the device and
dtype. :func:`attention_bnth` runs its plain version for a tensor on the CPU
and launches the kernel, or raises, for a tensor on a card.

Kernel K2 (``csrc/flash_attention.cu``) takes (B, N, T, H) views whose last
stride is 1, so callers pass head-split views of their (B, T, N*H) projections
without transposing them, and read the output the same way.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, ptr, stream_of
from .backend import is_hopper

MIN_SEQ = 1024
_BLOCK = 512
_LOGITS_BYTES = 1 << 30  # plain attention: fp32 logits per batch chunk

KERNEL = Kernel("cak_flash_attention", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    *([ctypes.c_int64] * 12), ctypes.c_float, ctypes.c_void_p,
])


def flash_eligible(tq: int, tk: int, head_dim: int) -> bool:
    """The JAX shape rule for the flash kernel (``ops/flash_attention.py:71-94``)."""
    return tq == tk and tq >= MIN_SEQ and tq % _BLOCK == 0 and head_dim in (64, 128)


def _torch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(H)) v over (B, N, T, H) with fp32 logits and softmax,
    probabilities cast to v's dtype (the math of ``jax.nn.dot_product_attention``).
    The batch*head axis runs in chunks that keep the fp32 logits near 1 GiB."""
    b, n, t, h = q.shape
    s = k.shape[2]
    qf = q.reshape(b * n, t, h)
    kf = k.reshape(b * n, s, h)
    vf = v.reshape(b * n, s, h)
    out = torch.empty((b * n, t, h), dtype=v.dtype, device=v.device)
    step = max(1, _LOGITS_BYTES // (t * s * 4))
    scale = h ** -0.5
    for i in range(0, b * n, step):
        logits = torch.matmul(qf[i:i + step].float(), kf[i:i + step].float().transpose(1, 2))
        probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        out[i:i + step] = torch.matmul(probs, vf[i:i + step])
    return out.reshape(b, n, t, h)


def _check(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention_bnth: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"attention_bnth: {name} needs a unit last stride, other strides "
                         f"a multiple of 8 and 16-byte alignment, got {t.stride()}")


def attention_bnth(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over (B, N, T, H) views. Kernel K2 on a Hopper card, the
    plain version on the CPU. Returns a (B, N, T, H) view of a (B, T, N, H)
    contiguous tensor."""
    if q.device.type == "cpu":
        return _torch_attention(q, k, v)
    if not is_hopper(q):
        raise RuntimeError(f"attention_bnth: kernel needs an sm_90 device, got {q.device}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"attention_bnth: self-attention shapes differ: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, n, t, h = q.shape
    if h not in (64, 128) or t % 64:
        raise ValueError(f"attention_bnth: needs H in (64, 128) and T % 64 == 0, got {q.shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"attention_bnth: {name} on {x.device}, q on {q.device}")
        _check(name, x)
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    KERNEL(ptr(q), ptr(k), ptr(v), ptr(out), b, n, t, h, *strides, float(h ** -0.5),
           stream_of(q))
    return out


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, N, H) attention: the single-key, tiny-sequence and plain paths of
    the JAX dispatcher."""
    tk = k.shape[1]
    if tk == 1:
        # softmax over one key is 1: the output is V broadcast over the queries
        return v.expand(q.shape[0], q.shape[1], *v.shape[2:]).to(v.dtype)
    if q.shape[1] <= 32 and tk <= 32:
        # tiny (frame) sequences: logits in the input dtype, softmax in fp32
        s = torch.einsum("btnh,bsnh->bnts", q, k) * q.shape[-1] ** -0.5
        p = torch.softmax(s.float(), dim=-1).to(v.dtype)
        return torch.einsum("bnts,bsnh->btnh", p, v)
    # flash-eligible self-attention never gets here: ``Attention`` sends it to
    # attention_bnth on head-split views of its projections
    return _torch_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)
