"""GEGLU projection on (..., C) rows: kernel K5.

Counterpart of ``ctrl_adapter_tpu/ops/fused_ff.py``:

    out = value * gelu(gate),   [value; gate] = x W + b

writing only the half-width product. :func:`geglu` is what the ``GEGLU``
module calls. It dispatches on the JAX rule: the kernel runs iff
``CTRL_ADAPTER_FUSED_FF=1`` (read per call) and ``_eligible`` takes the shape
(C = 320 and 640 do at mult-4 FFs, C = 1280 does not); otherwise the plain
version runs. :func:`geglu_kernel` is the kernel's wrapper: the plain version
for a CPU tensor, the kernel (``csrc/geglu.cu``) or an error for a card tensor.

No model of either package reaches K5: their ``BasicTransformerBlock``s run
the FF through ``ops/fused_block.py`` and no model builds ``FeedForward`` on
its own. It is here so that every TPU kernel has a Hopper counterpart.

The weight is in torch ``nn.Linear`` layout: ``w`` (2*D, C) = [value rows; gate rows].
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from ._build import Kernel, ptr, stream_of
from .backend import is_hopper

KERNEL = Kernel("cak_geglu", [
    *([ctypes.c_void_p] * 4), ctypes.c_int64, *([ctypes.c_int] * 3), ctypes.c_void_p,
])

_W_VMEM_BUDGET = 8 * 1024 * 1024  # the TPU's VMEM rule, kept so both packages pick alike


def _torch_geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 approximate: bool) -> torch.Tensor:
    """Plain version of K5 (the math of ``_xla_geglu``)."""
    value, gate = F.linear(x, w, b).chunk(2, dim=-1)
    return value * F.gelu(gate, approximate="tanh" if approximate else "none")


def _tile_rows(c: int) -> int:
    return 256 if c <= 384 else 128


def _eligible(m: int, c: int, d2: int, itemsize: int) -> bool:
    """The JAX shape rule (``ops/fused_ff.py:_eligible``), a pure function of shapes."""
    tm = _tile_rows(c)
    return (m % tm == 0 and d2 % 2 == 0 and c * d2 * itemsize <= _W_VMEM_BUDGET
            and tm * d2 * 4 <= 6 * 1024 * 1024)


def use_kernel(m: int, c: int, d2: int, dtype: torch.dtype) -> bool:
    """The JAX dispatch rule of ``geglu`` without its device test."""
    return os.environ.get("CTRL_ADAPTER_FUSED_FF") == "1" and _eligible(m, c, d2, dtype.itemsize)


def geglu_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 approximate: bool) -> torch.Tensor:
    """K5 on a Hopper card, the plain version on the CPU; raises for a card
    tensor the kernel does not take (bf16 only, C % 32 == 0, D % 64 == 0)."""
    if x.device.type == "cpu":
        return _torch_geglu(x, w, b, approximate)
    if not is_hopper(x):
        raise RuntimeError(f"geglu_kernel: kernel needs an sm_90 device, got {x.device}")
    c = x.shape[-1]
    d = w.shape[0] // 2
    if c % 32 or d % 64 or tuple(w.shape) != (2 * d, c) or tuple(b.shape) != (2 * d,):
        raise ValueError(f"geglu_kernel: kernel needs C % 32 == 0, D % 64 == 0, w (2D, C) and "
                         f"b (2D,); got x {tuple(x.shape)} w {tuple(w.shape)} b {tuple(b.shape)}")
    for name, t in dict(x=x, w=w, b=b).items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"geglu_kernel: {name} must be bfloat16, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"geglu_kernel: {name} must be contiguous on {x.device}")
    m = x.numel() // c
    out = torch.empty((*x.shape[:-1], d), dtype=x.dtype, device=x.device)
    if m:
        KERNEL(ptr(x), ptr(w), ptr(b), ptr(out), m, c, d, int(not approximate), stream_of(x))
    return out


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``value * gelu(gate)`` with [value; gate] = x W + b: K5 where the JAX
    rule sends the shape to its kernel, else the plain version."""
    c = x.shape[-1]
    if use_kernel(x.numel() // c, c, w.shape[0], x.dtype):
        return geglu_kernel(x.contiguous(), w, b, approximate)
    return _torch_geglu(x, w, b, approximate)
