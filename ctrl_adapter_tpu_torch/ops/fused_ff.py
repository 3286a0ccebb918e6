"""GEGLU projection on (..., C) rows: kernel K5.

Counterpart of ``ctrl_adapter_tpu/ops/fused_ff.py``:

    out = value * gelu(gate),   [value; gate] = x W + b

writing only the half-width product. :func:`geglu` is what the ``GEGLU``
module calls. It dispatches on the JAX rule: the kernel runs iff
``CTRL_ADAPTER_FUSED_FF=1`` (read per call) and ``_eligible`` takes the shape
(C = 320 and 640 do at mult-4 FFs, C = 1280 does not); otherwise the plain
version runs. :func:`geglu_kernel` is the kernel's wrapper: the plain version
for a CPU tensor, the kernel (``csrc/geglu.cu``, launched with :func:`plan`)
or an error for a card tensor.

No model of either package reaches K5: their ``BasicTransformerBlock``s run
the FF through ``ops/fused_block.py`` and no model builds ``FeedForward`` on
its own. It is here so that every TPU kernel has a Hopper counterpart.

The weight is in torch ``nn.Linear`` layout: ``w`` (2*D, C) = [value rows; gate rows].
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import mirror_vjp
from ._build import Kernel, ptr, stream_of
from .backend import SMEM_PER_BLOCK, is_hopper, sm_count

KERNEL = Kernel("cak_geglu", [
    *([ctypes.c_void_p] * 4), ctypes.c_int64, *([ctypes.c_int] * 5), ctypes.c_void_p,
])

_TILE_ROWS = 128    # kernel: a tile is 128 rows x 64 outputs (and their 64 gates)
_TILE_OUT = 64
_CHUNK = 64         # channels per ring stage
_STAGES = 5

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


@dataclass(frozen=True)
class Plan:
    tiles: int         # ceil(m / 128) row tiles x D / 64 column tiles, column tiles adjacent
    k_chunks: int      # 64-channel ring stages per tile (the last one zero-padded)
    grid: int          # persistent CTAs, one an SM
    smem_bytes: int


def plan(m: int, c: int, d: int, sms: int = 132) -> Plan:
    """The launch of K5 on a card of ``sms`` SMs: one persistent CTA per SM
    (at most one per tile); shared memory for a ring of 5 stages of 32 KiB (a
    128 x 64 chunk of x, 64 value and 64 gate rows of W), two 16 KiB output
    staging tiles, 10 mbarriers and 1 KiB of alignment slack.
    ``csrc/geglu.cu`` refuses any other shared-memory size."""
    if m < 1 or c < 8 or c % 8 or d < _TILE_OUT or d % _TILE_OUT:
        raise ValueError(f"geglu_kernel: kernel needs C % 8 == 0 and D % {_TILE_OUT} == 0; "
                         f"got m={m} C={c} D={d}")
    tiles = -(-m // _TILE_ROWS) * (d // _TILE_OUT)
    stage = (_TILE_ROWS + 2 * _TILE_OUT) * _CHUNK * 2
    smem = _STAGES * stage + 2 * _TILE_ROWS * _TILE_OUT * 2 + 16 * _STAGES + 1024
    assert smem <= SMEM_PER_BLOCK
    return Plan(tiles=tiles, k_chunks=-(-c // _CHUNK), grid=min(tiles, sms), smem_bytes=smem)


def geglu_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 approximate: bool) -> torch.Tensor:
    """K5 on a Hopper card, its gradient the plain version's (``mirror_vjp``);
    the plain version on the CPU; raises for a card tensor the kernel does not
    take (bf16 only, C % 8 == 0, D % 64 == 0)."""
    if x.device.type == "cpu":
        return _torch_geglu(x, w, b, approximate)
    return mirror_vjp.apply(_geglu_launch, _torch_geglu, x, w, b, approximate)


def _geglu_launch(x, w, b, approximate):
    if not is_hopper(x):
        raise RuntimeError(f"geglu_kernel: kernel needs an sm_90 device, got {x.device}")
    c = x.shape[-1]
    d = w.shape[0] // 2
    m = x.numel() // c
    if tuple(w.shape) != (2 * d, c) or tuple(b.shape) != (2 * d,):
        raise ValueError(f"geglu_kernel: kernel needs w (2D, C) and b (2D,); got x "
                         f"{tuple(x.shape)} w {tuple(w.shape)} b {tuple(b.shape)}")
    p = plan(max(m, 1), c, d, sm_count(x.device))
    for name, t in dict(x=x, w=w, b=b).items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"geglu_kernel: {name} must be bfloat16, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu_kernel: {name} must be contiguous and 16-byte aligned on "
                             f"{x.device}")
    out = torch.empty((*x.shape[:-1], d), dtype=x.dtype, device=x.device)
    if m:
        KERNEL(ptr(x), ptr(w), ptr(b), ptr(out), m, c, d, int(not approximate), p.grid,
               p.smem_bytes, stream_of(x))
    return out


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``value * gelu(gate)`` with [value; gate] = x W + b: K5 where the JAX
    rule sends the shape to its kernel, else the plain version."""
    c = x.shape[-1]
    if use_kernel(x.numel() // c, c, w.shape[0], x.dtype):
        return geglu_kernel(x.contiguous(), w, b, approximate)
    return _torch_geglu(x, w, b, approximate)
