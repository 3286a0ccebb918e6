"""LayerNorm -> GEGLU feed-forward (+ residual) on (..., C) rows: kernel K4.

Counterpart of ``ctrl_adapter_tpu/ops/fused_block.py``:

    out = [x +] W2 (value * gelu(gate)) + b2,   [value; gate] = LN(x) Wg + bg

with fp32 LN statistics. :func:`ln_ff_residual` is what the blocks call
(``BasicTransformerBlock``'s FF, the temporal module path's two FFs). It
dispatches on the JAX rule (``ops/fused_block.py:216-217``): the kernel runs
iff ``CTRL_ADAPTER_FUSED_BLOCK=1`` (read per call), the activations are bf16,
gelu is the tanh form (``approximate``; ``CTRL_ADAPTER_EXACT_GELU=1`` makes
the blocks ask for erf), ``_tiles`` takes the shape, C <= 320 and there are
at least 4096 rows; otherwise the plain version runs. :func:`ln_ff_kernel` is
the kernel's wrapper: the plain version for a CPU tensor, the kernel
(``csrc/ln_ff.cu``, launched with :func:`plan`) or an error for a card tensor.

Weights are in torch ``nn.Linear`` layout: ``wg`` (2*inner, C) = [value rows;
gate rows], ``w2`` (C_out, inner).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import Kernel, ptr, stream_of
from .backend import SMEM_PER_BLOCK, is_hopper

KERNEL = Kernel("cak_ln_ff", [
    *([ctypes.c_void_p] * 8), ctypes.c_int64, *([ctypes.c_int] * 5), ctypes.c_float,
    *([ctypes.c_int] * 3), ctypes.c_void_p,
])

_ACC_VMEM_BUDGET = 10 * 1024 * 1024  # the TPU's VMEM rule, kept so both packages pick alike
_MAX_WIDTH = 320     # kernel: C and C_out multiples of 64 up to this (the 64 x C_out fp32
                     # accumulator of a consumer warpgroup lives in registers)
_INNER_CHUNK = 64    # kernel: the inner width streams in steps of 64
_TILE_ROWS = 128     # rows per CTA: two consumer warpgroups of 64
_MAX_DEPTH = 4       # ring slots at most (the kernel's 8 mbarriers)


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics (two-pass variance, clamped at 0)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _torch_ln_ff_residual(x: torch.Tensor, ln_w, ln_b, wg, bg, w2, b2, eps: float,
                          approximate: bool, residual: bool) -> torch.Tensor:
    """Plain version of K4 (the math of ``_xla_ln_ff_residual``)."""
    a = F.linear(_ln(x, ln_w, ln_b, eps), wg, bg)
    value, gate = a.chunk(2, dim=-1)
    h = value * F.gelu(gate, approximate="tanh" if approximate else "none")
    out = F.linear(h, w2, b2)
    return out + x if residual else out


def _tiles(m: int, c: int, inner: int, itemsize: int) -> Optional[tuple]:
    """The JAX tiling rule (``ops/fused_block.py:_tiles``), a pure function of
    shapes: (TM, TN) or None where the TPU kernel does not take the shape."""
    tm = 256
    while tm > 8 and m % tm:
        tm //= 2
    if m % tm:
        return None
    tn = None
    for cand in range(inner, 127, -128):
        if inner % cand == 0 and 3 * cand * c * itemsize <= 4 * 1024 * 1024:
            tn = cand
            break
    if tn is None:
        return None
    if tm * c * 4 + tm * tn * 4 + tm * c * 2 * itemsize > _ACC_VMEM_BUDGET:
        return None
    return tm, tn


def use_kernel(m: int, c: int, inner: int, dtype: torch.dtype, approximate: bool) -> bool:
    """The JAX dispatch rule of ``ln_ff_residual`` without its device test."""
    return (os.environ.get("CTRL_ADAPTER_FUSED_BLOCK") == "1" and dtype == torch.bfloat16
            and _tiles(m, c, inner, 2) is not None and approximate and c <= 320 and m >= 4096)


@dataclass(frozen=True)
class Plan:
    tile_rows: int     # rows per CTA
    grid: int          # CTAs: ceil(m / tile_rows)
    slot_bytes: int    # a ring slot: one Wg tile (64 rows x C) or one W2 tile (C_out x 64)
    depth: int         # ring slots
    smem_bytes: int


def plan(m: int, c: int, inner: int, cout: int, residual: bool) -> Plan:
    """The launch of K4: one CTA per 128-row tile; shared memory for the A tile
    (128 x C bf16), as many ring slots of 128 * max(C, C_out) bytes as fit the
    block's shared memory (at most 4, at least 2), 11 mbarriers and 1 KiB of
    alignment slack. ``csrc/ln_ff.cu`` refuses any other plan."""
    if (m < 1 or c < 64 or c % 64 or c > _MAX_WIDTH or cout < 64 or cout % 64
            or cout > _MAX_WIDTH or inner < _INNER_CHUNK or inner % _INNER_CHUNK
            or (residual and cout != c)):
        raise ValueError(f"ln_ff_kernel: kernel needs C and C_out multiples of 64 up to "
                         f"{_MAX_WIDTH}, inner % {_INNER_CHUNK} == 0 and C_out == C with the "
                         f"residual; got C={c} inner={inner} C_out={cout} residual={residual}")
    slot = 128 * max(c, cout)
    fixed = 2 * _TILE_ROWS * c + 16 * _MAX_DEPTH + 24 + 1024
    depth = min(_MAX_DEPTH, (SMEM_PER_BLOCK - fixed) // slot)
    assert depth >= 2
    return Plan(tile_rows=_TILE_ROWS, grid=-(-m // _TILE_ROWS), slot_bytes=slot, depth=depth,
                smem_bytes=fixed + depth * slot)


def ln_ff_kernel(x: torch.Tensor, ln_w, ln_b, wg, bg, w2, b2, eps: float, approximate: bool,
                 residual: bool) -> torch.Tensor:
    """K4 on a Hopper card, the plain version on the CPU; raises for a card
    tensor the kernel does not take."""
    if x.device.type == "cpu":
        return _torch_ln_ff_residual(x, ln_w, ln_b, wg, bg, w2, b2, eps, approximate, residual)
    if not is_hopper(x):
        raise RuntimeError(f"ln_ff_kernel: kernel needs an sm_90 device, got {x.device}")
    c = x.shape[-1]
    inner = w2.shape[1]
    cout = w2.shape[0]
    m = x.numel() // c
    p = plan(max(m, 1), c, inner, cout, residual)
    expect = {"ln_w": (c,), "ln_b": (c,), "wg": (2 * inner, c), "bg": (2 * inner,),
              "w2": (cout, inner), "b2": (cout,)}
    tensors = dict(x=x, ln_w=ln_w, ln_b=ln_b, wg=wg, bg=bg, w2=w2, b2=b2)
    for name, t in tensors.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"ln_ff_kernel: {name} shape {tuple(t.shape)}, expected {expect[name]}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ln_ff_kernel: {name} must be bfloat16, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_ff_kernel: {name} must be contiguous and 16-byte aligned on "
                             f"{x.device}")
    out = torch.empty((*x.shape[:-1], cout), dtype=x.dtype, device=x.device)
    if m:
        KERNEL(ptr(x), ptr(ln_w), ptr(ln_b), ptr(wg), ptr(bg), ptr(w2), ptr(b2), ptr(out), m, c,
               inner, cout, int(residual), int(not approximate), float(eps), p.grid, p.depth,
               p.smem_bytes, stream_of(x))
    return out


def ln_ff_residual(x: torch.Tensor, ln_w, ln_b, wg, bg, w2, b2, eps: float, approximate: bool,
                   residual: bool) -> torch.Tensor:
    """``[x +] W2 (value * gelu(gate)) + b2`` with [value; gate] = LN(x) Wg + bg:
    K4 where the JAX rule sends the shape to its kernel, else the plain version."""
    c = x.shape[-1]
    if use_kernel(x.numel() // c, c, w2.shape[1], x.dtype, approximate):
        return ln_ff_kernel(x.contiguous(), ln_w, ln_b, wg, bg, w2, b2, eps, approximate, residual)
    return _torch_ln_ff_residual(x, ln_w, ln_b, wg, bg, w2, b2, eps, approximate, residual)
