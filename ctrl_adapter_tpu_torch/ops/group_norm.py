"""GroupNorm (+ fused SiLU) over NC(F)HW tensors: kernel K1 and its plain version.

Counterpart of ``ctrl_adapter_tpu/ops/group_norm.py:group_norm_silu``. The CUDA
kernel (``csrc/group_norm.cu``) reads x once where a group fits in shared memory
(one launch: a group a CTA, several small groups a CTA, or a group over a
thread-block cluster) and keeps a two-pass reduction for the rest; see its
header for the design. :func:`plan` picks the branch, the CTAs and the shared
memory in plain Python, so the CPU tests check it; the C side refuses a plan
that differs from the one it derives. The plan counts bytes of the input's
type: bf16 and fp32 run the same branches, fp32 with 4 elements a 16-byte
vector where bf16 has 8. CUDA rather than Triton: the kernel
shares the single ``nvcc`` build of the other kernels, so the port needs no
second toolchain at run time.

:func:`group_norm_silu` launches the kernel for a bf16 or fp32 tensor on a
Hopper card (bf16 on the main path; fp32 towers under ``--mixed_precision no``,
which JAX's rule admits at itemsize 4), raises for any other tensor on a card,
and runs :func:`_torch_group_norm_silu` only for a tensor on the CPU. Under grad its gradient is the plain version's (``mirror_vjp``, the
port of the JAX custom VJP). The plain version has the math of
``_xla_group_norm_silu``: fp32 channel sums, group variance E[x^2] - E[x]^2
clamped at 0.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from functools import lru_cache
from math import prod

import torch

from . import mirror_vjp
from ._build import Kernel, ptr, stream_of
from .backend import is_hopper, sm_count

KERNEL = Kernel("cak_group_norm_silu", [
    *([ctypes.c_void_p] * 5), *([ctypes.c_int64] * 3), *([ctypes.c_int] * 4),
    *([ctypes.c_int64] * 3), ctypes.c_float, *([ctypes.c_int] * 3), ctypes.c_void_p,
])
# fp32 input launches the same entry, counted apart: K1 fp32 (fp32 towers)
KERNEL_FP32 = Kernel(KERNEL.symbol, KERNEL.argtypes)
DTYPES = (torch.bfloat16, torch.float32)  # the types the kernel takes

# The TPU's VMEM rules of ``_eligible`` and ``_pick_chunk``, kept so that both
# packages send the same norms to their kernels.
_VMEM_BLOCK_BUDGET = 12 * 1024 * 1024  # bytes, against 4 * S * C * itemsize
_CHUNK_F32_BYTES = 1024 * 1024

_TARGET_BLOCKS = 2048   # enough CTAs to fill 132 SMs several times over
_MIN_CHUNK = 8192       # elements per CTA and split, so each split does real work
_MAX_SPLITS = 64
_VEC_BYTES = 16         # one vector load: 8 bf16 or 4 fp32 elements


def _torch_group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    n, c = x.shape[0], x.shape[1]
    cg = c // num_groups
    xf = x.float().reshape(n, c, -1)
    count = xf.shape[-1] * cg
    g_sum = xf.sum(-1).reshape(n, num_groups, cg).sum(-1)
    g_sq = (xf * xf).sum(-1).reshape(n, num_groups, cg).sum(-1)
    g_mean = g_sum / count
    g_var = g_sq / count - g_mean * g_mean
    g_rstd = torch.rsqrt(g_var.clamp_min(0.0) + eps)
    mean_c = g_mean.repeat_interleave(cg, dim=-1)[..., None]
    rstd_c = g_rstd.repeat_interleave(cg, dim=-1)[..., None]
    y = (xf - mean_c) * rstd_c * weight.float()[:, None] + bias.float()[:, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _pick_chunk(s: int, c: int) -> int:
    """Largest power-of-two divisor of s whose fp32 (chunk, c) block fits 1 MiB."""
    chunk = 1
    while chunk < s and s % (chunk * 2) == 0 and (chunk * 2) * c * 4 <= _CHUNK_F32_BYTES:
        chunk *= 2
    return chunk


def eligible(shape, num_groups: int, itemsize: int) -> bool:
    """The JAX shape rule (``ops/group_norm.py:_eligible``) for an (N, C,
    *spatial) tensor, without its device test: C divisible by the groups, at
    least 8 positions, and 4 * S * C * itemsize within 12 MiB."""
    if len(shape) < 2:
        return False
    c, s = shape[1], prod(shape[2:])
    return (c % num_groups == 0 and s >= 8 and s % _pick_chunk(s, c) == 0
            and 4 * s * c * itemsize <= _VMEM_BLOCK_BUDGET)


def use_kernel(flag, shape, num_groups: int, itemsize: int) -> bool:
    """Whether a norm goes to :func:`group_norm_silu` (K1 on a card): JAX's
    ``use_pallas`` rule. ``flag`` None follows ``CTRL_ADAPTER_FUSED_GN=1``
    (read per call); "prefer" takes the kernel; False never. The shape must
    pass :func:`eligible` in every case."""
    if flag is False or (flag is None and os.environ.get("CTRL_ADAPTER_FUSED_GN") != "1"):
        return False
    return eligible(shape, num_groups, itemsize)


def _split(groups: int, span: int, vec_width: int):
    splits = min(_MAX_SPLITS, -(-_TARGET_BLOCKS // groups), max(1, span // _MIN_CHUNK))
    splits = max(1, splits)
    chunk = -(-span // splits)
    chunk = -(-chunk // vec_width) * vec_width
    return -(-span // chunk), chunk


BRANCHES = ("two_pass", "one_cta", "several_groups", "cluster")
_PIECE = 16384          # bytes per bulk copy (and mbarrier) of the one-launch branches
_MAX_PIECES = 16
_CTA_BYTES = 96 * 1024  # x bytes a CTA holds by preference: two CTAs an SM
_CTA_MAX = 200 * 1024   # ... and at most (a cluster of 8 over a group of up to 1.6 MB)
_PACK_BYTES = 32 * 1024  # several groups a CTA: at most this many bytes in all
_MAX_PACK = 8
_AUX = 2 * 8 * _MAX_PACK + 8 * _MAX_PIECES  # per-group sums and statistics, mbarriers
_MAX_SPAN = 1 << 22     # one launch: float channel indexing is exact below 2^22 vectors


def _fused_smem(elems: int, s: int, itemsize: int = 2) -> int:
    """x, the per-group sums and mbarriers, and (mean, gamma * rstd, beta) of
    each channel the CTA touches (16 bytes each)."""
    return itemsize * elems + _AUX + 16 * (elems // s + 2)


@dataclass(frozen=True)
class GroupNormPlan:
    branch: str          # one of BRANCHES
    cluster: int         # CTAs per group (a thread-block cluster when > 1)
    groups_per_cta: int
    elems: int           # elements a CTA holds ("two_pass": per split)
    grid: int            # CTAs ("two_pass": splits per group)
    smem_bytes: int      # dynamic shared memory (0 for "two_pass")
    vec: bool            # 16-byte loads


@lru_cache(maxsize=None)
def plan(shape: tuple, num_groups: int, aligned: bool = True, sms: int = 132,
         itemsize: int = 2) -> GroupNormPlan:
    """K1's launch for an (N, C, *spatial) tensor of ``itemsize`` bytes an
    element (2: bf16, 4: fp32) on a card of ``sms`` SMs; sizes below are bytes.

    One launch where the spatial size is a multiple of a 16-byte vector
    (8 bf16, 4 fp32 elements) and ``aligned`` (a 16-byte aligned base):
    - "several_groups": groups of at most 16 KB, packed 2, 4 or 8 to a CTA
      (at most 32 KB) while at least 2 * sms CTAs remain;
    - else "one_cta" / "cluster": the fewest CTAs per group (1, 2, 4, 8) such
      that each holds at most 96 KB and the grid has at least ``sms`` CTAs;
      a group of more than 8 x 200 KB falls to "two_pass".
    "two_pass" otherwise: ``_split``'s chunks, two launches. ``csrc/group_norm.cu``
    refuses any other plan."""
    n, c = shape[0], shape[1]
    s = prod(shape[2:])
    groups, span = n * num_groups, (c // num_groups) * s
    vec = _VEC_BYTES // itemsize
    gbytes = itemsize * span
    if s % vec or not aligned or span > _MAX_SPAN:
        return _two_pass(groups, span, vec if s % vec == 0 and aligned else 1, vec)
    gpc = 1
    while (gpc < _MAX_PACK and groups % (2 * gpc) == 0 and 2 * gpc * gbytes <= _PACK_BYTES
           and groups // (2 * gpc) >= 2 * sms):
        gpc *= 2
    if gpc > 1:
        return GroupNormPlan("several_groups", 1, gpc, gpc * span, groups // gpc,
                             _fused_smem(gpc * span, s, itemsize), True)
    cl = 1
    while (cl < 8 and (gbytes > _CTA_BYTES * cl or groups * cl < sms)
           and span % (2 * cl * vec) == 0):
        cl *= 2
    elems = span // cl
    cta_bytes = itemsize * elems
    if span % (cl * vec) or cta_bytes > _CTA_MAX or -(-cta_bytes // _PIECE) > _MAX_PIECES:
        return _two_pass(groups, span, vec, vec)
    return GroupNormPlan("one_cta" if cl == 1 else "cluster", cl, 1, elems, groups * cl,
                         _fused_smem(elems, s, itemsize), True)


def _two_pass(groups: int, span: int, vec_width: int, vec: int) -> GroupNormPlan:
    splits, chunk = _split(groups, span, vec_width)
    return GroupNormPlan("two_pass", 1, 1, chunk, splits, 0, vec_width == vec)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-6,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm of ``x`` (N, C, *spatial) with per-sample statistics over C/G
    contiguous channels and all spatial positions, then the affine step and an
    optional SiLU. Kernel K1 on a Hopper card for bf16 or fp32 (weight and
    bias in x's type), its gradient the plain version's (``mirror_vjp``); the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return _torch_group_norm_silu(x, weight, bias, num_groups, eps, silu)
    return mirror_vjp.apply(_group_norm_kernel, _torch_group_norm_silu, x, weight, bias,
                            num_groups, eps, silu)


def _group_norm_kernel(x, weight, bias, num_groups, eps, silu):
    if not is_hopper(x):
        raise RuntimeError(f"group_norm_silu: kernel needs an sm_90 device, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"group_norm_silu: x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() < 3 or x.shape[1] % num_groups:
        raise ValueError(f"group_norm_silu: bad shape {tuple(x.shape)} for {num_groups} groups")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm_silu: {name} must be a contiguous ({c},) "
                             f"{x.dtype} tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous")
    n = x.shape[0]
    cg = c // num_groups
    s = prod(x.shape[2:])
    p = plan(tuple(x.shape), num_groups, x.data_ptr() % 16 == 0, sm_count(x.device),
             x.element_size())
    y = torch.empty_like(x)
    partial = (torch.empty(2 * n * num_groups * p.grid, dtype=torch.float32, device=x.device)
               if p.branch == "two_pass" else None)
    kernel = KERNEL_FP32 if x.dtype == torch.float32 else KERNEL
    kernel(ptr(x), ptr(weight), ptr(bias), ptr(y), None if partial is None else ptr(partial),
           n * num_groups, cg, s, num_groups, BRANCHES.index(p.branch), p.cluster,
           p.groups_per_cta, p.elems, p.grid, p.smem_bytes, float(eps), int(silu), int(p.vec),
           x.element_size(), stream_of(x))
    return y

