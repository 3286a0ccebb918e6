"""GroupNorm (+ fused SiLU) over NC(F)HW tensors: kernel K1 and its plain version.

Counterpart of ``ctrl_adapter_tpu/ops/group_norm.py:group_norm_silu``. The CUDA
kernel (``csrc/group_norm.cu``) reads x once where a group fits in shared memory
(one launch: a group a CTA, several small groups a CTA, or a group over a
thread-block cluster) and keeps a two-pass reduction for the rest; see its
header for the design. :func:`plan` picks the branch, the CTAs and the shared
memory in plain Python, so the CPU tests check it; the C side refuses a plan
that differs from the one it derives. CUDA rather than Triton: the kernel
shares the single ``nvcc`` build of the other kernels, so the port needs no
second toolchain at run time.

:func:`group_norm_silu` launches the kernel for a bf16 tensor on a Hopper card
(the only dtype the main path gives it, as on the TPU), raises for any other
tensor on a card, and runs :func:`_torch_group_norm_silu` only for a tensor on
the CPU. The plain
version has the math of ``_xla_group_norm_silu``: fp32 channel sums, group
variance E[x^2] - E[x]^2 clamped at 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from math import prod

import torch

from ._build import Kernel, ptr, stream_of
from .backend import is_hopper, sm_count

KERNEL = Kernel("cak_group_norm_silu", [
    *([ctypes.c_void_p] * 5), *([ctypes.c_int64] * 3), *([ctypes.c_int] * 4),
    *([ctypes.c_int64] * 3), ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
])

_TARGET_BLOCKS = 2048   # enough CTAs to fill 132 SMs several times over
_MIN_CHUNK = 8192       # elements per CTA and split, so each split does real work
_MAX_SPLITS = 64
_VEC = 8                # bf16 elements per 16-byte load


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


def _fused_smem(elems: int, s: int) -> int:
    """x, the per-group sums and mbarriers, and (mean, gamma * rstd, beta) of
    each channel the CTA touches (16 bytes each)."""
    return 2 * elems + _AUX + 16 * (elems // s + 2)


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
def plan(shape: tuple, num_groups: int, aligned: bool = True, sms: int = 132) -> GroupNormPlan:
    """K1's launch for a bf16 (N, C, *spatial) tensor on a card of ``sms`` SMs.

    One launch where the spatial size is a multiple of 8 and ``aligned`` (a
    16-byte aligned base):
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
    gbytes = 2 * span
    if s % _VEC or not aligned or span > _MAX_SPAN:
        return _two_pass(groups, span, _VEC if s % _VEC == 0 and aligned else 1)
    gpc = 1
    while (gpc < _MAX_PACK and groups % (2 * gpc) == 0 and 2 * gpc * gbytes <= _PACK_BYTES
           and groups // (2 * gpc) >= 2 * sms):
        gpc *= 2
    if gpc > 1:
        return GroupNormPlan("several_groups", 1, gpc, gpc * span, groups // gpc,
                             _fused_smem(gpc * span, s), True)
    cl = 1
    while (cl < 8 and (gbytes > _CTA_BYTES * cl or groups * cl < sms)
           and span % (2 * cl * _VEC) == 0):
        cl *= 2
    elems = span // cl
    if span % (cl * _VEC) or 2 * elems > _CTA_MAX or -(-2 * elems // _PIECE) > _MAX_PIECES:
        return _two_pass(groups, span, _VEC)
    return GroupNormPlan("one_cta" if cl == 1 else "cluster", cl, 1, elems, groups * cl,
                         _fused_smem(elems, s), True)


def _two_pass(groups: int, span: int, vec_width: int) -> GroupNormPlan:
    splits, chunk = _split(groups, span, vec_width)
    return GroupNormPlan("two_pass", 1, 1, chunk, splits, 0, vec_width == _VEC)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-6,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm of ``x`` (N, C, *spatial) with per-sample statistics over C/G
    contiguous channels and all spatial positions, then the affine step and an
    optional SiLU. Kernel K1 on a Hopper card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return _torch_group_norm_silu(x, weight, bias, num_groups, eps, silu)
    if not is_hopper(x):
        raise RuntimeError(f"group_norm_silu: kernel needs an sm_90 device, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_silu: x must be bfloat16, got {x.dtype}")
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
    p = plan(tuple(x.shape), num_groups, x.data_ptr() % 16 == 0, sm_count(x.device))
    y = torch.empty_like(x)
    partial = (torch.empty(2 * n * num_groups * p.grid, dtype=torch.float32, device=x.device)
               if p.branch == "two_pass" else None)
    KERNEL(ptr(x), ptr(weight), ptr(bias), ptr(y), None if partial is None else ptr(partial),
           n * num_groups, cg, s, num_groups, BRANCHES.index(p.branch), p.cluster,
           p.groups_per_cta, p.elems, p.grid, p.smem_bytes, float(eps), int(silu), int(p.vec),
           stream_of(x))
    return y

