"""GroupNorm (+ fused SiLU) over NC(F)HW tensors: kernel K1 and its plain version.

Counterpart of ``ctrl_adapter_tpu/ops/group_norm.py:group_norm_silu``. The CUDA
kernel (``csrc/group_norm.cu``) is a two-pass reduction plus one elementwise
pass; see its header for the design. CUDA rather than Triton: the kernel shares
the single ``nvcc`` build of the other two kernels, so the port needs no second
toolchain at run time.

:func:`group_norm_silu` launches the kernel for a bf16 tensor on a Hopper card
(the only dtype the main path gives it, as on the TPU), raises for any other
tensor on a card, and runs :func:`_torch_group_norm_silu` only for a tensor on
the CPU. The plain
version has the math of ``_xla_group_norm_silu``: fp32 channel sums, group
variance E[x^2] - E[x]^2 clamped at 0.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, ptr, stream_of
from .backend import is_hopper

KERNEL = Kernel("cak_group_norm_silu", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    s = x[0, 0].numel()
    groups, span = n * num_groups, cg * s
    vec = s % _VEC == 0 and x.data_ptr() % 16 == 0
    splits, chunk = _split(groups, span, _VEC if vec else 1)
    y = torch.empty_like(x)
    partial = torch.empty(2 * groups * splits, dtype=torch.float32, device=x.device)
    KERNEL(ptr(x), ptr(weight), ptr(bias), ptr(y), ptr(partial), groups, cg, s,
           num_groups, splits, chunk, float(eps), int(silu), int(vec), stream_of(x))
    return y
