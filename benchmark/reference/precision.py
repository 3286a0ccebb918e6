"""The control of the check: the reference computed in fp8 (e4m3), the
precision below the configurations' bf16.

As the program in bf16 rounds every tensor it stores to bf16, the control
rounds to fp8 every weight of a linear or convolution layer, every input
those layers receive, and every output of those layers and of the
normalisations (e4m3, one scale per tensor: its largest magnitude maps to
448), and in a backward every gradient that flows back through those points
(e5m2, largest magnitude 57344), as fp8 training does; the arithmetic inside
a layer stays float32. That is what a change that moved the towers to fp8
storage and fp8 products would compute.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .resnet import GroupNorm

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
LAYERS = (nn.Linear, nn.Conv2d, nn.Conv3d)
NORMS = (nn.LayerNorm, GroupNorm)


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / scale).clamp(-top, top).to(dtype).float() * scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with a per-tensor scale, returned in its dtype; its
    gradient rounded to e5m2 the same way."""
    return _FP8.apply(x)


def _quantize_input(module, args):
    """The layer's weight (again where an optimizer step has moved it, so
    that a recomputed forward leaves it untouched) and its input."""
    with torch.no_grad():
        rounded = to_fp8(module.weight)
        if not torch.equal(rounded, module.weight):
            module.weight.copy_(rounded)
    return (to_fp8(args[0]),) + tuple(args[1:])


def _quantize_output(_module, _args, out):
    return to_fp8(out)


@torch.no_grad()
def fp8(module: nn.Module) -> list:
    """Turn ``module``'s layers to fp8 in place; returns the hook handles."""
    handles = []
    for layer in module.modules():
        if isinstance(layer, LAYERS):
            handles.append(layer.register_forward_pre_hook(_quantize_input))
        if isinstance(layer, LAYERS + NORMS):
            handles.append(layer.register_forward_hook(_quantize_output))
    return handles


def fp8_towers(towers) -> list:
    """``fp8`` over every tower of a reference's namespace."""
    return [h for module in vars(towers).values() for h in fp8(module)]
