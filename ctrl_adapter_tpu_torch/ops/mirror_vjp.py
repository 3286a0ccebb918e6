"""Gradients of kernels K1, K3 (hybrid and full), K4 and K5: their plain version's.

In the JAX package these kernels are ``jax.custom_vjp``s whose backward is the
VJP of their XLA mirror (``ops/group_norm.py:256-275``,
``ops/fused_temporal.py:378-396``, ``ops/fused_block.py:228-244``,
``ops/fused_ff.py:128-140``): the TPU has no backward kernel for them. :func:`apply`
is the port of that pattern. Where grad is on and an input asks for it, the call
goes through :class:`MirrorVJP`, whose forward launches the kernel and saves its
tensor inputs only; its backward runs the plain version on them under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. Under
``torch.no_grad()`` (serving) the kernel runs alone and nothing is saved.
"""

from __future__ import annotations

from typing import Callable

import torch


def _flatten(args):
    """(tensors, rebuild): the tensors among ``args`` (directly or inside a
    tuple) in order, and a function that puts a list of tensors back in their
    places; every other argument stays as it is."""
    tensors, spec = [], []
    for a in args:
        if torch.is_tensor(a):
            spec.append(("tensor", len(tensors)))
            tensors.append(a)
        elif isinstance(a, tuple) and a and all(torch.is_tensor(t) for t in a):
            spec.append(("tuple", range(len(tensors), len(tensors) + len(a))))
            tensors.extend(a)
        else:
            spec.append(("const", a))

    def rebuild(ts):
        return [ts[v] if kind == "tensor" else tuple(ts[i] for i in v) if kind == "tuple" else v
                for kind, v in spec]

    return tensors, rebuild


class MirrorVJP(torch.autograd.Function):
    """``kernel(*args)`` forward; the VJP of ``plain(*args)`` backward."""

    @staticmethod
    def forward(ctx, kernel, plain, rebuild, *tensors):
        ctx.plain, ctx.rebuild = plain, rebuild
        ctx.save_for_backward(*tensors)
        return kernel(*rebuild(tensors))

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.plain(*ctx.rebuild(inputs))
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, need) if n], grad,
                                         allow_unused=True))
        return (None, None, None, *(next(grads) if n else None for n in need))


def apply(kernel: Callable, plain: Callable, *args):
    """``kernel(*args)``, differentiable through ``plain(*args)`` where grad is on
    and a tensor argument requires it."""
    tensors, rebuild = _flatten(args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return MirrorVJP.apply(kernel, plain, rebuild, *tensors)
    return kernel(*args)
