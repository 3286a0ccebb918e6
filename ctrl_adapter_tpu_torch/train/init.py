"""Flax's default initialisers for a fresh adapter and router, from an explicit generator.

The JAX CLI builds its trainable tree with ``adapter.init(PRNGKey(0), ...)``
(``train.py:280-303``) under flax's defaults, and this module gives each
tensor the same distribution (the values cannot equal JAX's threefry draws):

- the kernel of every ``nn.Dense`` and ``nn.Conv``: ``lecun_normal``, a normal
  truncated at two standard deviations and rescaled so that its std is
  1/sqrt(fan_in), with fan_in the input width, or kh*kw*c_in (kd*kh*kw*c_in)
  for a convolution, as flax's ``variance_scaling`` reckons it
  (``ctrl_adapter_tpu/nn/attention.py:178``);
- biases zero, norm scales one (``nn/resnet.py:43-44``, ``nn/attention.py:239-241``);
- an ``AlphaBlender``'s ``mix_factor`` its constant ``alpha`` (``nn/resnet.py:301``);
- the adapter's ``zero_convs`` zero (``models/adapter.py:408``);
- the router's gates under the router's own init
  (``ControlNetRouter.reset_parameters``), drawn from the same generator.

PyTorch's own defaults differ: ``kaiming_uniform(a=sqrt(5))`` has a third of
lecun_normal's variance, and its biases are not zero. The draws are fp32 and
become the trainer's masters (``init_trainable``); the module, bf16 on the
card, holds their cast.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..models.router import ControlNetRouter
from ..nn.resnet import AlphaBlender, GroupNorm

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling constant)
TRUNCATED_STD = 0.87962566103423978
_NORMS = (GroupNorm, nn.GroupNorm, nn.LayerNorm)
_PROJECTIONS = (nn.Linear, nn.modules.conv._ConvNd)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` for a torch weight of ``shape`` ((out, in) or
    (out, in, *kernel)): fp32 on the generator's device."""
    std = math.prod(shape[1:]) ** -0.5 / TRUNCATED_STD
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))  # noqa: E731
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(2 * cdf(-2.0) - 1, 2 * cdf(2.0) - 1, generator=generator)
    return u.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def adapter_state(adapter: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """{parameter name: fp32 draw} of ``adapter`` under flax's defaults, drawn
    in ``named_modules`` order; a parameter of a module no rule covers raises."""
    zero = {id(m) for m in (getattr(adapter, "zero_convs", None) or ())}
    dev = generator.device
    state = {}
    for mname, module in adapter.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            bias = pname == "bias" and isinstance(module, _PROJECTIONS + _NORMS)
            if id(module) in zero or bias:
                state[name] = torch.zeros(shape, device=dev)
            elif isinstance(module, _PROJECTIONS) and pname == "weight":
                state[name] = lecun_normal(shape, generator)
            elif isinstance(module, _NORMS) and pname == "weight":
                state[name] = torch.ones(shape, device=dev)
            elif isinstance(module, AlphaBlender) and pname == "mix_factor":
                state[name] = torch.full(shape, float(module.alpha), device=dev)
            else:
                raise TypeError(f"no flax init rule for {name} of {type(module).__name__}")
    return state


def router_state(router: ControlNetRouter, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """{parameter name: fp32 draw} of the router's gates, redrawn in place
    from ``generator`` by the router's own init."""
    router.reset_parameters(generator)
    return {name: p.detach().float() for name, p in router.named_parameters()}


def init_trainable(trainer, generator: torch.Generator) -> None:
    """Draw the trainer's adapter (and router) under these rules into its fp32
    masters, and the modules' weights as their cast."""
    router: Optional[ControlNetRouter] = trainer.router
    trainer.load_masters(adapter_state(trainer.adapter, generator),
                         None if router is None else router_state(router, generator))
