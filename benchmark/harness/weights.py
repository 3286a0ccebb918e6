"""Random weights drawn on the device from a seed, in a few large calls.

The program's towers and the reference's get the same values: parameters are
taken in the order of their sorted names, drawn in groups of at most
``GROUP`` elements as one standard normal each, scaled, and rounded to the
served type (the reference keeps that rounding and computes in float32).
"""

from __future__ import annotations

import torch

GROUP = 1 << 28  # elements per draw: 1 GiB of float32


@torch.no_grad()
def fill(module: torch.nn.Module, gen: torch.Generator, scale: float,
         served: torch.dtype) -> int:
    """Fill every parameter of ``module`` from ``gen``; returns the count."""
    params = sorted(module.named_parameters(), key=lambda kv: kv[0])
    groups, cur, size = [], [], 0
    for _, p in params:
        if cur and size + p.numel() > GROUP:
            groups.append(cur)
            cur, size = [], 0
        cur.append(p)
        size += p.numel()
    if cur:
        groups.append(cur)
    device = params[0][1].device
    for group in groups:
        flat = torch.randn(sum(p.numel() for p in group), generator=gen, device=device)
        flat = (flat * scale).to(served)
        offset = 0
        for p in group:
            p.copy_(flat[offset:offset + p.numel()].view(p.shape))
            offset += p.numel()
        del flat
    return sum(p.numel() for _, p in params)
