"""Expert fusion of ControlNet residuals (counterpart of part of
``ctrl_adapter_tpu/models/router.py``).

Only :func:`fuse_expert_residuals` is here, in its routerless (unweighted sum)
and weighted forms; ``ControlNetRouter`` and ``build_router_input`` come with
the I2VGen-XL slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def fuse_expert_residuals(down_per_expert: Sequence[Sequence[torch.Tensor]],
                          mid_per_expert: Optional[Sequence[torch.Tensor]],
                          down_weights: Optional[torch.Tensor] = None,
                          mid_weights: Optional[torch.Tensor] = None
                          ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Sum of the per-expert residuals, each scaled by its router weight:
    ``down_weights`` (K, E) for the K down slots, ``mid_weights`` (E,); None
    weights are 1 (the routerless path). The mid residual is fused when its
    weights are given or the down weights are not, else None, as in the JAX
    package (``models/router.py:147``)."""
    fused_down = []
    for k in range(len(down_per_expert[0])):
        acc = 0
        for e, down in enumerate(down_per_expert):
            r = down[k]
            acc = acc + (r if down_weights is None else r * down_weights[k, e].to(r.dtype))
        fused_down.append(acc)
    fused_mid = None
    if mid_per_expert is not None and (mid_weights is not None or down_weights is None):
        acc = 0
        for e, r in enumerate(mid_per_expert):
            acc = acc + (r if mid_weights is None else r * mid_weights[e].to(r.dtype))
        fused_mid = acc
    return fused_down, fused_mid
