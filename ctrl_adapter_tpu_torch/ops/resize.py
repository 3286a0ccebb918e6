"""Resize / pooling over the two trailing (H, W) axes of NC...HW tensors.

Counterpart of the two functions of ``ctrl_adapter_tpu/ops/resize.py`` that the
SVD path uses: the 64x64 ControlNet latent bridge (``adaptive_avg_pool2d``) and
the adapter's nearest upsample to an arbitrary size (``nearest_resize``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize with the index rule ``src = floor(dst * in / out)``
    in integer arithmetic (exact for every size)."""
    h, w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    if (out_h, out_w) == (h, w):
        return x
    rows = torch.arange(out_h, device=x.device) * h // out_h
    cols = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(-2, rows).index_select(-1, cols)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool; a reshape-mean when the sizes divide (the case the
    pipelines use), torch's bin rule otherwise (the JAX general case is the same
    rule)."""
    h, w = x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    if (h, w) == (out_h, out_w):
        return x
    if h % out_h == 0 and w % out_w == 0:
        lead = x.shape[:-2]
        x = x.reshape(*lead, out_h, h // out_h, out_w, w // out_w)
        return x.mean(dim=(-3, -1))
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
