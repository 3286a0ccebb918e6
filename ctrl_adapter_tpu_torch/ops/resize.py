"""Resize / pooling over the two trailing (H, W) axes of NC...HW tensors.

Counterpart of the functions of ``ctrl_adapter_tpu/ops/resize.py`` that the
ported paths use: the 64x64 ControlNet latent bridge (``adaptive_avg_pool2d``),
the adapter's nearest upsample to an arbitrary size (``nearest_resize``), and
SVD's CLIP image preprocessing (``antialiased_resize`` over
``bicubic_resize_align_corners``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def _cubic_weights(n_in: int, n_out: int, a: float = -0.75) -> Optional[np.ndarray]:
    """Torch ``interpolate(mode='bicubic', align_corners=True)`` weight matrix
    (n_out, n_in), indices clamped at the borders; None for an unchanged size."""
    if n_in == n_out:
        return None
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        w[:, 0] = 1.0
        return w
    for i in range(n_out):
        pos = i * (n_in - 1) / (n_out - 1)
        base = int(np.floor(pos))
        t = pos - base
        for k in range(-1, 3):
            d = abs(t - k)
            if d <= 1.0:
                wk = (a + 2) * d**3 - (a + 3) * d**2 + 1
            elif d < 2.0:
                wk = a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a
            else:
                wk = 0.0
            w[i, min(max(base + k, 0), n_in - 1)] += wk
    return w


def bicubic_resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize with torch's ``align_corners=True`` weights, as two
    products with the weight matrices (H first, then W)."""
    wh = _cubic_weights(x.shape[-2], out_hw[0])
    ww = _cubic_weights(x.shape[-1], out_hw[1])
    if wh is not None:
        x = torch.einsum("oh,...hw->...ow", torch.from_numpy(wh).to(x), x)
    if ww is not None:
        x = torch.einsum("ow,...hw->...ho", torch.from_numpy(ww).to(x), x)
    return x


def _gaussian_1d(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return g / g.sum()


def _blur_axis(x: torch.Tensor, k: int, sigma: float, axis: int) -> torch.Tensor:
    """Correlate ``x`` along ``axis`` (-1 or -2) with a normalised gaussian of
    ``k`` taps, reflect-padded."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, 1, *x.shape[-2:])
    pad = (k // 2, k // 2, 0, 0) if axis == -1 else (0, 0, k // 2, k // 2)
    flat = F.pad(flat, pad, mode="reflect")
    kern = torch.from_numpy(_gaussian_1d(k, sigma)).to(x)
    n = flat.shape[axis] - k + 1
    out = 0.0
    for j in range(k):
        out = out + kern[j] * flat.narrow(axis, j, n)
    return out.reshape(*lead, *out.shape[-2:])


def antialiased_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Gaussian-prefiltered bicubic downscale (the reference SVD preprocessing,
    ``utils/utils_svd.py:_resize_with_antialiasing``): sigma = max((factor - 1)
    / 2, 1e-3) per axis, an odd kernel of about 4 sigma (at least 3 taps),
    reflect padding, blurred along x first, then
    ``bicubic_resize_align_corners``."""
    h, w = x.shape[-2], x.shape[-1]
    factors = (h / out_hw[0], w / out_hw[1])
    sigmas = [max((f - 1.0) / 2.0, 0.001) for f in factors]
    ks = [int(max(2.0 * 2 * s, 3)) for s in sigmas]
    ks = [k + 1 if k % 2 == 0 else k for k in ks]
    x = _blur_axis(x, ks[1], sigmas[1], -1)
    x = _blur_axis(x, ks[0], sigmas[0], -2)
    return bicubic_resize_align_corners(x, out_hw)
