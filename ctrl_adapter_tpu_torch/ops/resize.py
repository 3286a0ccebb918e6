"""Resize / pooling over the two trailing (H, W) axes of NC...HW tensors.

Counterpart of the functions of ``ctrl_adapter_tpu/ops/resize.py`` that the
ported paths use: the 64x64 ControlNet latent bridge (``adaptive_avg_pool2d``),
the adapter's nearest upsample to an arbitrary size (``nearest_resize``),
SVD's CLIP image preprocessing (``antialiased_resize`` over
``bicubic_resize_align_corners``), and the condition extractors' resizes:
``bilinear_resize`` and ``bicubic_resize`` (``jax.image.resize``'s rules),
``bilinear_resize_align_corners``, and ``cv2_resize`` (``utils/image.py:resize``
on the tensor's device).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.image import resize_weights


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


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (torch and cv2 use -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def _scale_weights(n_in: int, n_out: int, kernel: str) -> np.ndarray:
    """``jax.image.resize``'s weight matrix (n_out, n_in) in float64
    (``jax._src.image.scale.compute_weight_mat``, antialiased, no translation):
    half-pixel sample points, the kernel widened by in/out when shrinking, each
    row's weights divided by their sum (near the borders too, where torch and
    cv2 clamp the index instead). Read-only: the cache hands it to every
    caller."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / kernel_scale
    w = {"linear": _triangle, "cubic": _keys_cubic}[kernel](x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[:, None], w, 0.0)
    w.setflags(write=False)
    return w


def _jax_resize(x: torch.Tensor, out_hw: Tuple[int, int], kernel: str) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    if out_hw[0] != h:
        wh = torch.tensor(_scale_weights(h, out_hw[0], kernel), dtype=x.dtype, device=x.device)
        x = torch.einsum("oh,...hw->...ow", wh, x)
    if out_hw[1] != w:
        ww = torch.tensor(_scale_weights(w, out_hw[1], kernel), dtype=x.dtype, device=x.device)
        x = torch.einsum("ow,...hw->...ho", ww, x)
    return x


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="bilinear")`` over the two trailing axes:
    half-pixel centres, antialiased when shrinking (not ``F.interpolate``)."""
    return _jax_resize(x, out_hw, "linear")


def bicubic_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="cubic")`` over the two trailing axes: Keys'
    cubic (a = -0.5), antialiased when shrinking, weights renormalised at the
    borders."""
    return _jax_resize(x, out_hw, "cubic")


def bilinear_resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with torch's ``align_corners=True`` source positions
    (``i * (in - 1) / (out - 1)``), H then W, in the float32 arithmetic of the
    JAX function (``ctrl_adapter_tpu/ops/resize.py``)."""

    def interp_axis(arr: torch.Tensor, out: int, axis: int) -> torch.Tensor:
        n = arr.shape[axis]
        if n == out:
            return arr
        if out == 1 or n == 1:
            return arr.index_select(axis, torch.zeros(out, dtype=torch.long, device=arr.device))
        pos = torch.arange(out, dtype=torch.float32, device=arr.device) * (n - 1) / (out - 1)
        lo = torch.floor(pos).long().clamp(0, n - 2)
        w = (pos - lo.float()).to(arr.dtype)
        shape = [1] * arr.ndim
        shape[axis] = out
        w = w.reshape(shape)
        return arr.index_select(axis, lo) * (1 - w) + arr.index_select(axis, lo + 1) * w

    x = interp_axis(x, out_hw[0], x.ndim - 2)
    return interp_axis(x, out_hw[1], x.ndim - 1)


def apply_taps(x: torch.Tensor, weights: np.ndarray, axis: int) -> torch.Tensor:
    """The (n_out, n_in) ``weights`` applied along ``axis`` of ``x``: each
    row's nonzero taps gathered, multiplied and summed in ``x``'s dtype. No
    matrix product, so float64 and int64 stay elementwise work on the card
    (where a float64 product of these shapes ran as thousands of slow
    launches)."""
    nz = weights != 0
    k = max(int(nz.sum(axis=1).max()), 1)
    n_out = weights.shape[0]
    idx = np.zeros((n_out, k), np.int64)
    w = np.zeros((n_out, k), weights.dtype)
    for o in range(n_out):
        cols = np.flatnonzero(nz[o])
        idx[o, :len(cols)] = cols
        w[o, :len(cols)] = weights[o, cols]
    axis %= x.ndim
    g = x.index_select(axis, torch.from_numpy(idx.reshape(-1)).to(x.device))
    g = g.unflatten(axis, (n_out, k))
    shape = [1] * g.ndim
    shape[axis], shape[axis + 1] = n_out, k
    return (g * torch.from_numpy(w).to(x.device, x.dtype).reshape(shape)).sum(axis + 1)


def cv2_resize(x: torch.Tensor, out_hw: Tuple[int, int], interpolation: str = "cubic"
               ) -> torch.Tensor:
    """``utils/image.py:resize`` (cv2's weights, float64, H then W) over the two
    trailing axes of ``x`` on its device: uint8 in, rounded uint8 out; a float
    tensor keeps its dtype."""
    h, w = x.shape[-2:]
    y = x.to(torch.float64)
    if out_hw[0] != h:
        y = apply_taps(y, resize_weights(h, out_hw[0], interpolation), -2)
    if out_hw[1] != w:
        y = apply_taps(y, resize_weights(w, out_hw[1], interpolation), -1)
    if x.dtype == torch.uint8:
        return torch.round(y).clamp(0, 255).to(torch.uint8)
    return y.to(x.dtype)
