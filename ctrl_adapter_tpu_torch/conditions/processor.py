"""The image preprocessing of the DPT and SegFormer checkpoints, without
transformers or PIL.

Counterpart of what ``transformers.DPTImageProcessor`` and
``SegformerImageProcessor`` (``AutoImageProcessor``) do to a list of uint8 RGB
frames for the JAX extractors (``ctrl_adapter_tpu/conditions/extractors.py``):
read ``preprocessor_config.json`` over the processor's own defaults, then per
frame

1. resize (``do_resize``) to ``size``, through PIL's resampling (``resample``
   2, bilinear, or 3, bicubic with a = -0.5; both antialiased: the kernel is
   widened by in/out when shrinking) in PIL's fixed-point arithmetic on uint8:
   22-bit weights, the horizontal pass rounded to uint8 before the vertical
   one. DPT's ``keep_aspect_ratio`` and ``ensure_multiple_of`` pick the size
   as its processor does;
2. rescale (``do_rescale``, ``rescale_factor``) in float64, cast to float32;
3. normalise (``do_normalize``, ``image_mean``, ``image_std``) in float32.

It all runs on the device the caller names, step 1 in int64
(``ops/resize.py:apply_taps``), exactly as Pillow's integer sums.

Every key of the file is either one of these, one that concerns labels or
names the class only, or a padding switch left off; any other key, or a value
it does not implement, raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import apply_taps

# keys that name the class or concern segmentation labels, never the image
_INERT_KEYS = frozenset({"image_processor_type", "feature_extractor_type", "processor_class",
                         "do_reduce_labels", "reduce_labels"})
_PIL_BITS = 22  # Pillow's PRECISION_BITS for 8-bit images


def _pil_bilinear(x: np.ndarray) -> np.ndarray:
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


# PIL.Image.Resampling value: (support, filter)
_PIL_FILTERS = {2: (1.0, _pil_bilinear), 3: (2.0, _pil_bicubic)}


def _pil_weights(n_in: int, n_out: int, resample: int) -> np.ndarray:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` as a dense
    (n_out, n_in) matrix of the fixed-point (22-bit) integer weights."""
    support, fn = _PIL_FILTERS[resample]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support *= filterscale
    weights = np.zeros((n_out, n_in), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = fn(np.abs((np.arange(xmax) + xmin - center + 0.5) / filterscale))
        total = k.sum()
        if total != 0.0:
            k = k / total
        weights[xx, xmin: xmin + xmax] = np.trunc(k * (1 << _PIL_BITS)
                                                  + np.where(k < 0, -0.5, 0.5))
    return weights


def _pil_pass(x: torch.Tensor, n_out: int, resample: int, axis: int) -> torch.Tensor:
    """One of Pillow's passes along ``axis`` (-3: rows, -2: columns) of
    (..., h, w, c) int64 pixel values: the integer sums, 2^21 added, shifted
    right by 22 bits and clipped to [0, 255]."""
    acc = apply_taps(x, _pil_weights(x.shape[axis], n_out, resample), axis)
    return ((acc + (1 << (_PIL_BITS - 1))) >> _PIL_BITS).clamp(0, 255)


def pil_resize(image: torch.Tensor, out_hw: Tuple[int, int], resample: int) -> torch.Tensor:
    """``np.asarray(PIL.Image.fromarray(image).resize((w, h), resample))`` for
    (..., h, w, c) uint8 images on any device and ``resample`` 2 (bilinear) or
    3 (bicubic)."""
    if resample not in _PIL_FILTERS:
        raise ValueError(f"resample={resample}: only PIL's bilinear (2) and bicubic (3) are "
                         f"implemented")
    x = image.to(torch.int64)
    if out_hw[1] != image.shape[-2]:  # PIL resamples horizontally first
        x = _pil_pass(x, out_hw[1], resample, axis=-2)
    if out_hw[0] != image.shape[-3]:
        x = _pil_pass(x, out_hw[0], resample, axis=-3)
    return x.to(torch.uint8)


def _constrain_to_multiple_of(val: float, multiple: int) -> int:
    return int(round(val / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ImageProcessor:
    """One checkpoint's preprocessing (see the module docstring)."""

    size: Tuple[int, int]
    resample: int
    image_mean: Tuple[float, ...]
    image_std: Tuple[float, ...]
    do_resize: bool = True
    do_rescale: bool = True
    rescale_factor: float = 1 / 255
    do_normalize: bool = True
    keep_aspect_ratio: bool = False
    ensure_multiple_of: int = 1

    @classmethod
    def from_pretrained(cls, path: str, defaults: Dict[str, object]) -> "ImageProcessor":
        """``{path}/preprocessor_config.json`` over ``defaults`` (the
        processor class's own defaults)."""
        with open(os.path.join(path, "preprocessor_config.json")) as fh:
            cfg = json.load(fh)
        values = dict(defaults)
        fields = {f.name for f in dataclasses.fields(cls)}
        for key, value in cfg.items():
            if key in _INERT_KEYS:
                continue
            if key in ("do_pad", "size_divisor") and not cfg.get("do_pad", False):
                continue
            if key not in fields:
                raise ValueError(f"{path}/preprocessor_config.json: key {key!r}={value!r} is "
                                 f"not implemented")
            values[key] = value
        size = values["size"]
        if isinstance(size, int):
            size = (size, size)
        elif isinstance(size, dict) and set(size) == {"height", "width"}:
            size = (size["height"], size["width"])
        else:
            raise ValueError(f"{path}: size {size!r} is not implemented (an int or "
                             f"{{'height', 'width'}})")
        values["size"] = tuple(int(s) for s in size)
        for key in ("image_mean", "image_std"):
            v = values[key]
            values[key] = tuple(float(t) for t in (v if isinstance(v, (list, tuple)) else [v] * 3))
        proc = cls(**values)
        if proc.do_resize and proc.resample not in _PIL_FILTERS:
            raise ValueError(f"{path}: resample={proc.resample} is not implemented (2 or 3)")
        return proc

    def output_size(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        """DPT's ``get_resize_output_image_size`` (the plain target size when
        ``keep_aspect_ratio`` is off and ``ensure_multiple_of`` is 1)."""
        (h, w), (th, tw) = hw, self.size
        sh, sw = th / h, tw / w
        if self.keep_aspect_ratio:
            if abs(1 - sw) < abs(1 - sh):
                sh = sw
            else:
                sw = sh
        return (_constrain_to_multiple_of(sh * h, self.ensure_multiple_of),
                _constrain_to_multiple_of(sw * w, self.ensure_multiple_of))

    def __call__(self, images: Sequence[np.ndarray], device=torch.device("cpu")
                 ) -> torch.Tensor:
        """(h, w, 3) uint8 RGB frames -> (n, 3, H, W) float32 pixel values on
        ``device``."""
        out: List[torch.Tensor] = []
        for img in images:
            x = np.asarray(img)
            if x.dtype != np.uint8 or x.ndim != 3 or x.shape[2] != 3:
                raise ValueError(f"expected (h, w, 3) uint8 frames, got {x.dtype} {x.shape}")
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            if self.do_resize:
                x = pil_resize(x, self.output_size(tuple(x.shape[:2])), self.resample)
            x = x.to(torch.float32)
            if self.do_rescale:
                x = (x.to(torch.float64) * self.rescale_factor).to(torch.float32)
            if self.do_normalize:
                mean, std = (torch.tensor(v, dtype=torch.float32, device=device)
                             for v in (self.image_mean, self.image_std))
                x = (x - mean) / std
            out.append(x.permute(2, 0, 1))
        return torch.stack(out)
