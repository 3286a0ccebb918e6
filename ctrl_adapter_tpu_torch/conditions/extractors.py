"""Condition extraction: depth, canny, segmentation and shuffle, on the device.

Counterpart of ``ctrl_adapter_tpu/conditions/extractors.py`` for the types
ported so far; normal, softedge, lineart, openpose and scribble raise
``NotImplementedError`` (``NOT_PORTED``). Every map is (h, w, 3) uint8 RGB of
the frame's size.

- canny: ``cv2.Canny(image, 100, 200)`` on the RGB frame, in integer torch:
  3x3 Sobel with replicated borders per channel; per pixel the channel of the
  largest ``|dx| + |dy|`` (the first on a tie); non-maximum suppression with
  cv2's fixed-point tan 22.5 degrees test (``TG22 = 13573`` at 15 bits) and
  its comparisons (strict on one side, ``>=`` on the other, across a zero
  border); then hysteresis: the 8-connected components of the candidates
  above ``low`` that hold a pixel above ``high``.
- shuffle: the smooth noise field of the JAX function (numpy's generator of
  the seed, a cubic upsample by ``utils/image.resize`` in place of cv2's) and
  OpenCV 4's ``cv2.remap(INTER_LINEAR)`` arithmetic: the source coordinate
  rounded to 1/32 of a pixel, 15-bit weights, a constant-0 border (OpenCV 5
  samples at the float coordinate instead).
- depth: ``DepthDPT`` (a transformers ``Intel/dpt-large`` folder:
  ``config.json``, ``preprocessor_config.json``, ``model.safetensors``) or
  ``DepthDPTSwin`` (a MiDaS ``.pt``); segmentation: ``SegmentationSegformer``
  (a transformers SegFormer folder), its argmax coloured with the ADE palette.
  The networks run in fp32. The JAX package falls back to transformers'
  torch models when its own cannot load a path; the port has no fallback, so
  such a path raises with its reason.

``ConditionExtractor`` picks the estimators as the JAX class does and runs
them on its device: the card unless the caller names another.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.release import load_release
from ..ops.backend import resolve_device
from ..ops.resize import bicubic_resize, bilinear_resize
from ..utils.image import resize
from .dpt import DPTForDepthEstimation
from .dpt import PROCESSOR_DEFAULTS as DPT_PROCESSOR
from .dpt import config_from_json as dpt_config
from .dpt_swin import DepthDPTSwin
from .palette import ADE_PALETTE
from .processor import ImageProcessor
from .segformer import PROCESSOR_DEFAULTS as SEGFORMER_PROCESSOR
from .segformer import SegformerForSemanticSegmentation
from .segformer import config_from_json as segformer_config

CONTROL_TYPES = (
    "depth", "canny", "normal", "segmentation", "softedge", "lineart", "openpose",
    "scribble",
)

# reference expert order for multi-condition checkpoints (`inference.py:314-345`)
MULTI_CONDITION_EXPERT_ORDER = (
    "depth", "canny", "normal", "softedge", "segmentation", "lineart", "openpose",
)

PORTED_TYPES = ("depth", "canny", "segmentation", "shuffle")
NOT_PORTED = ("extraction of {!r} is not ported yet: its network (HED, PiDiNet, lineart, "
              "NormalBAE or OpenPose) comes with ROADMAP Queue 1 item 5; pass pre-extracted "
              "condition frames")

DEFAULT_PATHS = {"depth": "Intel/dpt-large",
                 "segmentation": "nvidia/segformer-b5-finetuned-ade-640-640"}

_TG22 = 13573  # round(tan(22.5 degrees) * 2**15), cv2's canny.cpp
_CANNY_SHIFT = 15


def check_control_types(types: Sequence[str]) -> None:
    """Raise before any work for a type the port cannot extract:
    ``NotImplementedError`` for the types of ``NOT_PORTED``, ``ValueError``
    for an unknown one."""
    for ctype in types:
        if ctype in PORTED_TYPES:
            continue
        if ctype in CONTROL_TYPES:
            raise NotImplementedError(NOT_PORTED.format(ctype))
        raise ValueError(f"unknown control type: {ctype}")


def _replicate_pad(x: torch.Tensor) -> torch.Tensor:
    """(..., h, w) -> (..., h + 2, w + 2), the border replicated (any dtype)."""
    h, w = x.shape[-2:]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def canny_edges(images: torch.Tensor, low: int = 100, high: int = 200,
                check_every: int = 8) -> torch.Tensor:
    """``cv2.Canny`` (L1 gradient, aperture 3) of (n, h, w, 3) uint8 RGB frames
    -> (n, h, w) uint8 in {0, 255} (see the module docstring)."""
    x = _replicate_pad(images.permute(0, 3, 1, 2).to(torch.int32))  # (n, 3, h+2, w+2)
    h, w = images.shape[1:3]
    dx = ((x[..., 0:h, 2:] - x[..., 0:h, :w]) + 2 * (x[..., 1:h + 1, 2:] - x[..., 1:h + 1, :w])
          + (x[..., 2:, 2:] - x[..., 2:, :w]))
    dy = ((x[..., 2:, 0:w] - x[..., :h, 0:w]) + 2 * (x[..., 2:, 1:w + 1] - x[..., :h, 1:w + 1])
          + (x[..., 2:, 2:] - x[..., :h, 2:]))
    mag = dx.abs() + dy.abs()
    best = mag.argmax(dim=1, keepdim=True)  # the first channel on a tie, as cv2
    mag, dx, dy = (t.gather(1, best)[:, 0] for t in (mag, dx, dy))

    m = F.pad(mag, (1, 1, 1, 1))  # cv2's magnitude rows and columns beyond the image are 0
    left, right = m[:, 1:-1, :-2], m[:, 1:-1, 2:]
    up, down = m[:, :-2, 1:-1], m[:, 2:, 1:-1]
    ax, ay = dx.abs(), dy.abs() << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_CANNY_SHIFT + 1))
    same_sign = (dx ^ dy) >= 0
    diag_p = torch.where(same_sign, m[:, :-2, :-2], m[:, :-2, 2:])  # row above: j - s
    diag_n = torch.where(same_sign, m[:, 2:, 2:], m[:, 2:, :-2])    # row below: j + s
    keep = torch.where(ay < tg22x, (mag > left) & (mag >= right),
                       torch.where(ay > tg67x, (mag > up) & (mag >= down),
                                   (mag > diag_p) & (mag > diag_n)))
    cand = (keep & (mag > low)).float()[:, None]
    edges = cand * (mag > high).float()[:, None]
    while True:  # hysteresis: grow the strong pixels through 8-connected candidates
        before = edges
        for _ in range(check_every):
            edges = F.max_pool2d(edges, 3, 1, 1) * cand
        if torch.equal(edges, before):
            break
    return (edges[:, 0] * 255).to(torch.uint8)


def _as_batches(fn: Callable[[np.ndarray], List[np.ndarray]], images: Sequence[np.ndarray]
                ) -> List[np.ndarray]:
    """``fn`` over one stacked batch when the frames share a shape, else frame
    by frame."""
    images = [np.asarray(im) for im in images]
    if len({im.shape for im in images}) == 1:
        return fn(np.stack(images))
    return [fn(im[None])[0] for im in images]


def extract_canny(image: np.ndarray, low: int = 100, high: int = 200,
                  device="cpu") -> np.ndarray:
    """Canny edges at the reference thresholds: (h, w, 3) uint8 RGB -> the edge
    map in 3 channels, computed on ``device``."""
    edges = canny_edges(torch.from_numpy(np.asarray(image)[None]).to(device), low, high)
    return np.repeat(edges[0].cpu().numpy()[:, :, None], 3, axis=2)


def _smooth_noise_field(h: int, w: int, grid: int, rng: np.random.Generator) -> np.ndarray:
    """Low-frequency noise in [0, 1]: a coarse uniform grid, cubic upsampled."""
    coarse = rng.uniform(size=((h // grid) + 2, (w // grid) + 2)).astype(np.float32)
    up = resize(coarse, (h + 2 * grid, w + 2 * grid), "cubic")
    field = up[grid: grid + h, grid: grid + w]
    field -= field.min()
    field /= max(field.max(), 1e-8)
    return field


def remap_linear(image: torch.Tensor, src_x: torch.Tensor, src_y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(image, map, None, INTER_LINEAR)`` of an (h, w, c) uint8 image
    at float32 source coordinates (h', w'): the coordinates rounded to 1/32 of
    a pixel (half to even), weights (32 - f)(32 - g) * 32 and so on out of
    2^15, rounded; neighbours outside the image read 0."""
    h, w = image.shape[:2]
    sx, sy = (torch.round(s.float() * 32).to(torch.int32) for s in (src_x, src_y))
    ix, iy, fx, fy = sx >> 5, sy >> 5, sx & 31, sy & 31
    img = image.to(torch.int32)
    out = torch.full((*sx.shape, image.shape[2]), 1 << 14, dtype=torch.int32,
                     device=image.device)
    for oy, wy in ((0, 32 - fy), (1, fy)):
        for ox, wx in ((0, 32 - fx), (1, fx)):
            yy, xx = iy + oy, ix + ox
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            pix = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)] * inside[..., None]
            out += pix * (wy * wx * 32)[..., None]
    return (out >> 15).clamp(0, 255).to(torch.uint8)


def extract_shuffle(image: np.ndarray, grid: int = 256, seed: Optional[int] = None,
                    device="cpu") -> np.ndarray:
    """Content shuffle: each output pixel resampled from a smoothly varying
    random source location (numpy's ``default_rng(seed)``, as the JAX
    function). (h, w, 3) uint8 RGB in and out."""
    h, w = image.shape[:2]
    rng = np.random.default_rng(seed)
    src_x = _smooth_noise_field(h, w, grid, rng) * float(w - 1)
    src_y = _smooth_noise_field(h, w, grid, rng) * float(h - 1)
    out = remap_linear(torch.from_numpy(np.ascontiguousarray(image)).to(device),
                       torch.from_numpy(src_x.astype(np.float32)).to(device),
                       torch.from_numpy(src_y.astype(np.float32)).to(device))
    return out.cpu().numpy()


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as fh:
        return json.load(fh)


class DepthDPT:
    """Depth maps from a transformers DPT folder, fp32 on ``device``: the
    network, ``bicubic_resize`` back to the frame's size, per frame min-max
    normalised, uint8 (truncated) gray in three channels."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu")):
        self.device = torch.device(device)
        self.processor = ImageProcessor.from_pretrained(model_path, DPT_PROCESSOR)
        self.model = DPTForDepthEstimation(dpt_config(_read_config(model_path)),
                                           device=self.device).eval().requires_grad_(False)
        load_release(self.model, model_path)

    @torch.no_grad()
    def __call__(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        depth = self.model(self.processor(images, self.device))
        out = []
        for d, img in zip(depth, images):
            d = bicubic_resize(d[None], img.shape[:2])[0].cpu().numpy()
            span = float(d.max() - d.min())
            d = (d - d.min()) / span if span > 0 else np.zeros_like(d)
            out.append(np.repeat((d * 255.0).astype(np.uint8)[:, :, None], 3, axis=2))
        return out


class SegmentationSegformer:
    """ADE segmentation maps from a transformers SegFormer folder, fp32 on
    ``device``: the logits ``bilinear_resize``d to the frame's size, their
    argmax coloured with the ADE palette."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu")):
        self.device = torch.device(device)
        self.processor = ImageProcessor.from_pretrained(model_path, SEGFORMER_PROCESSOR)
        self.model = SegformerForSemanticSegmentation(
            segformer_config(_read_config(model_path)), device=self.device
        ).eval().requires_grad_(False)
        load_release(self.model, model_path)
        self.palette = torch.from_numpy(ADE_PALETTE).to(self.device)

    @torch.no_grad()
    def __call__(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        logits = self.model(self.processor(images, self.device))
        out = []
        for lg, img in zip(logits, images):
            seg = bilinear_resize(lg, img.shape[:2]).argmax(dim=0)
            out.append(self.palette[seg % len(ADE_PALETTE)].cpu().numpy())
        return out


_LOAD_ERRORS = (FileNotFoundError, OSError, KeyError, ValueError, RuntimeError)


class ConditionExtractor:
    """The estimators of ``ControlNetHelper.add_*_estimator``, made on first use
    and run on ``device`` (the card unless the caller names another).
    ``local_model_paths`` maps a type to its checkpoint (``DEFAULT_PATHS``
    otherwise: the JAX defaults, read as folders relative to the working
    directory; nothing is downloaded)."""

    def __init__(self, local_model_paths: Optional[Dict[str, str]] = None, device=None):
        self._paths = dict(local_model_paths or {})
        self._estimators: Dict[str, Callable] = {}
        self._lock = threading.Lock()  # prefetch workers share one extractor
        self.device = resolve_device(device)

    def _load(self, control_type: str, make: Callable, path: str):
        try:
            return make(path, device=self.device)
        except _LOAD_ERRORS as e:
            raise RuntimeError(
                f"{control_type}: {path!r} loads in neither of the port's networks "
                f"({type(e).__name__}: {e}); the port has no transformers fallback") from e

    def add_estimator(self, control_type: str) -> None:
        with self._lock:
            if control_type not in self._estimators:
                check_control_types([control_type])
                self._estimators[control_type] = self._make(control_type)

    def _make(self, control_type: str) -> Callable:
        dev = self.device
        if control_type == "canny":
            return lambda imgs: _as_batches(
                lambda b: [np.repeat(e[:, :, None], 3, axis=2) for e in
                           canny_edges(torch.from_numpy(b).to(dev)).cpu().numpy()], imgs)
        if control_type == "shuffle":
            return lambda imgs: [extract_shuffle(im, seed=i, device=dev)
                                 for i, im in enumerate(imgs)]
        path = str(self._paths.get(control_type, DEFAULT_PATHS[control_type]))
        if control_type == "segmentation":
            return self._load(control_type, SegmentationSegformer, path)
        if path.endswith((".pt", ".pth")):  # a MiDaS checkpoint (dpt_swin2_large_384)
            return self._load(control_type, DepthDPTSwin, path)
        return self._load(control_type, DepthDPT, path)

    def extract(self, control_type: str, images: List[np.ndarray]) -> List[np.ndarray]:
        """images: list of (h, w, 3) uint8 RGB -> same-size condition maps."""
        self.add_estimator(control_type)
        return self._estimators[control_type](images)
