"""The cv2 calls of the HED, OpenPose and scribble extractors, without cv2.

The JAX package calls ``cv2.GaussianBlur``, ``cv2.dilate``, ``cv2.resize``,
``cv2.addWeighted``, ``cv2.ellipse2Poly``, ``cv2.fillConvexPoly`` and
``cv2.circle`` (``conditions/hed.py``, ``conditions/openpose.py``); the card's
host has no cv2. Each function here reproduces OpenCV 5.0's own arithmetic
(held against ``cv2`` 5.0.0 in ``tests/test_torch_imgproc.py``); the filters
and resizes take tensors on any device, the rasterisers paint a tensor
canvas from spans worked out on the host.

- ``gaussian_blur``: ``cv2.GaussianBlur(x, (0, 0), sigma)`` with
  ``BORDER_REFLECT_101``. uint8 runs OpenCV's bit-exact fixed-point path:
  ``cvRound(sigma * 6 + 1) | 1`` taps quantised to 8 fractional bits by error
  diffusion, integer row and column sums, the result rounded half up. float32
  takes ``cvRound(sigma * 8 + 1) | 1`` float taps; rows are summed tap by tap
  and columns as symmetric pairs, each step a fused multiply-add, except in
  the last ``w % 4`` (rows) and ``w % 8`` (columns) columns, which OpenCV's x86
  build leaves to scalar code that rounds the product and the sum apart
  (equal to cv2's but for an ulp at a few of those pixels).
- ``dilate``: a 3x3 structuring element, the border the value that never wins.
- the cubic resizes (``cv2.resize(..., INTER_CUBIC)``) are
  ``ops/resize.py:resize_cubic``, which MiDaS and the host image I/O share.
- ``add_weighted``: ``cv2.addWeighted`` on uint8: float32 ``a alpha + b beta +
  gamma`` (fused), rounded half to even, saturated.
- ``ellipse2poly``, ``fill_convex_poly``, ``circle``: OpenCV's integer
  rasterisation (``LINE_8``, shift 0): its 1-degree sine table, ``cvRound``
  and duplicate points dropped; the polygon's outline drawn with 8-connected
  Bresenham lines (clipped as ``cv::clipLine``) and its scanlines filled in
  16.16 fixed point; the filled circle's spans from its midpoint loop.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import cv_round

# OpenCV's SinTable (drawing.cpp): sin(i degrees), i = 0..450, written to 7
# decimals as float literals
SIN_TABLE = np.array([round(math.sin(math.radians(i)), 7) for i in range(451)], np.float32)

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


# ------------------------------------------------------- the extractors' I/O

def edge_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(..., h, w) -> (..., h + ph, w + pw): the last row and column
    repeated (``np.pad(mode="edge")`` at the bottom and right)."""
    if not (ph or pw):
        return x
    h, w = x.shape[-2:]
    rows = torch.arange(h + ph, device=x.device).clamp(max=h - 1)
    cols = torch.arange(w + pw, device=x.device).clamp(max=w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def as_batches(fn: Callable[[np.ndarray], List[np.ndarray]], images: Sequence[np.ndarray]
               ) -> List[np.ndarray]:
    """``fn`` over one stacked batch when the frames share a shape, else frame
    by frame: the networks treat each frame alone, so both give the same
    maps."""
    images = [np.asarray(im) for im in images]
    if len({im.shape for im in images}) == 1:
        return fn(np.stack(images))
    return [fn(im[None])[0] for im in images]


def gray_maps(unit: torch.Tensor) -> List[np.ndarray]:
    """(n, h, w) in [0, 1] -> n (h, w, 3) uint8 maps: ``(x 255).clip(0, 255)``
    truncated, in three channels."""
    u8 = (unit * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
    return [np.repeat(m[:, :, None], 3, axis=2) for m in u8]


# ------------------------------------------------------------------ gaussian
def gaussian_ksize(sigma: float, dtype: torch.dtype) -> int:
    """The taps ``cv2.GaussianBlur`` picks for ``ksize = (0, 0)``."""
    return cv_round(sigma * (3 if dtype == torch.uint8 else 4) * 2 + 1) | 1


def gaussian_kernel(n: int, sigma: float) -> List[float]:
    """``getGaussianKernelBitExact``: exp(-x^2 / (2 sigma^2)) over the odd
    ``n`` taps, each divided by their sum (the centre tap 1 / sum)."""
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale2) for x in range(1 - n, -1, 2)][:half]
    total = 2.0 * sum(values) + 1.0
    inv = 1.0 / total
    out = [0.0] * n
    for i, v in enumerate(values):
        out[i] = out[n - 1 - i] = v * inv
    out[half] = inv
    return out


def gaussian_kernel_fixed(n: int, sigma: float, bits: int = 8) -> List[int]:
    """``getGaussianKernelFixedPoint_ED``: the taps in ``bits`` fractional
    bits, rounded with the error carried from tap to tap, the centre tap
    what makes them sum to one."""
    taps = gaussian_kernel(n, sigma)
    one = 1 << bits
    out, err, total = [0] * n, 0.0, 0
    for i in range(n // 2):
        adj = taps[i] * one + err
        v = cv_round(adj)
        err = adj - v
        out[i] = out[n - 1 - i] = v
        total += v
    out[n // 2] = one - 2 * total
    return out


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of ``-pad .. n + pad - 1`` under ``BORDER_REFLECT_101``."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return torch.zeros(len(idx), dtype=torch.long, device=device)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return torch.from_numpy(np.where(idx >= n, period - idx, idx)).to(device)


def _fma(a: torch.Tensor, k: float, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, k, acc)``: the product exact in float64, one rounding."""
    return (a.double() * k + acc.double()).float()


def _mac(acc: torch.Tensor, a: torch.Tensor, k: float, fused: int) -> torch.Tensor:
    """``acc + a k`` in float32, fused over the first ``fused`` columns and
    rounded twice (product, sum) over the rest."""
    if fused == acc.shape[-1]:
        return _fma(a, k, acc)
    return torch.cat([_fma(a[..., :fused], k, acc[..., :fused]),
                      acc[..., fused:] + a[..., fused:] * k], dim=-1)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` over the two trailing axes of a
    uint8 or float32 tensor (see the module docstring); same dtype out."""
    h, w = x.shape[-2:]
    n = gaussian_ksize(sigma, x.dtype)
    pad = n // 2
    rows, cols = _reflect101(h, pad, x.device), _reflect101(w, pad, x.device)
    if x.dtype == torch.uint8:
        taps = gaussian_kernel_fixed(n, sigma)
        src = x.to(torch.int32).index_select(-1, cols)
        r = sum(k * src[..., j:j + w] for j, k in enumerate(taps) if k)
        r = r.index_select(-2, rows)
        c = sum(k * r[..., j:j + h, :] for j, k in enumerate(taps) if k)
        return ((c + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)
    if x.dtype != torch.float32:
        raise TypeError(f"gaussian_blur takes uint8 or float32, not {x.dtype}")
    taps = [float(np.float32(k)) for k in gaussian_kernel(n, sigma)]
    src = x.index_select(-1, cols)
    s = src[..., 0:w] * taps[0]
    for j in range(1, n):
        s = _mac(s, src[..., j:j + w], taps[j], w - w % 4)
    s = s.index_select(-2, rows)
    t = s[..., pad:pad + h, :] * taps[pad]
    for j in range(1, pad + 1):
        pair = s[..., pad - j:pad - j + h, :] + s[..., pad + j:pad + j + h, :]
        t = _mac(t, pair, taps[pad + j], w - w % 8)
    return t


# -------------------------------------------------------------------- dilate
def dilate(x: torch.Tensor, kernel: Sequence[Sequence[int]]) -> torch.Tensor:
    """``cv2.dilate(x, kernel)`` for a 3x3 0/1 ``kernel`` anchored at its
    centre over the two trailing axes; outside the image is the dtype's
    lowest value, which never wins."""
    h, w = x.shape[-2:]
    low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    padded = torch.full((*x.shape[:-2], h + 2, w + 2), low, dtype=x.dtype, device=x.device)
    padded[..., 1:-1, 1:-1] = x
    out = None
    for i in range(3):
        for j in range(3):
            if kernel[i][j]:
                tap = padded[..., i:i + h, j:j + w]
                out = tap if out is None else torch.maximum(out, tap)
    return out


# -------------------------------------------------------------- add_weighted
def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` on uint8 tensors."""
    al, be, ga = (float(np.float32(v)) for v in (alpha, beta, gamma))
    t = (b.double() * be + ga).float()
    t = (a.double() * al + t.double()).float()
    return torch.round(t).clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------- rasterising
def ellipse2poly(center: Tuple[int, int], axes: Tuple[int, int], angle: int,
                 arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly`` (integer form): (n, 2) int64 points (x, y)."""
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    alpha, beta = float(SIN_TABLE[450 - a]), float(SIN_TABLE[a])
    pts: List[Tuple[int, int]] = []
    for i in range(arc_start, arc_end + delta, delta):
        t = min(i, arc_end)
        if t < 0:
            t += 360
        px = axes[0] * float(SIN_TABLE[450 - t])
        py = axes[1] * float(SIN_TABLE[t])
        pt = (cv_round(center[0] + px * alpha - py * beta),
              cv_round(center[1] + px * beta + py * alpha))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [tuple(center), tuple(center)]
    return np.array(pts, np.int64).reshape(-1, 2)


def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """``cv::clipLine`` on an image of w x h: moves the points onto its border
    in place; False when the line misses it."""
    if w <= 0 or h <= 0:
        return False
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y, full=True):
        c = (x < 0) + (x > right) * 2
        return c + ((y < 0) * 4 + (y > bottom) * 8 if full else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def _line8(w: int, h: int, pt1: Tuple[int, int], pt2: Tuple[int, int],
           out: List[Tuple[int, int]]) -> None:
    """The pixels ``cv::LineIterator(..., 8, leftToRight=true)`` visits,
    appended to ``out`` as (x, y)."""
    p1, p2 = list(pt1), list(pt2)
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not _clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sx = sy = 1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        p1 = p2
    if dy < 0:
        dy, sy = -dy, -1
    x, y = p1
    if dy > dx:  # steep: step along y, x when err < 0
        err, plus, minus = dy - 2 * dx, 2 * dy, -2 * dx
        for _ in range(dy + 1):
            out.append((x, y))
            step = err < 0
            err += minus + (plus if step else 0)
            y += sy
            x += sx if step else 0
    else:
        err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
        for _ in range(dx + 1):
            out.append((x, y))
            step = err < 0
            err += minus + (plus if step else 0)
            x += sx
            y += sy if step else 0


def _paint(img: torch.Tensor, pixels: List[Tuple[int, int]], color) -> None:
    if not pixels:
        return
    xy = torch.tensor(pixels, dtype=torch.long).to(img.device)
    img[xy[:, 1], xy[:, 0]] = torch.tensor(color, dtype=img.dtype).to(img.device)


def _hline(pixels: List[Tuple[int, int]], y: int, x1: int, x2: int) -> None:
    pixels.extend((x, y) for x in range(x1, x2 + 1))


def fill_convex_poly(img: torch.Tensor, pts: np.ndarray, color) -> torch.Tensor:
    """``cv2.fillConvexPoly(img, pts, color)`` (``LINE_8``, shift 0) on an
    (h, w, c) tensor, in place; returns ``img``."""
    h, w = img.shape[:2]
    v = [tuple(int(c) for c in p) for p in np.asarray(pts).reshape(-1, 2)]
    npts = len(v)
    pixels: List[Tuple[int, int]] = []
    delta1 = delta2 = _XY_ONE >> 1
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = min(range(npts), key=lambda i: (ys[i], i))  # the first lowest y
    p0 = v[-1]
    for p in v:  # the outline
        _line8(w, h, p0, p, pixels)
        p0 = p
    xmin, xmax, ymin, ymax = min(xs), max(xs), ys[imin], max(ys)
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        _paint(img, pixels, color)
        return img
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = v[idx][1]
                    if ty > y:
                        xs0 = v[idx0][0] << _XY_SHIFT
                        xe = v[idx][0] << _XY_SHIFT
                        e["ye"] = ty
                        num, den = (xe - xs0) * 2 + (ty - y), 2 * (ty - y)
                        e["dx"] = abs(num) // den * (1 if num >= 0 else -1)  # C's /
                        e["x"] = xs0
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + delta1) >> _XY_SHIFT
            x2 = (edge[right]["x"] + delta2) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(pixels, y, max(x1, 0), min(x2, w - 1))
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break
    _paint(img, pixels, color)
    return img


def circle(img: torch.Tensor, center: Tuple[int, int], radius: int, color) -> torch.Tensor:
    """``cv2.circle(img, center, radius, color, thickness=-1)`` (``LINE_8``,
    shift 0) on an (h, w, c) tensor, in place; returns ``img``."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    pixels: List[Tuple[int, int]] = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(pixels, yy, max(x11, 0), min(x12, w - 1))
            if x21 < w and x22 >= 0:
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(pixels, yy, max(x21, 0), min(x22, w - 1))
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    _paint(img, pixels, color)
    return img
