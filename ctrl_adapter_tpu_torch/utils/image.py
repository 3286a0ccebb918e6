"""Host-side image I/O and resizes without cv2, imageio or PIL.

Counterpart of ``ctrl_adapter_tpu/utils/image.py`` (the reference's gif/png
writers, ``center_crop_and_resize`` and the [0, 1] convention) for a
host that has numpy, zlib and torch only:

- PNG: a decoder (8-bit gray, gray + alpha, RGB, RGBA and palette images; the
  five filter types; no interlace) and an encoder (RGB, RGBA or gray, filter
  "Up" on every row);
- GIF: an encoder (LZW, looping, a frame delay of ``1000 / fps`` ms) over one
  fixed palette of 6 x 7 x 6 levels, so a channel is off by at most
  ``GIF_MAX_ERROR``; imageio quantises through Pillow instead, so the bytes
  differ from the JAX package's;
- the resizes of ``cv2.resize``: ``INTER_AREA`` (downscale), bilinear and
  ``INTER_NEAREST`` (``src = floor(dst * in / out)``), separable, on (h, w[,
  c]) uint8 or float arrays; uint8 results are rounded, within one step of
  cv2's fixed-point arithmetic; ``INTER_CUBIC`` is OpenCV's own arithmetic
  (``ops/resize.py:resize_cubic`` on the CPU); an unchanged size returns a
  copy;
- JPEG is read through cv2 where it is installed, and raises otherwise;
- video clips (``load_video_frames``): mp4/avi/mov/webm files through cv2
  where it is installed, else a clip is a directory of PNG frames.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_cubic

# ----------------------------------------------------------------- conventions


def image_to_unit(image: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 [0, 1] (ControlNet condition input convention)."""
    return image.astype(np.float32) / 255.0


def unit_to_uint8(image: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def image_to_tensor(image: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 [-1, 1] (VAE input convention)."""
    return image.astype(np.float32) / 127.5 - 1.0


# --------------------------------------------------------------------- resizes


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        x0 = math.floor(src)
        f = src - x0
        if x0 < 0:
            x0, f = 0, 0.0
        if x0 >= n_in - 1:
            x0, f = n_in - 1, 0.0
        w[i, x0] += 1.0 - f
        w[i, min(x0 + 1, n_in - 1)] += f
    return w


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """cv2's INTER_AREA table (``computeResizeAreaTab``) for n_in >= n_out."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        fs1 = i * scale
        fs2 = fs1 + scale
        cell = min(scale, n_in - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            w[i, s1 - 1] += (s1 - fs1) / cell
        for s in range(s1, s2):
            w[i, s] += 1.0 / cell
        if fs2 - s2 > 1e-3:
            w[i, s2] += min(min(fs2 - s2, 1.0), cell) / cell
    return w


_WEIGHTS = {"linear": _linear_weights, "area": _area_weights}


def resize_weights(n_in: int, n_out: int, interpolation: str) -> np.ndarray:
    """The (n_out, n_in) float64 matrix ``resize`` applies along one axis."""
    return _WEIGHTS[interpolation](n_in, n_out)


def resize(image: np.ndarray, out_hw: Tuple[int, int], interpolation: str = "linear"
           ) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h), interpolation=...)`` for "linear" (the
    cv2 default), "cubic", "area" (downscaling) and "nearest", on (h, w) or
    (h, w, c) arrays; uint8 in, uint8 out (rounded, saturated)."""
    h, w = image.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image.copy()
    if interpolation == "nearest":
        rows = np.arange(oh) * h // oh
        cols = np.arange(ow) * w // ow
        return image[rows][:, cols].copy()
    if interpolation == "cubic":
        return resize_cubic(torch.from_numpy(np.ascontiguousarray(image)), out_hw).numpy()
    x = image.astype(np.float64)
    if oh != h:
        x = np.tensordot(resize_weights(h, oh, interpolation), x, axes=(1, 0))
    if ow != w:
        x = np.moveaxis(np.tensordot(resize_weights(w, ow, interpolation), x, axes=(1, 1)),
                        0, 1)
    if image.dtype == np.uint8:
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return x.astype(image.dtype)


def center_crop_and_resize(image: np.ndarray, size: Tuple[int, int] = (512, 512)
                           ) -> np.ndarray:
    """Resize the short side to ``size`` (INTER_AREA when shrinking, INTER_CUBIC
    otherwise), then centre-crop; uint8 (h, w, 3) in and out. An image of the
    target size comes back unchanged."""
    h, w = image.shape[:2]
    th, tw = size
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    image = resize(image, (nh, nw), "area" if scale < 1 else "cubic")
    top = (nh - th) // 2
    left = (nw - tw) // 2
    return image[top: top + th, left: left + tw]


# ------------------------------------------------------------------------ PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(data: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of ``data`` (h, w, bpp) uint8. A byte depends on
    its left, upper and upper-left neighbours only, so each anti-diagonal of
    pixels is reconstructed at once."""
    h, w, _ = data.shape
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG: unknown filter type {int(ftype.max())}")
    d = data.astype(np.int32)
    if int(ftype.max(initial=0)) <= 2:  # None, Sub and Up only: row by row
        out = np.zeros_like(d)
        prev = np.zeros_like(d[0])
        for y in range(h):
            row = {0: d[y], 1: np.cumsum(d[y], axis=0), 2: d[y] + prev}[int(ftype[y])]
            out[y] = prev = row & 255
        return out.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, data.shape[2]), np.int32)  # a zero border row/column
    for s in range(h + w - 1):
        ys = np.arange(max(0, s - w + 1), min(h, s + 1))
        xs = s - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[ys][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (d[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(blob: bytes) -> np.ndarray:
    """An 8-bit PNG -> (h, w) gray, (h, w, 2) gray + alpha, (h, w, 3) RGB or
    (h, w, 4) RGBA uint8 (a palette image -> RGB, or RGBA with a tRNS chunk),
    as imageio returns them."""
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, trns, ihdr = 8, [], None, None, None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind, body = blob[pos + 4: pos + 8], blob[pos + 8: pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG: only 8-bit images are read (bit depth {depth}, "
                         f"color type {ctype})")
    if interlace:
        raise ValueError("PNG: interlaced images are not read")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[: h * (w * ch + 1)].reshape(h, w * ch + 1)
    img = _unfilter(rows[:, 1:].reshape(h, w, ch), rows[:, 0])
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        idx = img[..., 0]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns[: len(palette)]
            return np.concatenate([palette[idx], alpha[idx][..., None]], axis=-1)
        return palette[idx]
    return img[..., 0] if ch == 1 else img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA uint8 -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG: uint8 images only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # filter type 2 (Up), uint8 wrap-around
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------------------ GIF

_GIF_LEVELS = (6, 7, 6)
# half the widest palette step (255 / 5), rounded down: the largest error of a channel
GIF_MAX_ERROR = 25


def _gif_palette() -> np.ndarray:
    r, g, b = (np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in _GIF_LEVELS)
    grid = np.stack(np.meshgrid(r, g, b, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.concatenate([grid, np.zeros((256 - len(grid), 3), np.uint8)])


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """Nearest entry of the fixed palette for each pixel of an RGB uint8 frame."""
    q = [(frame[..., i].astype(np.int32) * (n - 1) * 2 + 255) // 510
         for i, n in enumerate(_GIF_LEVELS)]
    return (q[0] * (_GIF_LEVELS[1] * _GIF_LEVELS[2]) + q[1] * _GIF_LEVELS[2]
            + q[2]).astype(np.uint8)


def _lzw(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a stream of palette indices."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    bits = nbits = 0
    size = min_code_size + 1

    def emit(code):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8

    table, next_code = {}, eoi + 1
    emit(clear)
    prefix = indices[0]
    for c in indices[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:  # the table is full: start again
            emit(clear)
            table, next_code, size = {}, eoi + 1, min_code_size + 1
        prefix = c
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(bits & 255)
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray], fps: int = 8) -> bytes:
    """RGB uint8 frames of one size -> a looping GIF, ``1000 / fps`` ms a frame
    (in centiseconds, rounded down as Pillow does)."""
    h, w = frames[0].shape[:2]
    delay = int(1000.0 / fps / 10)
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
    out += _gif_palette().tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"  # loop forever
    for frame in frames:
        if frame.shape[:2] != (h, w):
            raise ValueError(f"GIF: frame of shape {frame.shape[:2]} in a {h}x{w} GIF")
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08"
        data = _lzw(_gif_indices(frame[..., :3]).tobytes())
        for i in range(0, len(data), 255):
            block = data[i: i + 255]
            out += bytes([len(block)]) + block
        out += b"\x00"
    out += b"\x3b"
    return bytes(out)


# --------------------------------------------------------------------- files


def _write(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(blob)


def save_gif(frames: Sequence[np.ndarray], path: str, fps: int = 8) -> None:
    """Write frames ([0, 1] float or uint8) as a looping gif."""
    _write(path, encode_gif([f if f.dtype == np.uint8 else unit_to_uint8(f) for f in frames],
                            fps))


def save_concat_gif(frame_lists: List[Sequence[np.ndarray]], path: str, fps: int = 8) -> None:
    """Side-by-side concat gif (condition | generated)."""
    concat = [
        np.concatenate([fl[i] if fl[i].dtype == np.uint8 else unit_to_uint8(fl[i])
                        for fl in frame_lists], axis=1)
        for i in range(len(frame_lists[0]))
    ]
    save_gif(concat, path, fps)


def save_png(image: np.ndarray, path: str) -> None:
    _write(path, encode_png(image if image.dtype == np.uint8 else unit_to_uint8(image)))


def read_image(path: str) -> np.ndarray:
    """The pixels of a PNG (see ``decode_png``), or of a JPEG through cv2 (RGB)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        with open(path, "rb") as fh:
            return decode_png(fh.read())
    if ext in (".jpg", ".jpeg"):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(f"{path}: reading a JPEG needs cv2, which is not installed; "
                               "convert the frames to PNG") from e
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"{path}: cv2 could not read the file")
        return img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    raise ValueError(f"{path}: only .png, .jpg and .jpeg files are read")


def load_image(path: str, size: Tuple[int, int] = (512, 512)) -> np.ndarray:
    return center_crop_and_resize(_rgb(read_image(path)), size)


# ---------------------------------------------------------------------- video

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".webm")


def _rgb(img: np.ndarray) -> np.ndarray:
    """Gray, gray + alpha, RGB or RGBA uint8 -> RGB."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def _sample_indices(total: int, n_frames: int, native_fps: float, target_fps: int):
    """Every ``round(native / target)``-th frame from the first, the first
    ``n_frames``; too few: ``n_frames`` indices spread evenly over the clip."""
    stride = max(1, int(round(native_fps / target_fps)))
    idxs = list(range(0, total, stride))[:n_frames]
    if len(idxs) < n_frames:
        idxs = np.linspace(0, max(total - 1, 0), n_frames).astype(int).tolist()
    return idxs


def load_video_frames(
    path: str, n_frames: int, target_fps: int = 16, size: Tuple[int, int] = (512, 512)
) -> List[np.ndarray]:
    """A clip -> ``n_frames`` RGB uint8 frames sampled at ``target_fps``,
    resized and centre-cropped to ``size`` (``center_crop_and_resize``).

    ``path`` is a video file (mp4/avi/mov/webm), decoded through cv2 as the JAX
    package does (the file's own fps), or a directory of PNG frames in name
    order, taken to be at ``target_fps``. A frame that cannot be read repeats
    the one before it (zeros for the first). A video file on a host without
    cv2 raises ``RuntimeError``."""
    if os.path.isdir(path):
        names = sorted(f for f in os.listdir(path) if f.lower().endswith(".png"))
        if not names:
            raise ValueError(f"{path}: no PNG frames")
        frames: List[np.ndarray] = []
        for idx in _sample_indices(len(names), n_frames, target_fps, target_fps):
            try:
                frames.append(center_crop_and_resize(
                    _rgb(read_image(os.path.join(path, names[idx]))), size))
            except (OSError, ValueError):
                frames.append(frames[-1] if frames else np.zeros((*size, 3), np.uint8))
        return frames
    if not path.lower().endswith(VIDEO_EXTENSIONS):
        raise ValueError(f"{path}: not a video file ({', '.join(VIDEO_EXTENSIONS)}) or a "
                         f"directory of PNG frames")
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{path}: decoding a video file needs cv2, which is not installed; "
                           "give the clip as a directory of PNG frames") from e
    cap = cv2.VideoCapture(path)
    try:
        native_fps = cap.get(cv2.CAP_PROP_FPS) or target_fps
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        frames = []
        for idx in _sample_indices(total, n_frames, native_fps, target_fps):
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:
                frames.append(frames[-1] if frames else np.zeros((*size, 3), np.uint8))
                continue
            frames.append(center_crop_and_resize(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), size))
    finally:
        cap.release()
    return frames
