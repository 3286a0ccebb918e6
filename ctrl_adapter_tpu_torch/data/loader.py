"""The training data pipeline: clips and images, captions, condition extraction.

Counterpart of ``ctrl_adapter_tpu/data/loader.py``: ``read_prompts_csv``,
``VideoDataset`` (a folder of clips: video files, or directories of PNG
frames on a host without cv2, ``utils/image.py:load_video_frames``),
``ImageDataset``, ``collate`` and ``Prefetcher`` (worker threads that read,
extract and collate while the card trains). Three things differ from the JAX
classes, on purpose:

- an item is read again from another index (``max_retries`` times) only when
  its own files fail to read or decode (``OSError``, ``ValueError``); a fault
  of the extractor or of the card propagates;
- a worker's exception is kept and raised by ``Prefetcher.next`` (a dead JAX
  worker leaves its consumer waiting forever);
- each worker makes ``device`` its current CUDA device before it runs the
  extractors or encoders there, and draws its items from a ``random.Random``
  seeded, in worker order, from ``random.Random(seed)`` before any worker
  starts.

A dataset checks its control types against its extractor's checkpoint paths
when it is made: a type it cannot extract raises there
(``conditions/extractors.py:check_control_types``), not in a worker.
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..conditions.extractors import ConditionExtractor, check_control_types
from ..utils.image import (VIDEO_EXTENSIONS, image_to_tensor, image_to_unit, load_image,
                           load_video_frames)

# what a bad item's files raise while they are read and decoded
ITEM_ERRORS = (OSError, ValueError)


def read_prompts_csv(path: str) -> Dict[str, str]:
    """CSV with (name, caption)-style columns; a header row is skipped."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    prompts: Dict[str, str] = {}
    start = 1 if rows and not os.path.splitext(rows[0][0])[1] else 0
    for row in rows[start:]:
        if len(row) >= 2:
            prompts[os.path.splitext(row[0])[0]] = row[1]
    return prompts


def _is_clip(path: str) -> bool:
    if os.path.isdir(path):
        return any(f.lower().endswith(".png") for f in os.listdir(path))
    return path.lower().endswith(VIDEO_EXTENSIONS)


class VideoDataset:
    """A folder of clips + a caption csv -> items of frames, caption, conditions."""

    def __init__(
        self,
        data_path: str,
        prompt_path: str,
        n_sample_frames: int = 16,
        output_fps: int = 16,
        size: int = 512,
        control_types: Sequence[str] = ("depth",),
        extractor: Optional[ConditionExtractor] = None,
        max_retries: int = 8,
    ):
        check_control_types(control_types, getattr(extractor, "paths", None))
        self.files = sorted(os.path.join(data_path, f) for f in os.listdir(data_path)
                            if _is_clip(os.path.join(data_path, f)))
        if not self.files:
            raise FileNotFoundError(f"no clips (video files or PNG-frame directories) under "
                                    f"{data_path}")
        self.prompts = read_prompts_csv(prompt_path)
        self.n_sample_frames = n_sample_frames
        self.output_fps = output_fps
        self.size = size
        self.control_types = list(control_types)
        self.extractor = extractor or ConditionExtractor()
        self.max_retries = max_retries

    def __len__(self):
        return len(self.files)

    def _read(self, idx: int):
        path = self.files[idx]
        frames = load_video_frames(path, self.n_sample_frames, self.output_fps,
                                   (self.size, self.size))
        return frames, os.path.splitext(os.path.basename(path))[0]

    def get(self, idx: int, control_types: Optional[Sequence[str]] = None,
            rng: Optional[random.Random] = None):
        """The item at ``idx``; one whose clip fails to read is replaced by
        another drawn from ``rng`` (``random``'s by default), up to
        ``max_retries`` reads."""
        control_types = list(control_types or self.control_types)
        for _ in range(self.max_retries):
            try:
                frames_u8, name = self._read(idx)
            except ITEM_ERRORS:
                idx = (rng or random).randrange(len(self.files))
                continue
            conds = [np.stack([image_to_unit(m) for m in self.extractor.extract(c, frames_u8)])
                     for c in control_types]
            return {"frames": np.stack([image_to_tensor(f) for f in frames_u8]),  # (f,h,w,3)
                    "caption": self.prompts.get(name, ""),
                    "first_frame": image_to_tensor(frames_u8[0]),
                    "conditions": np.stack(conds)}  # (E, f, h, w, 3) in [0, 1]
        raise RuntimeError(f"dataset failed {self.max_retries} consecutive loads")


class ImageDataset:
    """An image folder + a caption csv (SDXL training)."""

    def __init__(
        self,
        data_path: str,
        prompt_path: str,
        size: int = 1024,
        control_size: int = 512,
        control_types: Sequence[str] = ("depth",),
        extractor: Optional[ConditionExtractor] = None,
        max_retries: int = 8,
    ):
        check_control_types(control_types, getattr(extractor, "paths", None))
        self.files = sorted(
            os.path.join(data_path, f) for f in os.listdir(data_path)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
        )
        if not self.files:
            raise FileNotFoundError(f"no images under {data_path}")
        self.prompts = read_prompts_csv(prompt_path)
        self.size = size
        self.control_size = control_size
        self.control_types = list(control_types)
        self.extractor = extractor or ConditionExtractor()
        self.max_retries = max_retries

    def __len__(self):
        return len(self.files)

    def get(self, idx: int, control_types: Optional[Sequence[str]] = None,
            rng: Optional[random.Random] = None):
        control_types = list(control_types or self.control_types)
        for _ in range(self.max_retries):
            path = self.files[idx]
            try:
                img = load_image(path, (self.size, self.size))
                ctrl_img = load_image(path, (self.control_size, self.control_size))
            except ITEM_ERRORS:
                idx = (rng or random).randrange(len(self.files))
                continue
            conds = [np.stack([image_to_unit(m) for m in self.extractor.extract(c, [ctrl_img])])
                     for c in control_types]
            return {"frames": image_to_tensor(img)[None],  # (1, h, w, 3)
                    "caption": self.prompts.get(os.path.splitext(os.path.basename(path))[0], ""),
                    "first_frame": image_to_tensor(img),
                    "conditions": np.stack(conds)}  # (E, 1, h, w, 3)
        raise RuntimeError(f"dataset failed {self.max_retries} consecutive loads")


def collate(
    items: List[Dict[str, np.ndarray]],
    encode_text: Optional[Callable[[List[str]], np.ndarray]] = None,
    keep_raw: bool = False,
) -> Dict[str, np.ndarray]:
    """Stack items into a batch: frames (b, f, h, w, 3); controlnet_cond
    (E, b*f, h, w, 3), expert-major. ``keep_raw`` passes the captions and
    first frames through for a ``post_collate`` encoder stage."""
    frames = np.stack([it["frames"] for it in items])
    conds = np.stack([it["conditions"] for it in items])  # (b, E, f, h, w, 3)
    b, e, f = conds.shape[:3]
    conds = conds.transpose(1, 0, 2, 3, 4, 5).reshape(e, b * f, *conds.shape[3:])
    batch = {"frames": frames, "controlnet_cond": conds}
    if encode_text is not None:
        batch["controlnet_text_emb"] = encode_text([it["caption"] for it in items])
    if keep_raw:
        batch["captions"] = [it["caption"] for it in items]
        batch["first_frames"] = np.stack([it["first_frame"] for it in items])
    return batch


class Prefetcher:
    """Worker threads that build collated batches (items, extraction,
    ``post_collate``) while the card runs the previous step; the queue depth
    bounds host memory. ``control_types_chooser`` picks one list of types per
    batch (mixed-type training), shared by its items."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        encode_text: Optional[Callable[[List[str]], np.ndarray]] = None,
        num_workers: int = 1,
        queue_depth: int = 2,
        seed: int = 0,
        control_types_chooser: Optional[Callable[[random.Random], Sequence[str]]] = None,
        post_collate: Optional[Callable[[Dict], Dict]] = None,
        device: Optional[torch.device] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.encode_text = encode_text
        self.control_types_chooser = control_types_chooser
        self.post_collate = post_collate
        if device is not None and device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # the caller's card
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._errors: List[BaseException] = []
        seeds = random.Random(seed)
        self._threads = [
            threading.Thread(target=self._worker,
                             args=((w + 1) * 7919 + seeds.randint(0, 1 << 30),), daemon=True)
            for w in range(max(1, num_workers))
        ]
        for t in self._threads:
            t.start()

    def _batch(self, rng: random.Random) -> Dict:
        ctypes = self.control_types_chooser(rng) if self.control_types_chooser else None
        items = [self.dataset.get(rng.randrange(len(self.dataset)), ctypes, rng)
                 for _ in range(self.batch_size)]
        batch = collate(items, self.encode_text, keep_raw=self.post_collate is not None)
        if ctypes is not None:
            batch["control_types"] = list(ctypes)
        if self.post_collate is not None:
            batch = self.post_collate(batch)
        return batch

    def _worker(self, seed: int) -> None:
        try:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            rng = random.Random(seed)
            while not self._stop.is_set():
                batch = self._batch(rng)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # kept for next(), which raises it in the consumer
            self._errors.append(e)
            self._stop.set()

    def next(self) -> Dict[str, np.ndarray]:
        """The next batch; a worker's exception is raised here (chained)."""
        while True:
            if self._errors:
                raise RuntimeError("a prefetch worker failed") from self._errors[0]
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not any(t.is_alive() for t in self._threads) and not self._errors:
                    raise RuntimeError("the prefetch workers stopped")

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the workers (each finishes the batch it is building) and drop
        the queued batches."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
