"""The port's data path against the JAX package's, on the CPU.

- ``load_video_frames`` on an mp4 written here with cv2 (64 x 80 frames, so
  the centre crop runs; stride 1 and 2) against the JAX function, within one
  uint8 step (the resizes are the port's, not cv2's), and on the same
  decoded frames as a directory of PNG frames: equal. A video file without
  cv2 raises.
- ``read_prompts_csv``, ``VideoDataset``, ``ImageDataset``, ``collate`` and
  ``Prefetcher`` (one worker; mixed canny/shuffle batches) against JAX's on
  that clip and on PNG images: the same items, captions and types, frames and
  conditions within one uint8 step.
- The port's own rules: an item whose files fail to read is replaced, a fault
  of the extractor propagates; a worker's exception reaches ``next``; an
  unported type raises when the dataset is made.

Canny and shuffle only: the networks' extractors are held to JAX in
``tests/test_torch_conditions.py``.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from ctrl_adapter_tpu_torch.conditions import extractors as tex
from ctrl_adapter_tpu_torch.data import loader as tl
from ctrl_adapter_tpu_torch.utils import image as timage

torch.set_num_threads(1)

FPS = 8


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A folder with one 12-frame mp4 at 8 fps (64 x 80) and ``clip_png/``, its
    frames as cv2 decodes them, as PNGs; a captions csv with a header."""
    import cv2

    root = str(tmp_path_factory.mktemp("clips"))
    frames = chip_smoke.smooth_frames(np.random.default_rng(0), 12, 80)
    writer = cv2.VideoWriter(os.path.join(root, "clip_mp4.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), FPS, (80, 64))
    for fr in frames:
        writer.write(cv2.cvtColor(fr[:64], cv2.COLOR_RGB2BGR))
    writer.release()
    cap = cv2.VideoCapture(os.path.join(root, "clip_mp4.mp4"))
    decoded = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        decoded.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
    cap.release()
    assert len(decoded) == 12
    for i, fr in enumerate(decoded):
        timage.save_png(fr, os.path.join(root, "clip_png", f"{i:03d}.png"))
    csv_path = str(tmp_path_factory.mktemp("csv") / "captions.csv")
    with open(csv_path, "w") as fh:
        fh.write("video,caption\nclip_mp4.mp4,a car on a road\nclip_png.mp4,a red car\n")
    return root, csv_path


@pytest.mark.parametrize("target_fps", [FPS, FPS // 2])
def test_load_video_frames_matches_jax_and_png_folder(clips, target_fps):
    from ctrl_adapter_tpu.utils.image import load_video_frames as jload

    root, _ = clips
    mp4 = os.path.join(root, "clip_mp4.mp4")
    got = timage.load_video_frames(mp4, 5, target_fps, (48, 48))
    want = jload(mp4, 5, target_fps, (48, 48))
    assert len(got) == len(want) == 5
    assert max(np.abs(g.astype(int) - w).max() for g, w in zip(got, want)) <= 1
    if target_fps == FPS:  # a PNG folder is taken to be at the target fps
        png = timage.load_video_frames(os.path.join(root, "clip_png"), 5, target_fps, (48, 48))
        for g, p in zip(got, png):
            np.testing.assert_array_equal(g, p)
    # too few frames at this stride: evenly spread indices, as JAX's
    got = timage.load_video_frames(mp4, 9, target_fps, (48, 48))
    want = jload(mp4, 9, target_fps, (48, 48))
    assert max(np.abs(g.astype(int) - w).max() for g, w in zip(got, want)) <= 1


def test_video_file_without_cv2_raises(clips, monkeypatch):
    root, _ = clips
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="PNG frames"):
        timage.load_video_frames(os.path.join(root, "clip_mp4.mp4"), 3, FPS)
    assert len(timage.load_video_frames(os.path.join(root, "clip_png"), 3, FPS)) == 3


def test_read_prompts_csv_matches_jax(clips):
    from ctrl_adapter_tpu.data.loader import read_prompts_csv

    _, csv_path = clips
    assert tl.read_prompts_csv(csv_path) == read_prompts_csv(csv_path) == {
        "clip_mp4": "a car on a road", "clip_png": "a red car"}


def _close(got, want, step):
    np.testing.assert_allclose(got, want, atol=step + 1e-6, rtol=0)


def _agree(got, want, share=0.95):
    """Condition maps of frames that differ by one uint8 step (the port's
    resizes): at least ``share`` of the values within one step."""
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1 / 255 + 1e-6).mean() >= share


def _u8(frames):
    return np.rint((frames + 1.0) * 127.5).astype(np.uint8)


def _same_item(got, want):
    assert got["caption"] == want["caption"]
    assert got["frames"].shape == want["frames"].shape
    _close(got["frames"], want["frames"], 1 / 127.5)
    _close(got["first_frame"], want["first_frame"], 1 / 127.5)
    assert got["conditions"].shape == want["conditions"].shape


def _datasets(clips, types=("canny",)):
    from ctrl_adapter_tpu.conditions.extractors import ConditionExtractor as JEx
    from ctrl_adapter_tpu.data.loader import VideoDataset as JVideo

    from ctrl_adapter_tpu_torch.conditions.extractors import ConditionExtractor

    root, csv_path = clips
    kw = dict(n_sample_frames=4, output_fps=FPS, size=48, control_types=types)
    port = tl.VideoDataset(root, csv_path, extractor=ConditionExtractor(device="cpu"), **kw)
    jax_ = JVideo(root, csv_path, extractor=JEx(), **kw)
    return port, jax_


def test_video_dataset_matches_jax(clips):
    """The port lists the mp4 and the PNG-frame clip (JAX lists the mp4 only);
    item by item the mp4 agrees with JAX's, and the PNG clip's canny maps are
    the port's canny of its frames."""
    port, jax_ = _datasets(clips)
    assert [os.path.basename(f) for f in port.files] == ["clip_mp4.mp4", "clip_png"]
    assert [os.path.basename(f) for f in jax_.files] == ["clip_mp4.mp4"]
    got, want = port.get(0), jax_.get(0)
    _same_item(got, want)
    # canny is cv2's bit for bit: the maps are those of the item's own frames
    edges = tex.canny_edges(torch.from_numpy(_u8(got["frames"]))).numpy()
    np.testing.assert_array_equal(got["conditions"][0, ..., 0] * 255, edges)
    _agree(got["conditions"], want["conditions"])
    png = port.get(1, ["canny", "shuffle"])
    assert png["caption"] == "a red car" and png["conditions"].shape == (2, 4, 48, 48, 3)


def test_image_dataset_and_collate_match_jax(tmp_path):
    from ctrl_adapter_tpu.conditions.extractors import ConditionExtractor as JEx
    from ctrl_adapter_tpu.data.loader import ImageDataset as JImage
    from ctrl_adapter_tpu.data.loader import collate as jcollate

    from ctrl_adapter_tpu_torch.conditions.extractors import ConditionExtractor

    root, csv_path = chip_smoke.write_image_folder(str(tmp_path / "imgs"), 2, 72, seed=1)
    kw = dict(size=64, control_size=32, control_types=["canny", "shuffle"])
    port = tl.ImageDataset(root, csv_path, extractor=ConditionExtractor(device="cpu"), **kw)
    jax_ = JImage(root, csv_path, extractor=JEx(), **kw)
    items = [port.get(i) for i in range(2)]
    jitems = [jax_.get(i) for i in range(2)]
    for g, w in zip(items, jitems):
        _same_item(g, w)
        assert g["frames"].shape == (1, 64, 64, 3) and g["conditions"].shape == (2, 1, 32, 32, 3)
        _agree(g["conditions"], w["conditions"])
    got = tl.collate(items, keep_raw=True)
    want = jcollate(items, keep_raw=True)
    assert got.keys() == want.keys() and got["captions"] == want["captions"]
    assert got["controlnet_cond"].shape == (2, 2, 32, 32, 3)
    for k in ("frames", "controlnet_cond", "first_frames"):
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_matches_jax(clips):
    """One worker, seed 3, batches of 2, one type a batch drawn from
    (canny, shuffle): the same types and items as JAX's, in order."""
    from ctrl_adapter_tpu.data.loader import Prefetcher as JPrefetcher

    port, jax_ = _datasets(clips)
    port.files = port.files[:1]  # the mp4 alone, as JAX lists it

    def chooser(rng):
        return [rng.choice(["canny", "shuffle"])]

    p = tl.Prefetcher(port, 2, num_workers=1, seed=3, control_types_chooser=chooser)
    j = JPrefetcher(jax_, 2, num_workers=1, seed=3, control_types_chooser=chooser)
    try:
        for _ in range(3):
            got, want = p.next(), j.next()
            assert got["control_types"] == want["control_types"]
            assert got.keys() == want.keys()
            _close(got["frames"], want["frames"], 1 / 127.5)
            _agree(got["controlnet_cond"], want["controlnet_cond"])
    finally:
        p.close()
        j.close()


class _Failing:
    """A dataset whose ``get`` raises ``error``."""

    def __init__(self, error):
        self.error = error

    def __len__(self):
        return 3

    def get(self, idx, control_types=None, rng=None):
        raise self.error


def test_worker_exception_reaches_next():
    p = tl.Prefetcher(_Failing(RuntimeError("CUDA error: an illegal memory access")), 2)
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed") as err:
            p.next()
        assert "illegal memory access" in str(err.value.__cause__)
    finally:
        p.close()
    assert not any(t.is_alive() for t in p._threads)


def test_only_read_errors_are_retried(tmp_path):
    """A corrupt image is replaced by another item; the extractor's fault
    propagates, not retried."""
    root, csv_path = chip_smoke.write_image_folder(str(tmp_path / "imgs"), 2, 40, seed=2)
    with open(os.path.join(root, "img0.png"), "wb") as fh:
        fh.write(b"not a png")

    class Extractor:
        calls = 0

        def extract(self, ctype, images):
            Extractor.calls += 1
            if ctype == "depth":
                raise RuntimeError("the depth network failed")
            return [np.zeros_like(im) for im in images]

    ds = tl.ImageDataset(root, csv_path, size=32, control_size=32, control_types=["canny"],
                         extractor=Extractor())
    item = ds.get(0, rng=random.Random(0))
    assert item["caption"].endswith(" 1") and Extractor.calls == 1
    with pytest.raises(RuntimeError, match="depth network failed"):
        ds.get(1, ["depth"])
    assert Extractor.calls == 2
    with open(os.path.join(root, "img1.png"), "wb") as fh:
        fh.write(b"not a png either")
    with pytest.raises(RuntimeError, match="consecutive loads"):
        ds.get(1, rng=random.Random(0))


def test_unported_type_raises_at_startup(clips):
    root, csv_path = clips
    for ctype in ("normal", "softedge", "lineart", "openpose", "scribble"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            tl.VideoDataset(root, csv_path, control_types=["depth", ctype])
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            tl.ImageDataset(root, csv_path, control_types=[ctype])
