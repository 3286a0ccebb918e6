"""``conditions/imgproc.py`` and ``ops/resize.py:resize_cubic`` against the
installed cv2 (OpenCV 5.0.0, the version these cases were written for;
``test_cv2_is_the_version_held`` records it): bit for bit on uint8, within
1e-6 of the largest value on float32 (where the blur also equals cv2's on at
least 99 % of the pixels: its fused multiply-adds are reproduced, its scalar
tail columns to an ulp).

The uint8 cubic resize is OpenCV's own arithmetic: cv2 5.0 passes uint8
cubic resizes to its Intel IPP HAL unless ``cv2.ipp.setUseIPP(False)``, and
IPP's rounding is not published (``test_ipp_resize_is_a_step_away`` bounds
it: one step, on about 5 % of the values). No JAX here.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctrl_adapter_tpu_torch.conditions import imgproc as ip
from ctrl_adapter_tpu_torch.ops.resize import resize_cubic

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(37, 53), (64, 70), (20, 7), (96, 80), (3, 40, 48)]


def test_cv2_is_the_version_held():
    assert cv2.__version__.startswith("5.0")


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _per_plane(fn, x):
    return np.stack([fn(p) for p in x]) if x.ndim == 3 else fn(x)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sigma", [3.0, 1.3])
def test_gaussian_blur_matches_cv2(shape, sigma):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    f32 = rng.uniform(-2, 5, shape).astype(np.float32)
    blur = lambda p: cv2.GaussianBlur(p, (0, 0), sigma)  # noqa: E731
    np.testing.assert_array_equal(ip.gaussian_blur(torch.from_numpy(u8), sigma).numpy(),
                                  _per_plane(blur, u8))
    want = _per_plane(blur, f32)
    got = ip.gaussian_blur(torch.from_numpy(f32), sigma).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert (got == want).mean() >= 0.99  # equal but in a few scalar-tail columns
    assert ip.gaussian_ksize(3.0, torch.uint8) == 19 and ip.gaussian_ksize(3.0, torch.float32) == 25


def test_gaussian_blur_of_a_binary_map():
    m = np.zeros((40, 44), np.uint8)
    m[10:12, 5:30] = 255
    m[20, 20] = 255
    np.testing.assert_array_equal(ip.gaussian_blur(torch.from_numpy(m), 3.0).numpy(),
                                  cv2.GaussianBlur(m, (0, 0), 3.0))


KERNELS = [[[0, 0, 0], [1, 1, 1], [0, 0, 0]], [[0, 1, 0], [0, 1, 0], [0, 1, 0]],
           [[1, 0, 0], [0, 1, 0], [0, 0, 1]], [[0, 0, 1], [0, 1, 0], [1, 0, 0]]]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_dilate_matches_cv2(dtype):
    x = np.random.default_rng(1).uniform(0, 255, (2, 30, 31)).astype(dtype)
    for k in KERNELS:
        want = _per_plane(lambda p: cv2.dilate(p, np.array(k, np.uint8)), x)
        np.testing.assert_array_equal(ip.dilate(torch.from_numpy(x), k).numpy(), want)


@pytest.mark.parametrize("hw", [(512, 512), (40, 48), (37, 53), (300, 200)], ids=str)
def test_resize_cubic_matches_cv2(hw, no_ipp):
    """OpenPose's two resizes: uint8 BGR by ``0.5 * 368 / h`` (a factor:
    coordinates through ``1 / factor``), float32 maps x8, cropped, then to
    the frame's size; and MiDaS's uint8 RGB resize to a size (384^2 there)."""
    h, w = hw
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    s = 0.5 * 368 / h
    want = cv2.resize(img, (0, 0), fx=s, fy=s, interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(resize_cubic(torch.from_numpy(img), factor=s).numpy(), want)
    want = cv2.resize(img, (96, 96), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(resize_cubic(torch.from_numpy(img), (96, 96)).numpy(), want)
    maps = rng.standard_normal((23, 21, 19)).astype(np.float32)
    up = cv2.resize(maps, (0, 0), fx=8, fy=8, interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(torch.from_numpy(maps), factor=8).numpy()
    assert got.shape == up.shape and np.abs(got - up).max() <= 1e-6 * np.abs(up).max()
    crop = np.ascontiguousarray(up[:181, :163])
    back = cv2.resize(crop, (w, h), interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(torch.from_numpy(crop), (h, w)).numpy()
    assert got.shape == back.shape and np.abs(got - back).max() <= 1e-6 * np.abs(back).max()


def test_resize_factor_maps_coordinates_through_its_inverse(no_ipp):
    """At h = 500 the factor 0.368 gives 184 rows, whose ratio 184 / 500 is
    the factor itself; at h = 333 it is 0.5525..., and 184 / 333 is not:
    cv2 maps through 1 / factor, and so does ``resize_cubic``."""
    img = np.random.default_rng(3).integers(0, 256, (333, 41, 3), dtype=np.uint8)
    s = 0.5 * 368 / 333
    want = cv2.resize(img, (0, 0), fx=s, fy=s, interpolation=cv2.INTER_CUBIC)
    assert want.shape[0] == 184
    np.testing.assert_array_equal(resize_cubic(torch.from_numpy(img), factor=s).numpy(), want)
    by_size = cv2.resize(img, (want.shape[1], 184), interpolation=cv2.INTER_CUBIC)
    assert (by_size != want).any()


def test_ipp_resize_is_a_step_away():
    img = np.random.default_rng(4).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    want = cv2.resize(img, (0, 0), fx=0.359375, fy=0.359375, interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(torch.from_numpy(img), factor=0.359375).numpy()
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.1


@pytest.mark.parametrize("weights", [(0.4, 0.6, 0.0), (0.3, 0.7, 1.5), (0.5, 0.5, 0.0)])
def test_add_weighted_matches_cv2(weights):
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, (50, 60, 3), dtype=np.uint8) for _ in range(2))
    al, be, ga = weights
    np.testing.assert_array_equal(
        ip.add_weighted(torch.from_numpy(a), al, torch.from_numpy(b), be, ga).numpy(),
        cv2.addWeighted(a, al, b, be, ga))


def _ellipses(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield ((int(rng.integers(-20, 120)), int(rng.integers(-20, 120))),
               (int(rng.integers(0, 60)), int(rng.integers(0, 8))), int(rng.integers(-400, 400)))


def test_ellipse2poly_matches_cv2():
    for center, axes, angle in _ellipses(2000, 6):
        np.testing.assert_array_equal(ip.ellipse2poly(center, axes, angle, 0, 360, 1),
                                      cv2.ellipse2Poly(center, axes, angle, 0, 360, 1))
    # the sine table: axes of 10^6 read its entries to the 7th decimal
    big = ip.ellipse2poly((0, 0), (10 ** 6, 10 ** 6), 0, 0, 90, 1)
    np.testing.assert_array_equal(big, cv2.ellipse2Poly((0, 0), (10 ** 6, 10 ** 6), 0, 0, 90, 1))


def test_fill_convex_poly_and_circle_match_cv2():
    """Limb ellipses (partly off the canvas too), random convex hulls and
    filled circles, each on a fresh canvas."""
    from scipy.spatial import ConvexHull

    for center, axes, angle in _ellipses(600, 7):
        poly = cv2.ellipse2Poly(center, axes, angle, 0, 360, 1)
        want = cv2.fillConvexPoly(np.zeros((100, 90, 3), np.uint8), poly, [255, 85, 0])
        got = ip.fill_convex_poly(torch.zeros(100, 90, 3, dtype=torch.uint8), poly, [255, 85, 0])
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(8)
    for _ in range(200):
        pts = rng.integers(-30, 130, (int(rng.integers(3, 8)), 2))
        if np.linalg.matrix_rank(pts[1:] - pts[0]) < 2:
            continue
        hull = pts[ConvexHull(pts).vertices].astype(np.int32)
        want = cv2.fillConvexPoly(np.zeros((100, 90, 3), np.uint8), hull, [1, 2, 3])
        got = ip.fill_convex_poly(torch.zeros(100, 90, 3, dtype=torch.uint8), hull, [1, 2, 3])
        np.testing.assert_array_equal(got.numpy(), want)
    for _ in range(300):
        c = (int(rng.integers(-10, 110)), int(rng.integers(-10, 110)))
        r = int(rng.integers(0, 12))
        want = cv2.circle(np.zeros((100, 90, 3), np.uint8), c, r, [9, 8, 7], thickness=-1)
        got = ip.circle(torch.zeros(100, 90, 3, dtype=torch.uint8), c, r, [9, 8, 7])
        np.testing.assert_array_equal(got.numpy(), want)


def test_edge_pad_is_numpys():
    x = np.random.default_rng(9).integers(0, 256, (2, 3, 5, 7), dtype=np.uint8)
    np.testing.assert_array_equal(ip.edge_pad(torch.from_numpy(x), 3, 1).numpy(),
                                  np.pad(x, ((0, 0), (0, 0), (0, 3), (0, 1)), mode="edge"))


_NO_CV2 = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "jax", "flax", "transformers", "controlnet_aux",
                                  "ctrl_adapter_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import numpy as np, torch
from ctrl_adapter_tpu_torch.conditions import hed, imgproc, lineart, normalbae, openpose, pidinet
from ctrl_adapter_tpu_torch.utils import profiling
edge = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 40, 44), dtype=np.uint8))
s = hed.scribble_postprocess(edge)
canvas = openpose.draw_bodypose(40, 44, np.array([[5, 5, 1, 0], [30, 30, 1, 1]], np.float32),
                                np.array([[-1, 0, 1] + [-1] * 15 + [2.0, 4]]))
assert set(np.unique(s.numpy())) <= {{0, 255}} and canvas.any()
print("ok")
"""


def test_new_modules_run_without_cv2():
    proc = subprocess.run([sys.executable, "-c", _NO_CV2.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
