"""Per-sample control-fidelity metrics behind the inference CLI's ``--evaluate``.

Counterpart of ``ctrl_adapter_tpu/evaluation/metrics.py``: PSNR, global SSIM,
temporal consistency (mean and max frame deltas) and the edge F1 of canny
re-extracted from the output against the condition. The port has no condition
extractors yet (ROADMAP Queue 1 item 5): canny runs through cv2 where it is
installed, and the correlation of re-extracted depth with the condition depth
is None with the reason in ``skipped``, as the JAX package reports it without
a local DPT checkpoint; the correlation comes with the depth extractor. A metrics file never measures less than it claims: every metric of
the control type appears, None with a reason when it could not be computed.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from ..utils.image import unit_to_uint8

logger = logging.getLogger(__name__)

NO_DEPTH_EXTRACTOR = "the port has no depth extractor yet (ROADMAP Queue 1 item 5)"
NO_CANNY = "canny extraction needs cv2 until the port's extractors land (ROADMAP Queue 1 item 5)"


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Global-statistics SSIM (no sliding window) — adequate for relative comparisons."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    )


def temporal_consistency(frames: np.ndarray) -> Dict[str, float]:
    """frames: (f, h, w, 3) in [0,1]. Lower mean-abs frame delta = smoother video
    (cheap proxy for the paper's optical-flow error)."""
    deltas = np.abs(np.diff(frames.astype(np.float64), axis=0))
    return {
        "mean_frame_delta": float(deltas.mean()),
        "max_frame_delta": float(deltas.max()),
    }


def extract_canny(image: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Canny edges at the reference thresholds, (h, w, 3) uint8 RGB -> edge map
    replicated to 3 channels; needs cv2."""
    import cv2

    edges = cv2.Canny(image, low, high)
    return np.repeat(edges[:, :, None], 3, axis=2)


def canny_control_f1(
    generated: np.ndarray, condition_edges: np.ndarray, low: int = 100, high: int = 200
) -> float:
    """Re-extract canny from the generated image and F1 against the conditioning
    edge map (both uint8 RGB; edge maps binarized at 127)."""
    gen_edges = extract_canny(generated, low, high)[..., 0] > 127
    cond = condition_edges[..., 0] > 127
    tp = float(np.logical_and(gen_edges, cond).sum())
    fp = float(np.logical_and(gen_edges, ~cond).sum())
    fn = float(np.logical_and(~gen_edges, cond).sum())
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return float(2 * precision * recall / (precision + recall))


def evaluate_video(
    video: np.ndarray,  # (f, h, w, 3) in [0,1]
    condition_frames: Optional[np.ndarray] = None,  # (f, h, w, 3) uint8
    control_type: str = "canny",
) -> Dict[str, object]:
    """Per-sample metrics; single images pass ``video`` with f = 1. The depth
    correlation is None (see the module docstring)."""
    out: Dict[str, object] = {"skipped": []}
    if video.shape[0] > 1:
        out.update(temporal_consistency(video))
    if condition_frames is not None and control_type in ("canny", "scribble", "softedge",
                                                         "lineart"):
        try:
            f1s = [canny_control_f1(unit_to_uint8(video[i]), condition_frames[i])
                   for i in range(video.shape[0])]
            out["edge_control_f1"] = float(np.mean(f1s))
        except ImportError:
            out["edge_control_f1"] = None
            out["skipped"].append(f"edge_control_f1: {NO_CANNY}")
        out["edge_metric_method"] = (
            f"canny(100,200) re-extraction vs {control_type} condition binarized@127"
        )
    if condition_frames is not None and control_type == "depth":
        logger.warning(
            "depth_control_correlation unavailable (no local DPT checkpoint?): %s",
            NO_DEPTH_EXTRACTOR,
        )
        out["depth_control_correlation"] = None
        out["skipped"].append(
            "depth_control_correlation: depth extractor unavailable "
            "(no local DPT checkpoint)"
        )
    return out
