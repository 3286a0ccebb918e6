"""Per-sample control-fidelity metrics behind the inference CLI's ``--evaluate``.

Counterpart of ``ctrl_adapter_tpu/evaluation/metrics.py``: PSNR, global SSIM,
temporal consistency (mean and max frame deltas), the edge F1 of canny
re-extracted from the output (the port's canny, ``conditions/extractors.py``,
on the CPU) against the condition, and the correlation of depth re-extracted
by a caller's ``depth_extractor`` with the condition depth. Without an
extractor the correlation is None with the reason in ``skipped``, as the JAX
package reports it without a local DPT checkpoint (its default is the hybrid
MiDaS of transformers, which neither package has natively). A metrics file
never measures less than it claims: every metric of the control type
appears, None with a reason when it could not be computed.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from ..conditions.extractors import extract_canny
from ..utils.image import unit_to_uint8

logger = logging.getLogger(__name__)


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


def depth_control_correlation(
    generated: np.ndarray, condition_depth: np.ndarray, extractor=None
) -> Optional[float]:
    """Pearson correlation between the condition depth map and depth
    re-extracted from the generated image by ``extractor`` (a callable on a
    list of uint8 frames, such as ``DepthDPT``); None without one."""
    if extractor is None:
        logger.warning("depth_control_correlation unavailable: no depth extractor given")
        return None
    gen_depth = extractor([generated])[0][..., 0].astype(np.float64)
    cond = condition_depth[..., 0].astype(np.float64)
    gd = gen_depth - gen_depth.mean()
    cd = cond - cond.mean()
    denom = np.sqrt((gd**2).sum() * (cd**2).sum())
    return float((gd * cd).sum() / denom) if denom > 0 else None


def evaluate_video(
    video: np.ndarray,  # (f, h, w, 3) in [0,1]
    condition_frames: Optional[np.ndarray] = None,  # (f, h, w, 3) uint8
    control_type: str = "canny",
    depth_extractor=None,
) -> Dict[str, object]:
    """Per-sample metrics; single images pass ``video`` with f = 1."""
    out: Dict[str, object] = {"skipped": []}
    if video.shape[0] > 1:
        out.update(temporal_consistency(video))
    if condition_frames is not None and control_type in ("canny", "scribble", "softedge",
                                                         "lineart"):
        f1s = [canny_control_f1(unit_to_uint8(video[i]), condition_frames[i])
               for i in range(video.shape[0])]
        out["edge_control_f1"] = float(np.mean(f1s))
        out["edge_metric_method"] = (
            f"canny(100,200) re-extraction vs {control_type} condition binarized@127"
        )
    if condition_frames is not None and control_type == "depth":
        if depth_extractor is None:
            logger.warning("depth_control_correlation unavailable: no depth extractor given")
            out["depth_control_correlation"] = None
            out["skipped"].append(
                "depth_control_correlation: depth extractor unavailable "
                "(no local DPT checkpoint)"
            )
        else:
            corrs = []
            for i in range(video.shape[0]):
                c = depth_control_correlation(unit_to_uint8(video[i]), condition_frames[i],
                                              extractor=depth_extractor)
                if c is not None:
                    corrs.append(c)
            out["depth_control_correlation"] = float(np.mean(corrs)) if corrs else None
            if not corrs:
                out["skipped"].append(
                    "depth_control_correlation: extraction failed on all frames"
                )
    return out
