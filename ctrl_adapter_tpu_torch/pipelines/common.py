"""Control-window helpers and classifier-free guidance (counterpart of
``ctrl_adapter_tpu/pipelines/common.py``)."""

from __future__ import annotations

from typing import List, Tuple

import torch


def controlnet_keep_schedule(num_steps: int, control_guidance_start: float,
                             control_guidance_end: float) -> List[float]:
    """Per-step keep flags, the reference's formula."""
    return [1.0 - float(i / num_steps < control_guidance_start
                        or (i + 1) / num_steps > control_guidance_end)
            for i in range(num_steps)]


def control_window(num_steps: int, control_guidance_start: float,
                   control_guidance_end: float) -> Tuple[int, int]:
    """Contiguous [lo, hi) step window where keep == 1."""
    keeps = controlnet_keep_schedule(num_steps, control_guidance_start, control_guidance_end)
    on = [i for i, k in enumerate(keeps) if k == 1.0]
    if not on:
        return 0, 0
    lo, hi = on[0], on[-1] + 1
    if not all(k == 1.0 for k in keeps[lo:hi]):
        raise ValueError("keep window must be contiguous")
    return lo, hi


def normalize_control_latent_size(s) -> Tuple[int, int]:
    """``control_latent_size`` as (h, w): an int pools to (s, s); a tuple is the
    native latent size."""
    return (s, s) if isinstance(s, int) else tuple(s)


def classifier_free_guidance(noise_pred: torch.Tensor, guidance_scale) -> torch.Tensor:
    """Split a CFG-doubled batch [uncond; cond] and combine."""
    uncond, cond = noise_pred.chunk(2)
    return uncond + guidance_scale * (cond - uncond)
