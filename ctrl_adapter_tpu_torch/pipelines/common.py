"""Control-window helpers, classifier-free guidance (plain and rescaled), LCM's
guidance-scale embedding and SDXL's time ids (counterpart of
``ctrl_adapter_tpu/pipelines/common.py``)."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F


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


def classifier_free_guidance_rescaled(noise_pred: torch.Tensor, guidance_scale,
                                      guidance_rescale) -> torch.Tensor:
    """CFG, then the guided prediction's std rescaled to the conditional one's
    (arXiv 2305.08891 section 3.4), mixed in by ``guidance_rescale``; 0 is plain
    CFG. The stds are population stds over all but the batch axis, as
    ``jnp.std``."""
    uncond, cond = noise_pred.chunk(2)
    guided = uncond + guidance_scale * (cond - uncond)
    if isinstance(guidance_rescale, (int, float)) and guidance_rescale == 0:
        return guided  # 0 x rescaled + 1 x guided, exactly
    dims = tuple(range(1, guided.dim()))
    std_text = torch.std(cond, dim=dims, keepdim=True, correction=0)
    std_guided = torch.std(guided, dim=dims, keepdim=True, correction=0)
    rescaled = guided * (std_text / (std_guided + 1e-8))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * guided


def guidance_scale_embedding(w: torch.Tensor, embedding_dim: int,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LCM's sin/cos embedding of the guidance scales ``w`` (b,): w x 1000 over
    half-dim log-spaced frequencies, [sin, cos], a zero column when the
    dimension is odd."""
    w = w.float() * 1000.0
    half_dim = embedding_dim // 2
    freq = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=w.device)
                     * (-math.log(10000.0) / (half_dim - 1)))
    emb = w[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def sdxl_add_time_ids(original_size: Tuple[int, int], crops_coords_top_left: Tuple[int, int],
                      target_size: Tuple[int, int], batch_size: int,
                      dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """(batch, 6): [orig_h, orig_w, crop_top, crop_left, target_h, target_w] per
    sample, filled in on ``device``."""
    ids = torch.empty((batch_size, 6), dtype=dtype, device=device)
    for j, v in enumerate((*original_size, *crops_coords_top_left, *target_size)):
        ids[:, j] = v
    return ids
