"""Plain float32 operations of the benchmark's reference towers.

Each function is the published mathematics in plain ``torch``: GroupNorm and
LayerNorm with fp32 statistics, exact (erf) GEGLU, softmax attention computed
in blocks of (batch x head) rows so that its logits stay near 1 GiB, the
nearest resize and the average pool of the pipelines, and the temporal
transformers' single-key context. Nothing here imports the program under test.
"""

from __future__ import annotations

import contextvars
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LOGITS_BYTES = 1 << 30
# Activation checkpointing under grad (attention blocks, and the towers in
# ``svd_train``); counting operations turns it off so that no recompute counts.
RECOMPUTE = contextvars.ContextVar("recompute", default=True)


def maybe_checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward unless
    ``RECOMPUTE`` is off; the numbers are the same either way."""
    if RECOMPUTE.get():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over dim 1 (contiguous channel groups, all trailing positions),
    then the affine step and an optional SiLU."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    return F.silu(y) if silu else y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)


def geglu(x: torch.Tensor, proj: torch.nn.Linear) -> torch.Tensor:
    """value * gelu(gate) with the exact (erf) gelu of the published models."""
    value, gate = proj(x).chunk(2, dim=-1)
    return value * F.gelu(gate)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.bmm(q, k.transpose(1, 2)) * q.shape[-1] ** -0.5
    return torch.bmm(torch.softmax(logits, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(H)) v over (B, T, N, H) inputs, returned (B, T, N, H).
    The (batch x head) axis runs in blocks that keep the logits near 1 GiB;
    under grad each block's probabilities are recomputed in the backward
    rather than kept."""
    b, t, n, h = q.shape
    s = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * n, t, h)
    kf = k.transpose(1, 2).reshape(b * n, s, h)
    vf = v.transpose(1, 2).reshape(b * n, s, h)
    step = max(1, LOGITS_BYTES // (t * s * 4))
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    out = []
    for i in range(0, b * n, step):
        blocks = (qf[i:i + step], kf[i:i + step], vf[i:i + step])
        out.append(maybe_checkpoint(_attend, *blocks) if grad else _attend(*blocks))
    return torch.cat(out).reshape(b, n, t, h).transpose(1, 2)


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize, source index floor(dst * in / out)."""
    h, w = x.shape[-2:]
    if tuple(out_hw) == (h, w):
        return x
    rows = torch.arange(out_hw[0], device=x.device) * h // out_hw[0]
    cols = torch.arange(out_hw[1], device=x.device) * w // out_hw[1]
    return x.index_select(-2, rows).index_select(-1, cols)


def avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool over the two trailing axes (torch's bin rule)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    lead = x.shape[:-2]
    y = F.adaptive_avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), tuple(out_hw))
    return y.reshape(*lead, *y.shape[-2:])


def time_context(encoder_hidden_states: torch.Tensor, b: int, num_frames: int,
                 hw: int) -> torch.Tensor:
    """The temporal transformers' single-key context, (hw * b, n, d): each
    video's first-frame states repeated over the hw pixels, spatial-major (row
    p * b + v), as diffusers builds it."""
    d = encoder_hidden_states.shape[-1]
    first = encoder_hidden_states.reshape(b, num_frames, -1, d)[:, 0]
    return first[None].expand(hw, *first.shape).reshape(hw * b, -1, d)
