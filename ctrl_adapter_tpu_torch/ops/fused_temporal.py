"""Temporal transformer block on (b, f, s, c): kernel K3, "full" and "hybrid".

Counterpart of ``ctrl_adapter_tpu/ops/fused_temporal.py``. The block of
``TemporalBasicTransformerBlock``, on the transpose-free (b, f, s, c) layout:

    x -> [LN_in -> GEGLU FF_in (+res)]                      part "ffin"
      -> [LN1 -> Q,K,V -> attention over the f frames at each (b, s, head)
          -> out-proj (+bo) + res + cross bias]              part "attn"
      -> [LN3 -> GEGLU FF (+res)]                            part "ff"

:func:`dispatch_mode` is the JAX rule (``dispatch_mode`` with ``_plan``)
without its device test; the block module follows it:

- "full": the whole block in one launch, :func:`temporal_block_full`
  (``csrc/temporal_full.cu``);
- "hybrid": the "attn" part as :func:`temporal_block` (``csrc/temporal_attention.cu``),
  the two FFs plain on the same layout (``fused_block._torch_ln_ff_residual``);
- None: the module path (transposes to (b*s, f, c)).

The cross bias is the single-key cross-attention ``to_out(to_v(ctx))`` per
(b, s), computed by the caller. Weights are in torch ``nn.Linear`` layout:
``wq/wk/wv`` (ia, c), ``wo`` (c, ia); an FF is the tuple
``(ln_w, ln_b, wg, bg, w2, b2)`` with ``wg`` (2*iff, c) and ``w2`` (c, iff).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from . import mirror_vjp
from ._build import Kernel, ptr, stream_of
from .backend import SMEM_PER_BLOCK, is_hopper, sm_count
from .fused_block import _ln, _torch_ln_ff_residual

KERNEL = Kernel("cak_temporal_attention", [
    *([ctypes.c_void_p] * 11), *([ctypes.c_int] * 16), ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
])
KERNEL_FULL = Kernel("cak_temporal_full", [
    *([ctypes.c_void_p] * 22), *([ctypes.c_int] * 11), ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
])

KERNEL_HEAD_DIM = 64
_HYBRID_ROWS = 128    # tile rows of the hybrid kernel (two consumer warpgroups of 64)
_FULL_ROWS = 128      # f * ts rows per CTA of the full kernel (two warpgroups of 64)
_FULL_WIDTHS = (64, 128, 192, 256, 320)
_FULL_CHUNK = 64      # the full kernel streams the FF inner width in steps of 64

# The TPU's VMEM budgets of ``_plan`` (resident weight bytes per pallas_call, and
# weights + activations). They are a TPU rule, kept so that both packages pick
# the same path for every block.
_WEIGHT_BUDGET = 9 * 1024 * 1024
_VMEM_BUDGET = 14 * 1024 * 1024


def _torch_temporal_block(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int,
                          eps: float = 1e-5, ffin: Optional[tuple] = None,
                          ff: Optional[tuple] = None, approximate: bool = True) -> torch.Tensor:
    """Plain version of K3 (``_xla_temporal_block``): the "attn" part, with the
    "ffin" and "ff" parts before and after it when their weights are given
    (their gelu the tanh form if ``approximate``, else erf; the caller picks
    it by the JAX rule, ``nn/attention.py:gelu_approximate``)."""
    if ffin is not None:
        x = _torch_ln_ff_residual(x, *ffin, eps, approximate, True)
    b, f, s, c = x.shape
    hd = wq.shape[0] // heads
    y = _ln(x, ln_w, ln_b, eps)
    q = F.linear(y, wq).reshape(b, f, s, heads, hd)
    k = F.linear(y, wk).reshape(b, f, s, heads, hd)
    v = F.linear(y, wv).reshape(b, f, s, heads, hd)
    logits = torch.einsum("bisnh,bjsnh->bsnij", q, k) * hd ** -0.5
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    o = torch.einsum("bsnij,bjsnh->bisnh", probs, v).reshape(b, f, s, heads * hd)
    out = x + F.linear(o, wo, bo)
    if cross_bias is not None:
        out = out + cross_bias[:, None]
    if ff is not None:
        out = _torch_ln_ff_residual(out, *ff, eps, approximate, True)
    return out


def _part_weight_bytes(c: int, ia: int, iff: int, itemsize: int) -> dict:
    return {
        "ffin": (c * 2 * iff + 2 * iff + iff * c + c) * itemsize,
        "attn": (3 * c * ia + ia * c + c) * itemsize,
        "ff": (c * 2 * iff + 2 * iff + iff * c + c) * itemsize,
    }


def _plan(parts, c: int, ia: int, iff: int, s: int, f: int, itemsize: int):
    """The JAX ``_plan``, a pure function of shapes: consecutive parts grouped
    into calls within the weight budget, and a spatial tile within the VMEM
    budget; (groups, ts) or None."""
    sizes = _part_weight_bytes(c, ia, iff, itemsize)
    if any(sizes[p] > _WEIGHT_BUDGET for p in parts):
        return None
    groups, cur, cur_bytes = [], [], 0
    for part in parts:
        if cur and cur_bytes + sizes[part] > _WEIGHT_BUDGET:
            groups.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(part)
        cur_bytes += sizes[part]
    if cur:
        groups.append(tuple(cur))

    def act_bytes(group, cand):
        a = f * cand * 4 * c
        if "attn" in group:
            a += f * cand * 6 * max(c, ia) * itemsize
            a += 10 * (f * cand) ** 2
        if "ffin" in group or "ff" in group:
            a += f * cand * 4 * iff * itemsize
        return a

    for cand in (64, 32, 16, 8):
        if s % cand:
            continue
        worst = max(sum(sizes[p] for p in g) + act_bytes(g, cand) for g in groups)
        if worst <= _VMEM_BUDGET:
            return groups, cand
    return None


def dispatch_mode(b: int, f: int, s: int, c: int, ia: int, iff: int,
                  dtype: torch.dtype) -> Optional[str]:
    """How to run a (b, f, s, c) temporal block with attention inner dim ia and
    FF inner dim iff: "full", "hybrid" or None (the module path). The JAX rule
    (``ops/fused_temporal.py:dispatch_mode``) without its device test and its
    tuning switches: bf16 and at most 32 frames, then "full" where ``_plan``
    puts the three parts in one call, "hybrid" where it takes the "attn" part."""
    if dtype != torch.bfloat16 or f > 32:
        return None
    itemsize = 2
    full = _plan(("ffin", "attn", "ff"), c, ia, iff, s, f, itemsize)
    if full is not None and len(full[0]) == 1:
        return "full"
    if _plan(("attn",), c, ia, iff, s, f, itemsize) is not None:
        return "hybrid"
    return None


@dataclass(frozen=True)
class HybridPlan:
    ts: int             # positions per tile: rows p * fp + i, fp = f rounded up to 16
    mode: str           # the A tile: "resident", "alias" (Q/K/V on the ring), "streamed"
    heads_per_cta: int
    grid: tuple         # QKV + attention kernel: (s / ts, heads / heads_per_cta, b)
    smem_bytes: int
    out_n: int          # out-projection column tile
    out_grid: tuple     # (c / out_n, ceil(b * f * s / 128)): column tiles of a row tile together
    out_smem_bytes: int


HYBRID_MODES = ("resident", "alias", "streamed")
_RING = 4 * 3 * 64 * 64          # four slots of 64 rows each of Wq, Wk, Wv x 32 channels
_QKV = 3 * _HYBRID_ROWS * 128     # the Q, K and V tiles of one head (128-byte rows)
_BLOCK = _HYBRID_ROWS * 128       # a 64-channel column block of the A tile
_OUT_STAGES = 3


def _hybrid_smem(mode: str, c: int) -> int:
    """``HybridCfg``: the A tile (two column blocks when streamed), the four-slot
    ring, the Q/K/V tiles (on the ring under "alias"), per-row mean and rstd,
    128 bytes of mbarriers and 1 KiB of alignment slack."""
    a_tile = 2 * _BLOCK if mode == "streamed" else _HYBRID_ROWS * c * 2
    ring = 0 if mode == "alias" else _RING
    return a_tile + ring + _QKV + 2 * _HYBRID_ROWS * 4 + 128 + 1024


@lru_cache(maxsize=None)
def hybrid_plan(b: int, f: int, s: int, c: int, heads: int, sms: int = 132) -> HybridPlan:
    """The two launches of K3 hybrid on a card of ``sms`` SMs; raises for what
    the kernel does not take.

    - tile: the largest power-of-two ts with s % ts == 0 and fp * ts <= 128;
    - mode: the first of "resident", "alias", "streamed" whose shared memory
      fits (c <= 512; c <= 704; any c);
    - heads per CTA: the divisor of ``heads`` with the fewest waves x (heads
      per CTA + 1), one CTA an SM, the + 1 standing for the tile's LayerNorm;
    - the out-projection: 128 x out_n tiles (out_n 128 where it divides c,
      else 64) over a three-slot ring of 128 + out_n rows of 128 bytes.
    ``csrc/temporal_attention.cu`` refuses any other plan."""
    if f < 1 or f > 32 or c < 64 or c % 64 or heads < 1:
        raise ValueError(f"temporal_block: kernel needs f <= 32 and c % 64 == 0; got f={f} "
                         f"c={c} heads={heads}")
    fp = -(-f // 16) * 16
    ts = 1
    while fp * ts * 2 <= _HYBRID_ROWS and s % (ts * 2) == 0:
        ts *= 2
    mode = next(m for m in HYBRID_MODES
                if m == "streamed" or _hybrid_smem(m, c) <= SMEM_PER_BLOCK)
    tiles = b * (s // ts)
    hpc = min((d for d in range(1, heads + 1) if heads % d == 0),
              key=lambda d: (-(-tiles * (heads // d) // sms) * (d + 1), -d))
    out_n = 128 if c % 128 == 0 else 64
    return HybridPlan(ts=ts, mode=mode, heads_per_cta=hpc, grid=(s // ts, heads // hpc, b),
                      smem_bytes=_hybrid_smem(mode, c), out_n=out_n,
                      out_grid=(c // out_n, -(-(b * f * s) // _HYBRID_ROWS)),
                      out_smem_bytes=_OUT_STAGES * (_BLOCK + out_n * 128) + 64 + 1024)


def temporal_block(x: torch.Tensor, cross_bias: Optional[torch.Tensor], ln_w, ln_b, wq,
                   wk, wv, wo, bo, heads: int, eps: float = 1e-5) -> torch.Tensor:
    """``x + to_out(attn_over_frames(LN1(x))) (+ cross_bias[:, None])`` on
    (b, f, s, c): K3 "hybrid" on a Hopper card, its gradient the plain
    version's (``mirror_vjp``); the plain version on the CPU."""
    if x.device.type == "cpu":
        return _torch_temporal_block(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)
    return mirror_vjp.apply(_hybrid_kernel, _torch_temporal_block, x, cross_bias, ln_w, ln_b,
                            wq, wk, wv, wo, bo, heads, eps)


def _hybrid_kernel(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps):
    if not is_hopper(x):
        raise RuntimeError(f"temporal_block: kernel needs an sm_90 device, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"temporal_block: x must be (b, f, s, c), got {tuple(x.shape)}")
    b, f, s, c = x.shape
    ia = heads * KERNEL_HEAD_DIM
    if wq.shape[0] != ia:
        raise ValueError(f"temporal_block: kernel needs head dim 64; got ia={wq.shape[0]} "
                         f"for {heads} heads")
    plan = hybrid_plan(b, f, s, c, heads, sm_count(x.device))
    expect = {"ln_w": (c,), "ln_b": (c,), "wq": (ia, c), "wk": (ia, c), "wv": (ia, c),
              "wo": (c, ia), "bo": (c,)}
    tensors = dict(x=x, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    if cross_bias is not None:
        expect["cross_bias"] = (b, s, c)
        tensors["cross_bias"] = cross_bias
    for name, t in tensors.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"temporal_block: {name} shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
        if (t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"temporal_block: {name} must be contiguous, 16-byte aligned "
                             f"bfloat16 on {x.device}")
    o = torch.empty((b, f, s, ia), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    KERNEL(ptr(x), ptr(ln_w), ptr(ln_b), ptr(wq), ptr(wk), ptr(wv), ptr(o), ptr(wo), ptr(bo),
           None if cross_bias is None else ptr(cross_bias), ptr(out),
           b, f, s, c, heads, plan.ts, HYBRID_MODES.index(plan.mode), plan.heads_per_cta,
           *plan.grid, plan.smem_bytes, plan.out_n, *plan.out_grid, plan.out_smem_bytes,
           float(eps), float(KERNEL_HEAD_DIM ** -0.5), stream_of(x))
    return out


@dataclass(frozen=True)
class FullPlan:
    ts: int            # positions per CTA: f * ts rows
    grid: tuple        # (s / ts, b)
    smem_bytes: int


def _full_tile(f: int, s: int) -> int:
    # the attention's 16-row MMA tiles read up to (-f mod 16) rows past the last frame
    pad = -f % 16
    ts = 1
    while f * ts * 2 + pad <= _FULL_ROWS and s % (ts * 2) == 0:
        ts *= 2
    return ts


def full_plan(b: int, f: int, s: int, c: int, heads: int, inner: int) -> FullPlan:
    """The launch of K3 full: the largest power-of-two tile of ts positions
    with f * ts + (-f mod 16) <= 128 rows, one CTA per tile, and the shared
    memory of the A tile, the two-slot weight ring, the O, Q, K and V tiles
    (128-byte rows) and the mbarriers (+ 1 KiB alignment slack).
    ``csrc/temporal_full.cu`` launches this grid and refuses shared memory other
    than its ``FullCfg``'s."""
    if f > 32 or c not in _FULL_WIDTHS or inner % _FULL_CHUNK or heads < 1:
        raise ValueError(f"temporal_block_full: kernel needs f <= 32, c in {_FULL_WIDTHS}, "
                         f"head dim 64 and an FF inner width % {_FULL_CHUNK} == 0; got f={f} "
                         f"c={c} heads={heads} inner={inner}")
    ts = _full_tile(f, s)
    smem = 2 * 128 * c + 2 * 128 * c + 4 * 128 * KERNEL_HEAD_DIM * 2 + 32 + 1024
    assert smem <= SMEM_PER_BLOCK
    return FullPlan(ts=ts, grid=(s // ts, b), smem_bytes=smem)


def temporal_block_full(x: torch.Tensor, cross_bias: Optional[torch.Tensor], ln_w, ln_b, wq,
                        wk, wv, wo, bo, heads: int, eps: float, ffin: tuple, ff: tuple,
                        approximate: bool) -> torch.Tensor:
    """The whole block, ``ff(attn(ffin(x)))`` on (b, f, s, c): K3 "full" (one
    launch) on a Hopper card, its gradient the plain version's
    (``mirror_vjp``); the plain version on the CPU. ``ffin`` and ``ff`` are
    ``(ln_w, ln_b, wg, bg, w2, b2)``; their gelu is the tanh form if
    ``approximate``, else erf."""
    if x.device.type == "cpu":
        return _torch_temporal_block(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps,
                                     ffin, ff, approximate)
    return mirror_vjp.apply(_full_kernel, _torch_temporal_block, x, cross_bias, ln_w, ln_b, wq,
                            wk, wv, wo, bo, heads, eps, ffin, ff, approximate)


def _full_kernel(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps, ffin, ff,
                 approximate):
    if not is_hopper(x):
        raise RuntimeError(f"temporal_block_full: kernel needs an sm_90 device, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"temporal_block_full: x must be (b, f, s, c), got {tuple(x.shape)}")
    b, f, s, c = x.shape
    ia = heads * KERNEL_HEAD_DIM
    iff = ffin[4].shape[1]
    if wq.shape[0] != ia:
        raise ValueError(f"temporal_block_full: kernel needs head dim 64; got ia={wq.shape[0]} "
                         f"for {heads} heads")
    plan = full_plan(b, f, s, c, heads, iff)
    ff_shapes = ((c,), (c,), (2 * iff, c), (2 * iff,), (c, iff), (c,))
    expect = {"ln_w": (c,), "ln_b": (c,), "wq": (ia, c), "wk": (ia, c), "wv": (ia, c),
              "wo": (c, ia), "bo": (c,)}
    tensors = dict(x=x, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    for prefix, weights in (("ffin", ffin), ("ff", ff)):
        for i, (t, shape) in enumerate(zip(weights, ff_shapes)):
            tensors[f"{prefix}[{i}]"] = t
            expect[f"{prefix}[{i}]"] = shape
    if cross_bias is not None:
        expect["cross_bias"] = (b, s, c)
        tensors["cross_bias"] = cross_bias
    for name, t in tensors.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"temporal_block_full: {name} shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"temporal_block_full: {name} must be bfloat16, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"temporal_block_full: {name} must be contiguous and 16-byte "
                             f"aligned on {x.device}")
    out = torch.empty_like(x)
    KERNEL_FULL(ptr(x), *(ptr(t) for t in ffin), ptr(ln_w), ptr(ln_b), ptr(wq), ptr(wk),
                ptr(wv), ptr(wo), ptr(bo), *(ptr(t) for t in ff),
                None if cross_bias is None else ptr(cross_bias), ptr(out),
                b, f, s, c, heads, iff, plan.ts, *plan.grid, plan.smem_bytes,
                int(not approximate), float(eps), float(KERNEL_HEAD_DIM ** -0.5), stream_of(x))
    return out
