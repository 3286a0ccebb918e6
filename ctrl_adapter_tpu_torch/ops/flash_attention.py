"""Attention dispatch: flash kernel K2 for large self-attention, plain torch else.

Counterpart of ``ctrl_adapter_tpu/ops/flash_attention.py``. The dispatch rule
is the JAX shape rule (``flash_eligible``/``_eligible``): self-attention with
T >= 1024, T % 512 == 0 and head_dim in {64, 128}, whatever the device and
dtype. :func:`attention_bnth` runs its plain version for a tensor on the CPU
and launches the kernel, or raises, for a tensor on a card.

Kernel K2 (``csrc/flash_attention.cu``) takes (B, N, T, H) views whose last
stride is 1, so callers pass head-split views of their (B, T, N*H) projections
without transposing them, and read the output the same way. It loads them with
TMA: :func:`plan` (tiles, grid, shared memory) and :func:`tma_view_error` (the
strides and alignment a tensor map needs) are its host-side planning, in plain
Python so that the CPU tests check them. The launch takes the plan's grid and
shared memory, and the C side refuses a plan that differs from its ``Cfg``.

Under grad, :func:`attention_bnth` goes through :class:`FlashAttention`, the
port of the Pallas kernel's custom VJP: the forward also writes each row's
log-sum-exp (fp32), and the backward is kernel K2 bwd
(``csrc/flash_attention_bwd.cu``, planned by :func:`bwd_plan`) on a card and
:func:`_torch_attention_bwd` on the CPU. K2 bwd adds the key blocks' dQ
partials into each query tile in a turn order fixed by the indices (a
counter per tile), so its gradients are the same bits from call to call, as
the Pallas kernel's are. Without grad the forward writes no log-sum-exp and
saves nothing.

The kernels are picked by dtype: bf16 inputs take the wgmma kernels above;
fp32 inputs (fp32 towers, ``--mixed_precision no``) take K2 fp32
(``csrc/flash_attention_fp32.cu``) and K2 bwd fp32
(``csrc/flash_attention_fp32_bwd.cu``): 3xTF32 wgmma products (hi and lo tf32
parts of each operand, three tensor-core passes, fp32's accuracy) on tiles that
a prologue launch splits into a workspace the wrapper allocates, planned by
:func:`fp32_plan` and :func:`fp32_bwd_plan`; their gradients are sums in a
fixed order, the same bits from call to call. Any other dtype raises on a card.

Head dims 40 and 80 (the SD-v1.5 ControlNet's 8 heads at 320 and 640
channels) are outside the JAX rule, so ``Attention`` sends them to
:func:`dot_product_attention`. There, bf16 self-attention at T >= 1024 on a
Hopper card without grad (:func:`narrow_eligible`) takes :func:`attention_narrow`:
K2's forward at the padded head dim, 64 or 128 (:data:`NARROW_HEADS`), whose
tensor maps declare the true H columns so that TMA fills the rest of each tile
with zeros (``csrc/flash_attention.cu``, ``flash_fwd_narrow_kernel``), counted
by :data:`KERNEL_NARROW` apart from K2's own launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils import profiling
from ._build import Kernel, ptr, stream_of
from .backend import SMEM_PER_BLOCK, is_hopper, sm_count

MIN_SEQ = 1024
_BLOCK = 512
_LOGITS_BYTES = 1 << 30  # plain attention: fp32 logits per batch chunk

KERNEL = Kernel("cak_flash_attention", [
    *([ctypes.c_void_p] * 5), *([ctypes.c_int] * 6),
    *([ctypes.c_int64] * 12), ctypes.c_float, ctypes.c_void_p,
])
KERNEL_BWD = Kernel("cak_flash_attention_bwd", [
    *([ctypes.c_void_p] * 12), *([ctypes.c_int] * 7), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_float, ctypes.c_void_p,
])
KERNEL_FP32 = Kernel("cak_flash_attention_fp32", [
    *([ctypes.c_void_p] * 6), *([ctypes.c_int] * 5), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_float, ctypes.c_void_p,
])
KERNEL_FP32_BWD = Kernel("cak_flash_attention_fp32_bwd", [
    *([ctypes.c_void_p] * 11), *([ctypes.c_int] * 6), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_float, ctypes.c_void_p,
])
KERNEL_NARROW = Kernel(KERNEL.symbol, KERNEL.argtypes)  # K2 at H = 40 or 80 (bf16)
DTYPES = (torch.bfloat16, torch.float32)  # the types the kernels take
NARROW_HEADS = {40: 64, 80: 128}  # head dim -> the tile width K2 runs it at


BLOCK_Q = 128     # query rows per CTA: two consumer warpgroups of 64
BLOCK_K = 128     # keys per K/V tile
_SLACK = 1024     # shared-memory alignment slack (1024-byte swizzle atoms)


@dataclass(frozen=True)
class FlashPlan:
    work: int          # Q tiles over all (b, n) pairs
    grid: tuple        # persistent CTAs: one per SM, at most one per Q tile
    stages: int        # K/V ring slots
    smem_bytes: int    # Q tile, K and V rings, mbarriers, 1 KiB alignment slack


def plan(b: int, n: int, t: int, h: int, sms: int) -> FlashPlan:
    """The launch of K2 for (b, n, t, h) inputs on a card of ``sms`` SMs; raises
    where the tiling does not fit. ``csrc/flash_attention.cu`` launches this
    grid and refuses shared memory other than its ``Cfg``'s."""
    if h not in (64, 128) or t % BLOCK_Q or t < BLOCK_Q:
        raise ValueError(f"attention_bnth: needs H in (64, 128) and T a multiple of {BLOCK_Q}, "
                         f"got T={t} H={h}")
    stages = 3 if h == 64 else 2
    tile = BLOCK_K * h * 2
    smem = tile * (1 + 2 * stages) + 8 * (2 + 3 * stages) + 1024
    assert smem <= SMEM_PER_BLOCK
    work = (t // BLOCK_Q) * b * n
    return FlashPlan(work=work, grid=(min(work, sms),), stages=stages, smem_bytes=smem)


def narrow_plan(b: int, n: int, t: int, h: int, sms: int) -> FlashPlan:
    """The launch of K2 for (b, n, t, h) inputs at H = 40 or 80: :func:`plan`
    at the padded head dim, whose ``Cfg`` the C side runs it with."""
    if h not in NARROW_HEADS:
        raise ValueError(f"attention_narrow: needs H in {tuple(NARROW_HEADS)}, got H={h}")
    return plan(b, n, t, NARROW_HEADS[h], sms)


BWD_KEYS = 128     # backward: keys per CTA, two consumer warpgroups of 64


@dataclass(frozen=True)
class FlashBwdPlan:
    grid: tuple        # (T / 128 key blocks, B * N) CTAs; each takes its (b, n, key
    #                    block) from a ticket as it starts, key blocks the fastest
    q_tile: int        # queries per streamed Q / dO tile: 128 at H = 64, 64 at H = 128
    smem_bytes: int    # K, V; two slots of Q, dO, L, D; two dS^T buffers; the two
    #                    consumers' fp32 dQ partials; 9 mbarriers and the ticket's
    #                    8 bytes; 1 KiB alignment slack
    scratch: tuple     # the fp32 dQ scratch, (B, N, T, H) contiguous
    counters: int      # dQ's turn counters, one int32 per (b, n, query tile)
    sync_bytes: int    # the int32 buffer of the counters and the ticket
    group: int         # key blocks that take their turns round a cycle (``bwd_group``)


def bwd_group(key_blocks: int, sms: int) -> int:
    """The key blocks of a (b, n) pair that take their dQ turns round one
    cycle: the largest divisor of ``key_blocks`` not above ``sms``. Each
    cycle must be resident at once (one CTA an SM), and the cycles of a pair
    follow one another (``csrc/flash_attention_bwd.cu``, "No deadlock")."""
    return max(g for g in range(1, min(key_blocks, sms) + 1) if key_blocks % g == 0)


def bwd_plan(b: int, n: int, t: int, h: int, sms: int) -> FlashBwdPlan:
    """The launches of K2's backward for (b, n, t, h) inputs on a card of
    ``sms`` SMs; raises where the tiling does not fit. ``csrc/flash_attention_bwd.cu``
    refuses a query tile or shared memory other than its ``BwdCfg``'s, and
    adds dQ's partials into the scratch through a 2-D TMA map of (B * N * T)
    rows of H fp32 values, each query tile's in the turns of its counter."""
    if h not in (64, 128) or t % BWD_KEYS or t < BWD_KEYS or b * n > 65535:
        raise ValueError(f"attention_bnth backward: needs H in (64, 128), T a multiple of "
                         f"{BWD_KEYS} and B*N <= 65535, got B*N={b * n} T={t} H={h}")
    why = tma_view_error((b * n * t, h), (h, 1), 0, itemsize=4)
    if why is not None:
        raise ValueError(f"attention_bnth backward: the fp32 dQ scratch {why}")
    q_tile = 128 if h == 64 else 64
    kv = 2 * BWD_KEYS * h * 2
    q_do = 2 * 2 * q_tile * h * 2
    ds = 2 * BWD_KEYS * q_tile * 2
    dq_partials = 2 * 64 * 64 * 4
    l_d = 2 * 2 * q_tile * 4
    smem = kv + q_do + ds + dq_partials + l_d + 8 * 9 + 8 + _SLACK
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"attention_bnth backward: {smem} bytes of shared memory at H={h}, "
                         f"over the {SMEM_PER_BLOCK} a block may have")
    counters = b * n * t // q_tile
    return FlashBwdPlan(grid=(t // BWD_KEYS, b * n), q_tile=q_tile, smem_bytes=smem,
                        scratch=(b, n, t, h), counters=counters, sync_bytes=4 * (counters + 1),
                        group=bwd_group(t // BWD_KEYS, sms))


FP32_ROWS = 64    # fp32 kernels: rows of a consumer warpgroup's tile (wgmma m64)
FP32_KEYS = 64    # K2 fp32: keys per step
FP32_FWD_BUFS = 6     # K2 fp32's workspace: Q, K (natural), V^T; hi and lo each
FP32_BWD_BUFS = 14    # K2 bwd fp32's: Q, K, V, dO (natural), Q^T, K^T, dO^T; hi and lo


def _fp32_consumers(h: int) -> int:
    """Consumer warpgroups of the fp32 kernels: two at H = 64 (128 rows a CTA),
    one at H = 128 (the tiles of two would not fit in shared memory)."""
    return 2 if h == 64 else 1


def _fp32_step(h: int) -> int:
    """Rows a step streams in K2 bwd fp32's kernels: 32 at H = 64, 16 at H = 128."""
    return 2048 // h


def _fp32_shape_error(b: int, n: int, t: int, h: int, bufs: int) -> Optional[str]:
    if h not in (64, 128) or t % FP32_ROWS or t < FP32_ROWS or not 0 < b * n <= 65535:
        return (f"needs H in (64, 128), T a multiple of {FP32_ROWS} and 0 < B*N <= 65535, "
                f"got B*N={b * n} T={t} H={h}")
    if bufs * b * n * max(t, h) >= 2 ** 31:  # TMA's signed 32-bit row coordinates
        return f"the workspace's {bufs} x B*N*T rows exceed 2^31, got B*N={b * n} T={t}"
    return None


def _fp32_grid(b: int, n: int, t: int, h: int) -> tuple:
    rows = FP32_ROWS * _fp32_consumers(h)
    return (-(-t // rows), b * n)


@dataclass(frozen=True)
class Fp32Plan:
    grid: tuple        # (ceil(T / (64 consumers)) query blocks, B * N)
    stages: int        # K / V^T ring slots
    smem_bytes: int    # Q (hi, lo) per consumer, the ring of K and V^T (hi, lo),
    #                    mbarriers, alignment slack (csrc/flash_attention_fp32.cu:FwdCfg)
    workspace: int     # fp32 elements: FP32_FWD_BUFS buffers of B N T H


def fp32_plan(b: int, n: int, t: int, h: int) -> Fp32Plan:
    """The launches of K2 fp32 (the split prologue and the main kernel) for
    (b, n, t, h) inputs; raises where the tiling does not fit.
    ``cak_flash_attention_fp32`` refuses other shared memory."""
    why = _fp32_shape_error(b, n, t, h, FP32_FWD_BUFS)
    if why is not None:
        raise ValueError(f"attention_bnth (fp32): {why}")
    c, stages = _fp32_consumers(h), 2 if h == 64 else 1
    tile = FP32_ROWS * h * 4
    smem = 2 * c * tile + stages * 4 * FP32_KEYS * h * 4 + 8 * (1 + 4 * stages) + _SLACK
    assert smem <= SMEM_PER_BLOCK
    return Fp32Plan(grid=_fp32_grid(b, n, t, h), stages=stages, smem_bytes=smem,
                    workspace=FP32_FWD_BUFS * b * n * t * h)


@dataclass(frozen=True)
class Fp32BwdPlan:
    grid: tuple        # each main kernel: (ceil(T / (64 consumers)) row blocks, B * N)
    step: int          # rows streamed a step
    smem_dkv: int      # K, V (hi, lo) per consumer; one stage of Q, dO, Q^T, dO^T (hi, lo)
    smem_dq: int       # Q, dO (hi, lo) per consumer; two stages of K, V, K^T (hi, lo)
    workspace: int     # fp32 elements: FP32_BWD_BUFS buffers of B N T H


def fp32_bwd_plan(b: int, n: int, t: int, h: int) -> Fp32BwdPlan:
    """The launches of K2 bwd fp32 (the split prologue with D; dK and dV; dQ)
    for (b, n, t, h) inputs; raises where the tiling does not fit.
    ``cak_flash_attention_fp32_bwd`` refuses other shared memory."""
    why = _fp32_shape_error(b, n, t, h, FP32_BWD_BUFS)
    if why is not None:
        raise ValueError(f"attention_bnth backward (fp32): {why}")
    c, step = _fp32_consumers(h), _fp32_step(h)
    fixed = 4 * c * FP32_ROWS * h * 4
    tile = step * h * 4
    dkv = fixed + 8 * tile + 8 * (1 + 4) + _SLACK
    dq = fixed + 2 * 6 * tile + 8 * (1 + 4 * 2) + _SLACK
    assert max(dkv, dq) <= SMEM_PER_BLOCK
    return Fp32BwdPlan(grid=_fp32_grid(b, n, t, h), step=step, smem_dkv=dkv, smem_dq=dq,
                       workspace=FP32_BWD_BUFS * b * n * t * h)


def tma_view_error(shape, strides, data_ptr: int, itemsize: int = 2) -> Optional[str]:
    """None when a TMA tensor map can describe the view (element ``strides``),
    else what it lacks: a unit last stride, a 16-byte aligned base, other
    strides that are multiples of 16 bytes below 2^40, dims below 2^32."""
    if strides[-1] != 1:
        return f"needs a unit last stride, got {tuple(strides)}"
    if data_ptr % 16:
        return "needs a 16-byte aligned base address"
    for st in strides[:-1]:
        if (st * itemsize) % 16 or not 0 < st * itemsize < 2 ** 40:
            return f"needs strides of a multiple of 16 bytes, got {tuple(strides)}"
    if any(d >= 2 ** 32 for d in shape):
        return f"dims must be below 2^32, got {tuple(shape)}"
    return None


def flash_eligible(tq: int, tk: int, head_dim: int) -> bool:
    """The JAX shape rule for the flash kernel (``ops/flash_attention.py:71-94``)."""
    return tq == tk and tq >= MIN_SEQ and tq % _BLOCK == 0 and head_dim in (64, 128)


def narrow_eligible(tq: int, tk: int, head_dim: int, dtype: torch.dtype, hopper: bool,
                    grad: bool) -> bool:
    """Whether :func:`dot_product_attention` takes :func:`attention_narrow`: a
    self-attention of T >= 1024 keys, T a multiple of K2's 128-row tiles, at
    head dim 40 or 80, in bf16 on a Hopper card (``hopper``), with no input
    that needs a gradient (``grad``: the kernel saves nothing for a backward)."""
    return (tq == tk and tq >= MIN_SEQ and tq % BLOCK_Q == 0 and head_dim in NARROW_HEADS
            and dtype == torch.bfloat16 and hopper and not grad)


def _torch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     with_lse: bool = False):
    """softmax(q k^T / sqrt(H)) v over (B, N, T, H) with fp32 logits and softmax,
    probabilities cast to v's dtype (the math of ``jax.nn.dot_product_attention``).
    The batch*head axis runs in chunks that keep the fp32 logits near 1 GiB.
    With ``with_lse``, also each row's log-sum-exp of the scaled logits,
    (B, N, T) fp32: returns (out, lse)."""
    b, n, t, h = q.shape
    s = k.shape[2]
    qf = q.reshape(b * n, t, h)
    kf = k.reshape(b * n, s, h)
    vf = v.reshape(b * n, s, h)
    out = torch.empty((b * n, t, h), dtype=v.dtype, device=v.device)
    lse = torch.empty((b * n, t), dtype=torch.float32, device=v.device) if with_lse else None
    step = max(1, _LOGITS_BYTES // (t * s * 4))
    scale = h ** -0.5
    for i in range(0, b * n, step):
        logits = torch.matmul(qf[i:i + step].float(),
                              kf[i:i + step].float().transpose(1, 2)) * scale
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out[i:i + step] = torch.matmul(probs, vf[i:i + step])
        if with_lse:
            lse[i:i + step] = torch.logsumexp(logits, dim=-1)
    out = out.reshape(b, n, t, h)
    return (out, lse.reshape(b, n, t)) if with_lse else out


def _torch_attention_bwd(q, k, v, o, do, lse):
    """dQ, dK, dV of :func:`_torch_attention` from its output ``o``, its
    log-sum-exp ``lse`` and the output gradient ``do``, over (B, N, T, H), in
    fp32 and returned in q's dtype: with s = H^-1/2, P = exp(s Q K^T - L),
    D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - D), dQ = s dS K,
    dK = s dS^T Q. The batch*head axis runs in chunks that keep the three fp32
    (T, S) temporaries near 1 GiB."""
    b, n, t, h = q.shape
    s = k.shape[2]
    flat = lambda x, rows: x.reshape(b * n, rows, h)  # noqa: E731
    qf, kf, vf, of, dof = flat(q, t), flat(k, s), flat(v, s), flat(o, t), flat(do, t)
    lf = lse.reshape(b * n, t)
    grads = [torch.empty((b * n, rows, h), dtype=q.dtype, device=q.device)
             for rows in (t, s, s)]
    step = max(1, _LOGITS_BYTES // (3 * t * s * 4))
    scale = h ** -0.5
    for i in range(0, b * n, step):
        sl = slice(i, i + step)
        qc, kc, vc, oc, doc = (x[sl].float() for x in (qf, kf, vf, of, dof))
        p = torch.exp(torch.matmul(qc, kc.transpose(1, 2)) * scale - lf[sl, :, None].float())
        dp = torch.matmul(doc, vc.transpose(1, 2))
        ds = p * (dp - (doc * oc).sum(-1, keepdim=True))
        grads[0][sl] = torch.matmul(ds, kc) * scale
        grads[1][sl] = torch.matmul(ds.transpose(1, 2), qc) * scale
        grads[2][sl] = torch.matmul(p.transpose(1, 2), doc)
    return tuple(g.reshape(b, n, -1, h) for g in grads)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """``t`` is of ``dtype`` (bf16 or fp32) and a view the kernels can load:
    the rules of a TMA tensor map (bf16), or of the fp32 prologue's float4
    loads, which are the same 16-byte alignments."""
    if dtype not in DTYPES or t.dtype != dtype:
        raise TypeError(f"attention_bnth: {name} must be bfloat16 or float32 like q, got "
                        f"{t.dtype} (q {dtype})")
    why = tma_view_error(t.shape, t.stride(), t.data_ptr(), t.element_size())
    if why is not None:
        raise ValueError(f"attention_bnth: {name} {why}")


def attention_bnth(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over (B, N, T, H) views. Kernel K2 on a Hopper card (K2
    fp32 for float32 inputs), the plain version on the CPU; under grad through
    :class:`FlashAttention`.
    Returns a (B, N, T, H) view of a (B, T, N, H) contiguous tensor."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v, False)


class FlashAttention(torch.autograd.Function):
    """Attention with K2's custom VJP: the forward saves Q, K, V, the output
    and its row log-sum-exp; the backward is K2 bwd on a card and
    :func:`_torch_attention_bwd` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v, True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors  # read once: checkpointing allows one unpack
        return attention_bnth_bwd(q, k, v, o, do, lse)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool):
    """K2 (the plain version on the CPU); with ``with_lse``, (out, lse)."""
    if q.device.type == "cpu":
        return _torch_attention(q, k, v, with_lse)
    if not is_hopper(q):
        raise RuntimeError(f"attention_bnth: kernel needs an sm_90 device, got {q.device}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"attention_bnth: self-attention shapes differ: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, n, t, h = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"attention_bnth: {name} on {x.device}, q on {q.device}")
        _check(name, x, q.dtype)
    out = _bthn_empty(q)
    lse = (torch.empty((b, n, t), dtype=torch.float32, device=q.device) if with_lse
           else None)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    lse_ptr = None if lse is None else ptr(lse)
    if q.dtype == torch.float32:
        p32 = fp32_plan(b, n, t, h)
        ws = torch.empty(p32.workspace, dtype=torch.float32, device=q.device)
        KERNEL_FP32(ptr(q), ptr(k), ptr(v), ptr(out), lse_ptr, ptr(ws), b, n, t, h,
                    p32.smem_bytes, (ctypes.c_int64 * 12)(*strides), float(h ** -0.5),
                    stream_of(q))
    else:
        p = plan(b, n, t, h, sm_count(q.device))
        KERNEL(ptr(q), ptr(k), ptr(v), ptr(out), lse_ptr, b, n, t, h, p.grid[0], p.smem_bytes,
               *strides, float(h ** -0.5), stream_of(q))
    return (out, lse) if with_lse else out


def _bthn_empty(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, N, T, H) view of a (B, T, N, H) contiguous tensor."""
    b, n, t, h = q.shape
    return torch.empty((b, t, n, h), dtype=q.dtype, device=q.device).transpose(1, 2)


def attention_bnth_bwd(q, k, v, o, do, lse):
    """dQ, dK, dV of :func:`attention_bnth` from its output ``o``, log-sum-exp
    ``lse`` and the output gradient ``do``: on a Hopper card kernel K2 bwd for
    bf16 (one call, three launches: D with the zeroed fp32 dQ scratch and turn
    counters; dK, dV and dQ's sums, each query tile's in a fixed turn order;
    dQ) or K2 bwd fp32 for float32 (one call, three launches: the split
    prologue with D; dK and dV; dQ), the plain version on the CPU. The
    gradients are (B, N, T, H) views of (B, T, N, H) contiguous tensors, the
    same bit for bit from call to call in both types."""
    if q.device.type == "cpu":
        return _torch_attention_bwd(q, k, v, o, do, lse)
    if not is_hopper(q):
        raise RuntimeError(f"attention_bnth_bwd: kernel needs an sm_90 device, got {q.device}")
    b, n, t, h = q.shape
    fp32 = q.dtype == torch.float32
    p = fp32_bwd_plan(b, n, t, h) if fp32 else bwd_plan(b, n, t, h, sm_count(q.device))
    if tma_view_error(do.shape, do.stride(), do.data_ptr(), do.element_size()) is not None:
        do = do.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"attention_bnth_bwd: {name} is {tuple(x.shape)} on {x.device}, "
                             f"q {tuple(q.shape)} on {q.device}")
        _check(name, x, q.dtype)
    if (lse.shape != (b, n, t) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device or lse.data_ptr() % 16):
        raise ValueError("attention_bnth_bwd: lse must be a contiguous, 16-byte aligned "
                         f"(B, N, T) float32 tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dq, dk, dv = _bthn_empty(q), _bthn_empty(q), _bthn_empty(q)
    dvec = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    if fp32:
        strides = (ctypes.c_int64 * 24)(*(st for x in (q, k, v, o, do, dq, dk, dv)
                                          for st in x.stride()[:3]))
        ws = torch.empty(p.workspace, dtype=torch.float32, device=q.device)
        KERNEL_FP32_BWD(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dvec), ptr(ws),
                        ptr(dq), ptr(dk), ptr(dv), b, n, t, h, p.smem_dkv, p.smem_dq, strides,
                        float(h ** -0.5), stream_of(q))
        return dq, dk, dv
    dq_acc = torch.empty(p.scratch, dtype=torch.float32, device=q.device)
    sync = torch.empty(p.sync_bytes // 4, dtype=torch.int32, device=q.device)  # zeroed in-kernel
    strides = (ctypes.c_int64 * 24)(*(st for x in (q, k, v, o, do, dq, dk, dv)
                                      for st in x.stride()[:3]))
    KERNEL_BWD(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dvec), ptr(dq_acc),
               ptr(sync), ptr(dq), ptr(dk), ptr(dv), b, n, t, h, p.q_tile, p.smem_bytes,
               p.group, strides, float(h ** -0.5), stream_of(q))
    return dq, dk, dv


def attention_narrow(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over (B, N, T, H) bf16 views at H = 40 or 80 on a Hopper
    card, without grad: K2 at the padded head dim (:func:`narrow_plan`), one
    launch counted by :data:`KERNEL_NARROW`; raises for a view TMA cannot map.
    Returns a (B, N, T, H) view of a (B, T, N, H) contiguous tensor."""
    if not is_hopper(q):
        raise RuntimeError(f"attention_narrow: kernel needs an sm_90 device, got {q.device}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"attention_narrow: self-attention shapes differ: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"attention_narrow: {name} on {x.device}, q on {q.device}")
        _check(name, x, torch.bfloat16)
    b, n, t, h = q.shape
    p = narrow_plan(b, n, t, h, sm_count(q.device))
    out = _bthn_empty(q)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    KERNEL_NARROW(ptr(q), ptr(k), ptr(v), ptr(out), None, b, n, t, h, p.grid[0], p.smem_bytes,
                  *strides, float(h ** -0.5), stream_of(q))
    return out


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, N, H) attention: K2 at head dims 40 and 80 where
    :func:`narrow_eligible` admits the call (span ``op.attention.narrow``), else
    the single-key, tiny-sequence and plain paths of the JAX dispatcher (span
    ``op.attention.plain``)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if narrow_eligible(q.shape[1], k.shape[1], q.shape[-1], q.dtype, is_hopper(q), grad):
        with profiling.span("op.attention.narrow"):
            return attention_narrow(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    with profiling.span("op.attention.plain"):
        tk = k.shape[1]
        if tk == 1:
            # softmax over one key is 1: the output is V broadcast over the queries
            return v.expand(q.shape[0], q.shape[1], *v.shape[2:]).to(v.dtype)
        if q.shape[1] <= 32 and tk <= 32:
            # tiny (frame) sequences: logits in the input dtype, softmax in fp32
            s = torch.einsum("btnh,bsnh->bnts", q, k) * q.shape[-1] ** -0.5
            p = torch.softmax(s.float(), dim=-1).to(v.dtype)
            return torch.einsum("bnts,bsnh->btnh", p, v)
        # flash-eligible self-attention never gets here: ``Attention`` sends it to
        # attention_bnth on head-split views of its projections
        return _torch_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)
