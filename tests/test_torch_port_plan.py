"""Host-side planning of the redesigned kernels, and the roofline arithmetic
that ``chip_smoke.py`` prints, against hand-worked cases. Plain Python on
shapes: runs on the CPU.

- K2 (``ops/flash_attention.py``): :func:`plan` (128-row Q tiles, the K/V ring,
  grid, shared memory), :func:`bwd_plan` (the backward's grid, query tile,
  shared memory, fp32 dQ scratch and dQ's turn counters, with a model of the
  turns: a fixed order and no deadlock) and :func:`tma_view_error` (what a
  TMA tensor map needs of a strided view, bf16 or fp32).
- K3 full (``ops/fused_temporal.py``): :func:`full_plan` (tile of ts
  positions, grid, shared memory).
- K3 hybrid (``ops/fused_temporal.py``): :func:`hybrid_plan` (tile, A-tile
  layout, heads per CTA, both grids and shared memories).
- K1 (``ops/group_norm.py``): :func:`plan` (branch, CTAs per group or groups
  per CTA, shared memory).
- K4 (``ops/fused_block.py``): :func:`plan` (tile rows, grid, ring depth,
  shared memory); K5 (``ops/fused_ff.py``): :func:`plan` (tiles,
  stages per tile, persistent grid, shared memory).

The kernels launch the plans' grids and refuse shared-memory sizes other than
their own configurations', so a plan that drifts from the C side fails on the
card instead of launching.
- ``ops/roofline.py``: FLOPs, bytes and the bound of every kernel row.
- ``chip_smoke.py``'s shape lists, per-step sums, per-step launch counts,
  the inputs of its gelu-form check and its device busy-time arithmetic.
"""

import glob
import os
from collections import Counter

import pytest
import torch

from ctrl_adapter_tpu_torch.ops import _build
from ctrl_adapter_tpu_torch.ops import flash_attention as fa
from ctrl_adapter_tpu_torch.ops import fused_block as fb
from ctrl_adapter_tpu_torch.ops import fused_ff as ff
from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
from ctrl_adapter_tpu_torch.ops import group_norm as gn
from ctrl_adapter_tpu_torch.ops import roofline as rl
from ctrl_adapter_tpu_torch.ops.backend import SMEM_PER_BLOCK


# ---------------------------------------------------------------- K2 plan
@pytest.mark.parametrize("b,n,t,h,work,grid,stages,smem", [
    # Q tile 16 KiB + 3 stages of K and V (16 KiB each) + 11 mbarriers + 1 KiB
    # slack; one persistent CTA per SM (132 on an H100) over the (T / 128) * B * N
    # Q tiles
    (28, 5, 4096, 64, 4480, (132,), 3, 7 * 16384 + 88 + 1024),
    (28, 10, 1024, 64, 2240, (132,), 3, 7 * 16384 + 88 + 1024),
    # H = 128: 32 KiB tiles, 2 stages
    (2, 3, 1024, 128, 48, (48,), 2, 5 * 32768 + 64 + 1024),
    (1, 1, 128, 64, 1, (1,), 3, 7 * 16384 + 88 + 1024),
    # the SDXL adapter's A blocks after the x2 upsample: 128 Q tiles (and 128
    # K/V tiles each) per (b, n) pair, 10 pairs; ~9.7 Q tiles per CTA, whose
    # running K/V tile count (1,280 at most) and row offsets (< 16,384) stay
    # far inside int32
    (2, 5, 16384, 64, 1280, (132,), 3, 7 * 16384 + 88 + 1024),
], ids=["unet-l0", "unet-l1", "h128", "one-tile", "sdxl-t16384"])
def test_flash_plan_hand_worked(b, n, t, h, work, grid, stages, smem):
    p = fa.plan(b, n, t, h, sms=132)
    assert (p.work, p.grid, p.stages, p.smem_bytes) == (work, grid, stages, smem)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert fa.plan(b, n, t, h, sms=16).grid == (min(work, 16),)


@pytest.mark.parametrize("t,h", [(1088, 64), (1024, 96), (64, 64), (1024, 32)])
def test_flash_plan_refuses_what_the_tiling_does_not_fit(t, h):
    with pytest.raises(ValueError):
        fa.plan(2, 3, t, h, sms=132)


# one pass: a CTA holds 128 keys (K, V) and streams Q, dO tiles of q_tile
# queries with their L, D (fp32) through two slots; dS^T (bf16, 128 keys x
# q_tile) in two buffers; each consumer's 64 x 64 fp32 dQ partial; 9 mbarriers
# (K/V, the Q/dO ring's full and empty, the staging slots' full and empty),
# the ticket's 8 bytes and 1 KiB of alignment slack. Grid: key blocks fastest.
_BWD_SMEM_H64 = 2 * 16384 + 4 * 16384 + 2 * 32768 + 2 * 16384 + 4 * 128 * 4 + 72 + 8 + 1024
_BWD_SMEM_H128 = 2 * 32768 + 4 * 16384 + 2 * 16384 + 2 * 16384 + 4 * 64 * 4 + 72 + 8 + 1024


# counters: one int32 per (b, n, query tile), B*N*T/q_tile; group: the key
# blocks of a pair that take their dQ turns round one cycle on 132 SMs
@pytest.mark.parametrize("b,n,t,h,grid,q_tile,smem,scratch,counters,group", [
    (14, 5, 4096, 64, (32, 70), 128, _BWD_SMEM_H64, (14, 5, 4096, 64), 2240, 32),
    (14, 10, 1024, 64, (8, 140), 128, _BWD_SMEM_H64, (14, 10, 1024, 64), 1120, 8),
    (2, 4, 1024, 128, (8, 8), 64, _BWD_SMEM_H128, (2, 4, 1024, 128), 128, 8),
    (65535, 1, 128, 64, (1, 65535), 128, _BWD_SMEM_H64, (65535, 1, 128, 64), 65535, 1),
    (1, 5, 16384, 64, (128, 5), 128, _BWD_SMEM_H64, (1, 5, 16384, 64), 640, 128),
], ids=["unet-up-t4096", "adapter-t1024", "h128", "largest-bn", "sdxl-t16384"])
def test_flash_bwd_plan_hand_worked(b, n, t, h, grid, q_tile, smem, scratch, counters, group):
    p = fa.bwd_plan(b, n, t, h, sms=132)
    assert (p.grid, p.q_tile, p.smem_bytes, p.scratch) == (grid, q_tile, smem, scratch)
    assert (p.counters, p.sync_bytes, p.group) == (counters, 4 * (counters + 1), group)
    assert p.counters == b * n * t // q_tile
    assert (_BWD_SMEM_H64, _BWD_SMEM_H128) == (199760, 198736)
    assert p.smem_bytes <= SMEM_PER_BLOCK == 232448
    # a second 32 KiB dQ staging slot (two consumers' 64 x 64 fp32) and its
    # two mbarriers would not fit
    assert _BWD_SMEM_H64 + 2 * 64 * 64 * 4 + 16 == SMEM_PER_BLOCK + 96


@pytest.mark.parametrize("h,smem", [(64, _BWD_SMEM_H64), (128, _BWD_SMEM_H128)])
def test_flash_bwd_plan_refuses_shared_memory_over_the_limit(monkeypatch, h, smem):
    """On a card that gave a block one byte less, the plan raises."""
    monkeypatch.setattr(fa, "SMEM_PER_BLOCK", smem)
    assert fa.bwd_plan(2, 3, 1024, h, sms=132).smem_bytes == smem
    monkeypatch.setattr(fa, "SMEM_PER_BLOCK", smem - 1)
    with pytest.raises(ValueError, match="shared memory"):
        fa.bwd_plan(2, 3, 1024, h, sms=132)


@pytest.mark.parametrize("b,n,t,h", [(1, 1, 1024, 80), (1, 1, 1000, 64), (1, 1, 64, 64),
                                     (65536, 1, 128, 64)])
def test_flash_bwd_plan_refuses_what_the_tiling_does_not_fit(b, n, t, h):
    with pytest.raises(ValueError):
        fa.bwd_plan(b, n, t, h, sms=132)


@pytest.mark.parametrize("key_blocks,sms,group", [
    (32, 132, 32), (8, 132, 8), (128, 132, 128), (256, 132, 128), (136, 132, 68),
    (128, 114, 64), (137, 132, 1), (1, 132, 1)])
def test_flash_bwd_group_hand_worked(key_blocks, sms, group):
    """The largest divisor of the key blocks not above the SM count: all of
    them up to T = 16384 on 132 SMs; cycles of 64 on a card of 114."""
    assert fa.bwd_group(key_blocks, sms) == group


def _bwd_turns(pairs, nk, nq, group, sms):
    """A model of K2 bwd's dQ writer (``csrc/flash_attention_bwd.cu``, "dQ in
    a fixed order" and "No deadlock"): CTAs start in ticket order on ``sms``
    slots, one a slot; a CTA's consumers stage step i once its writer has
    read step i - 1; its writer adds step i's partial to tile (first + i) mod
    nq when the tile's counter reads turn0 + i / span, then adds 1 to the
    counter. Returns each tile's key blocks in the order they added, or None
    where no CTA can move and some are not done (a deadlock)."""
    span = nq // group
    counters = [[0] * nq for _ in range(pairs)]
    order = [[[] for _ in range(nq)] for _ in range(pairs)]
    ticket, running, done = 0, [], 0
    while done < pairs * nk:
        while len(running) < sms and ticket < pairs * nk:
            bn, kb = divmod(ticket, nk)
            running.append({"bn": bn, "kb": kb, "first": (kb % group) * span,
                             "turn0": kb - kb % group, "staged": 0, "written": 0})
            ticket += 1
        moved = False
        for c in list(running):
            if c["staged"] < nq and c["staged"] <= c["written"]:  # one staging slot
                c["staged"] += 1
                moved = True
            i = c["written"]
            if i < c["staged"]:
                t = (c["first"] + i) % nq
                if counters[c["bn"]][t] >= c["turn0"] + i // span:
                    order[c["bn"]][t].append(c["kb"])
                    counters[c["bn"]][t] += 1
                    c["written"] += 1
                    moved = True
            if c["written"] == nq:
                running.remove(c)
                done += 1
        if not moved:
            return None
    return order


@pytest.mark.parametrize("pairs,t,h,sms", [
    (3, 4096, 64, 132), (5, 4096, 64, 40), (4, 1024, 128, 12), (2, 16384, 64, 132),
    (2, 16384, 64, 114), (2, 4096, 64, 12), (3, 1024, 64, 7), (1, 17408, 64, 132)],
    ids=["t4096", "t4096-few-sms", "h128", "t16384", "t16384-114-sms", "cycles-of-4",
         "7-sms", "t17408"])
def test_flash_bwd_turns_are_fixed_and_never_deadlock(pairs, t, h, sms):
    """In the model, every CTA finishes however few SMs there are (down to
    fewer than one pair's key blocks), and each tile's partials come in one
    order set by the indices alone: the cycles in order, and within a cycle
    member i / span first, then the member before it, round the cycle."""
    p = fa.bwd_plan(pairs, 1, t, h, sms=sms)
    nk, nq, group = t // 128, t // p.q_tile, p.group
    order = _bwd_turns(pairs, nk, nq, group, sms)
    assert order is not None, "deadlock"
    span = nq // group
    for i in range(nq):
        want = [c * group + (i // span - k) % group for c in range(nk // group)
                for k in range(group)]
        assert sorted(want) == list(range(nk))
        assert all(order[bn][i] == want for bn in range(pairs))
    # with one cycle per pair resident at once, a cycle of 33 would deadlock
    assert _bwd_turns(1, 33, 33, 33, 32) is None


def test_flash_bwd_scratch_tma_check_counts_fp32_bytes():
    """The dQ scratch is fp32: its TMA map needs strides of a multiple of 16
    bytes at itemsize 4, and fewer than 2^32 rows of (B * N * T)."""
    assert fa.tma_view_error((14 * 5 * 4096, 64), (64, 1), 0, itemsize=4) is None
    # 4 values a row: 16 bytes in fp32, 8 in bf16
    assert fa.tma_view_error((1024, 4), (4, 1), 0, itemsize=4) is None
    assert "multiple of 16" in fa.tma_view_error((1024, 4), (4, 1), 0, itemsize=2)
    assert "multiple of 16" in fa.tma_view_error((1024, 2), (2, 1), 0, itemsize=4)
    assert "2^32" in fa.tma_view_error((2 ** 32, 64), (64, 1), 0, itemsize=4)
    with pytest.raises(ValueError, match="scratch"):
        fa.bwd_plan(32768, 1, 2 ** 17, 64, sms=132)


def test_flash_tma_checks_hand_worked():
    # (B, N, T, H) = (28, 5, 4096, 64) head-split view of (B, T, N*H): T's
    # stride 320 elements = 640 bytes, N's 64 = 128 bytes
    shape, strides = (28, 5, 4096, 64), (4096 * 320, 64, 320, 1)
    assert fa.tma_view_error(shape, strides, 1 << 20) is None
    assert "unit last stride" in fa.tma_view_error(shape, (4096 * 640, 128, 640, 2), 0)
    assert "16-byte aligned" in fa.tma_view_error(shape, strides, 8)
    # a row stride of 132 elements is 264 bytes, not a multiple of 16
    assert "multiple of 16" in fa.tma_view_error((1, 2, 1024, 64), (135168, 64, 132, 1), 0)
    assert "multiple of 16" in fa.tma_view_error((1, 2, 1024, 64), (131072, 0, 128, 1), 0)
    assert "2^32" in fa.tma_view_error((1, 1, 2 ** 32, 64), (2 ** 38, 2 ** 38, 64, 1), 0)


def test_flash_tma_check_takes_the_views_attention_passes():
    """What ``Attention`` hands K2: head-split views of its projections, and
    the contiguous (B, N, T, H) layout; a sliced head dim is refused."""
    x = torch.zeros(2, 1024, 3 * 64, dtype=torch.bfloat16)
    view = x.view(2, 1024, 3, 64).transpose(1, 2)
    assert fa.tma_view_error(view.shape, view.stride(), view.data_ptr()) is None
    cont = torch.zeros(2, 3, 1024, 64, dtype=torch.bfloat16)
    assert fa.tma_view_error(cont.shape, cont.stride(), cont.data_ptr()) is None
    odd = torch.zeros(2, 1024, 3, 66, dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    assert fa.tma_view_error(odd.shape, odd.stride(), odd.data_ptr()) is not None



# ------------------------------------------------------- K2 fp32 (and bwd)
# 3xTF32 wgmma on TMA-loaded tiles: every fp32 tile is held as hi and lo tf32
# copies. A consumer warpgroup owns 64 rows; H = 64 runs two consumers a CTA,
# H = 128 one. 8 bytes a mbarrier and 1 KiB of alignment slack.
def _tile(rows, h):  # one fp32 tile, hi or lo
    return rows * h * 4


@pytest.mark.parametrize("b,n,t,h,grid,smem", [
    # Q (hi, lo) of two consumers 65,536 + two stages of K, V^T (hi, lo) 131,072
    # + 9 mbarriers + slack
    (14, 5, 4096, 64, (32, 70), 2 * 2 * _tile(64, 64) + 2 * 4 * _tile(64, 64) + 72 + 1024),
    (14, 10, 1024, 64, (8, 140), 197_704),
    # one consumer: Q 65,536 + one stage 131,072 + 5 mbarriers + slack
    (2, 3, 1024, 128, (16, 6), 2 * _tile(64, 128) + 4 * _tile(64, 128) + 40 + 1024),
    # half a CTA's rows: its second consumer stores nothing
    (1, 1, 64, 64, (1, 1), 197_704),
], ids=["unet-l0", "unet-l1", "h128", "one-tile"])
def test_flash_fp32_plan_hand_worked(b, n, t, h, grid, smem):
    p = fa.fp32_plan(b, n, t, h)
    assert (p.grid, p.smem_bytes) == (grid, smem)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert p.stages == (2 if h == 64 else 1)
    assert p.workspace == 6 * b * n * t * h  # Q, K, V^T, hi and lo
    assert fa.fp32_plan(2, 3, 1024, 128).smem_bytes == 197_672


@pytest.mark.parametrize("b,n,t,h,grid,step,dkv,dq", [
    # dK/dV: K, V (hi, lo) of two consumers 131,072 + one stage of Q, dO, Q^T, dO^T
    # (hi, lo) at 32 queries 65,536 + 5 mbarriers + slack; dQ: Q, dO 131,072 + two
    # stages of K, V, K^T (hi, lo) at 32 keys 98,304 + 9 mbarriers + slack
    (14, 5, 4096, 64, (32, 70), 32, 4 * 2 * _tile(64, 64) + 8 * _tile(32, 64) + 40 + 1024,
     4 * 2 * _tile(64, 64) + 2 * 6 * _tile(32, 64) + 72 + 1024),
    # one consumer, 16-row steps: the same bytes
    (2, 4, 1024, 128, (16, 8), 16, 4 * _tile(64, 128) + 8 * _tile(16, 128) + 40 + 1024,
     4 * _tile(64, 128) + 2 * 6 * _tile(16, 128) + 72 + 1024),
    (65535, 1, 64, 64, (1, 65535), 32, 197_672, 230_472),
], ids=["unet-up-t4096", "h128", "largest-bn"])
def test_flash_fp32_bwd_plan_hand_worked(b, n, t, h, grid, step, dkv, dq):
    p = fa.fp32_bwd_plan(b, n, t, h)
    assert (p.grid, p.step, p.smem_dkv, p.smem_dq) == (grid, step, dkv, dq)
    assert max(p.smem_dkv, p.smem_dq) <= SMEM_PER_BLOCK
    assert p.workspace == 14 * b * n * t * h  # Q, K, V, dO, Q^T, K^T, dO^T, hi and lo
    # the dQ kernel is the largest: 230,472 of the 232,448 bytes
    assert fa.fp32_bwd_plan(1, 1, 64, 128).smem_dq == 230_472


@pytest.mark.parametrize("b,n,t,h", [(1, 1, 1024, 96), (1, 1, 1000, 64), (1, 1, 32, 64),
                                     (65536, 1, 64, 64), (0, 1, 64, 64),
                                     # 6 x B*N*T workspace rows past TMA's 2^31
                                     (65535, 1, 8192, 64)])
def test_flash_fp32_plans_refuse_what_the_tiling_does_not_fit(b, n, t, h):
    with pytest.raises(ValueError, match="fp32"):
        fa.fp32_plan(b, n, t, h)
    with pytest.raises(ValueError, match="fp32"):
        fa.fp32_bwd_plan(b, n, t, h)


def test_flash_fp32_view_checks_count_fp32_bytes():
    """The fp32 kernels load rows as float4: the views need 16-byte aligned
    bases and row strides, counted at 4 bytes an element."""
    x = torch.zeros(2, 1024, 3 * 64, dtype=torch.float32)
    view = x.view(2, 1024, 3, 64).transpose(1, 2)
    assert fa.tma_view_error(view.shape, view.stride(), view.data_ptr(), 4) is None
    # a row stride of 66 elements: 264 bytes in fp32, not a multiple of 16
    odd = torch.zeros(2, 1024, 1, 66)[..., :64].transpose(1, 2)
    assert "multiple of 16" in fa.tma_view_error(odd.shape, odd.stride(), 0, 4)


def test_flash_dispatch_refuses_other_dtypes_before_any_launch():
    """``_check``: bf16 and fp32 pass, fp16 or a dtype other than q's raises."""
    q = torch.zeros(1, 1, 64, 64)
    fa._check("q", q, torch.float32)
    fa._check("q", q.bfloat16(), torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fa._check("q", q.half(), torch.float16)
    with pytest.raises(TypeError, match="like q"):
        fa._check("k", q.bfloat16(), torch.float32)

# ----------------------------------------------------------- K3 full plan
@pytest.mark.parametrize("args,ts,grid,smem", [
    # UNet level 0: 14 frames x 8 positions = 112 rows; the A tile and the
    # two-slot ring (2 x 128c each), the O, Q, K, V tiles (4 x 16 KiB), 32 bytes
    # of mbarriers and 1 KiB of slack: 512c + 66,592 bytes
    ((2, 14, 4096, 320, 5, 1280), 8, (512, 2), 512 * 320 + 66592),
    ((2, 16, 64, 256, 4, 1024), 8, (8, 2), 512 * 256 + 66592),
    ((2, 32, 8, 192, 3, 768), 4, (2, 2), 512 * 192 + 66592),
    ((2, 6, 12, 128, 2, 512), 4, (3, 2), 512 * 128 + 66592),
    ((1, 14, 7, 64, 1, 256), 1, (7, 1), 512 * 64 + 66592),
    # 8 frames: 16 positions would leave no room for the 8 padding rows
    ((1, 8, 64, 64, 1, 256), 8, (8, 1), 512 * 64 + 66592),
], ids=["unet-l0", "f16-c256", "f32-c192", "odd-tiles", "odd-s", "f8-pad"])
def test_full_plan_hand_worked(args, ts, grid, smem):
    p = ft.full_plan(*args)
    assert (p.ts, p.grid, p.smem_bytes) == (ts, grid, smem)
    f, s = args[1], args[2]
    assert f * ts + (-f % 16) <= 128 and grid[0] * ts == s
    assert p.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("args", [
    (2, 14, 64, 384, 6, 1536),   # c above the kernel's widths
    (2, 14, 64, 320, 5, 1248),   # inner not a multiple of 64
    (2, 33, 64, 320, 5, 1280),   # more than 32 frames
], ids=["c384", "inner1248", "f33"])
def test_full_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ft.full_plan(*args)


def test_full_plan_takes_every_full_block_of_the_svd_slice():
    """Every temporal block the JAX rule sends to "full" on the SVD slice (bf16,
    14 frames, CFG-doubled) fits the kernel's plan."""
    seen = 0
    for c, s in ((320, 4096), (640, 1024), (1280, 256), (1280, 64), (512, 4096),
                 (512, 1024), (512, 256), (512, 64)):
        for ia in (c, 320, 640, 1280):
            if ft.dispatch_mode(2, 14, s, c, ia, 4 * c, torch.bfloat16) == "full":
                p = ft.full_plan(2, 14, s, c, ia // 64, 4 * c)
                assert p.smem_bytes <= SMEM_PER_BLOCK
                seen += 1
    assert seen >= 1


# ---------------------------------------------------------------- K4 plan
# Shared memory: the A tile (256 C bytes), depth slots of 128 * max(C, C_out)
# bytes (as many as fit 232,448 bytes, at most 4), 88 bytes of mbarriers and
# 1 KiB of slack.
@pytest.mark.parametrize("args,grid,slot,depth,smem", [
    # 896 tiles of 128 rows; 81,920 + 1,112 + 3 slots of 40 KiB (a 4th would
    # need 246,872 bytes)
    ((114688, 320, 1280, 320, True), 896, 40960, 3, 83032 + 3 * 40960),
    # a ragged last tile: 4,160 rows are 32.5 tiles
    ((4160, 320, 1280, 320, False), 33, 40960, 3, 83032 + 3 * 40960),
    ((100, 64, 256, 128, False), 1, 16384, 4, 16384 + 1112 + 4 * 16384),
    ((777, 192, 768, 192, True), 7, 24576, 4, 49152 + 1112 + 4 * 24576),
    # C_out above C: the W2 tiles size the slots
    ((4096, 64, 256, 320, False), 32, 40960, 4, 16384 + 1112 + 4 * 40960),
], ids=["unet-l0", "c320-no-residual", "odd-dim-out", "odd-rows", "wide-out"])
def test_ln_ff_plan_hand_worked(args, grid, slot, depth, smem):
    p = fb.plan(*args)
    assert (p.tile_rows, p.grid, p.slot_bytes, p.depth, p.smem_bytes) == (
        128, grid, slot, depth, smem)
    assert p.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("args", [
    (4096, 384, 1536, 384, True),   # C above 320
    (4096, 320, 1280, 512, False),  # C_out above 320: its 64 x C_out accumulator
    (4096, 512, 2048, 512, True),   # C = C_out = 512, above the accumulator's 320
    (4096, 96, 384, 96, True),      # C not a multiple of 64
    (4096, 320, 1248, 320, True),   # inner not a multiple of 64
    (4096, 320, 1280, 256, True),   # the residual needs C_out == C
    (0, 320, 1280, 320, True),      # no rows
], ids=["c384", "cout512", "c512", "c96", "inner1248", "residual-cout", "m0"])
def test_ln_ff_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        fb.plan(*args)


# ---------------------------------------------------------------- K5 plan
# Shared memory: 5 stages of 32 KiB (a 128 x 64 chunk of x, 64 value and 64
# gate rows of W x 64 channels), two 16 KiB staging tiles, 80 bytes of
# mbarriers and 1 KiB of slack: 197,712 bytes.
@pytest.mark.parametrize("args,tiles,k_chunks,grid", [
    # 896 row tiles x 20 column tiles of 64 outputs, 5 stages of 64 channels
    ((114688, 320, 1280), 17920, 5, 132),
    ((28672, 640, 2560), 8960, 10, 132),
    # one ragged row tile x 6 column tiles; 96 channels: a zero-padded 2nd stage
    ((77, 96, 384), 6, 2, 6),
], ids=["l0-c320", "l1-c640", "odd-rows-odd-k"])
def test_geglu_plan_hand_worked(args, tiles, k_chunks, grid):
    p = ff.plan(*args, sms=132)
    assert (p.tiles, p.k_chunks, p.grid, p.smem_bytes) == (tiles, k_chunks, grid, 197712)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert ff.plan(*args, sms=4).grid == min(tiles, 4)


@pytest.mark.parametrize("args", [
    (256, 100, 256),   # C not a multiple of 8 (TMA row strides)
    (256, 64, 96),     # D not a multiple of 64
    (0, 64, 128),      # no rows
], ids=["c100", "d96", "m0"])
def test_geglu_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ff.plan(*args)


def test_no_source_includes_the_removed_ln_ff_header():
    """K4 and K3 full share ``csrc/ff_wgmma.cuh``; the older ``ln_ff.cuh`` is
    gone and no source includes it."""
    assert not os.path.exists(os.path.join(_build.CSRC_DIR, "ln_ff.cuh"))
    users = {}
    for path in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu*")):
        with open(path) as fh:
            text = fh.read()
        assert '#include "ln_ff.cuh"' not in text, path
        users[os.path.basename(path)] = '#include "ff_wgmma.cuh"' in text
    assert {k for k, v in users.items() if v} >= {"ln_ff.cu", "temporal_full.cu"}


# --------------------------------------------------------- K3 hybrid plan
# Shared memory: resident 256c (the 128-row A tile) + 4 x 12 KiB ring + 48 KiB
# Q/K/V + 1 KiB mean/rstd + 128 B mbarriers + 1 KiB slack = 256c + 100,480;
# alias (Q/K/V on the ring) 256c + 51,328; streamed 2 x 16 KiB staging blocks
# instead of the A tile: 133,248. The out-projection: three slots of a 16 KiB
# O tile and 128 * out_n bytes of Wo, + 1,088: 99,392 (out_n 128), 74,816 (64);
# its grid puts the column tiles of a row tile side by side.
@pytest.mark.parametrize("args,ts,mode,hpc,grid,smem,out_n,out_grid,out_smem", [
    # UNet level 1: 256 tiles; 10 heads a CTA is 2 waves x 11, 5 would be 4 x 6
    ((2, 14, 1024, 640, 10), 8, "alias", 10, (128, 1, 2), 256 * 640 + 51328, 128, (5, 224),
     99392),
    # the adapter's six shapes (c = 512, ia = the block's channels)
    ((2, 14, 4096, 512, 5), 8, "resident", 5, (512, 1, 2), 256 * 512 + 100480, 128, (4, 896),
     99392),
    ((2, 14, 1024, 512, 5), 8, "resident", 5, (128, 1, 2), 231552, 128, (4, 224), 99392),
    ((2, 14, 1024, 512, 10), 8, "resident", 10, (128, 1, 2), 231552, 128, (4, 224), 99392),
    # 64 tiles: 5 heads a CTA fill 128 SMs in one wave (cost 6 against 11 for 10)
    ((2, 14, 256, 512, 10), 8, "resident", 5, (32, 2, 2), 231552, 128, (4, 56), 99392),
    ((2, 14, 256, 512, 20), 8, "resident", 10, (32, 2, 2), 231552, 128, (4, 56), 99392),
    # 16 tiles, 20 heads: 4 a CTA, 80 CTAs in one wave (cost 5)
    ((2, 14, 64, 512, 20), 8, "resident", 4, (8, 5, 2), 231552, 128, (4, 14), 99392),
    # check rows: UNet level 0 (c = 320: 64-column out tiles), c = 1280 (streamed)
    ((2, 14, 4096, 320, 5), 8, "resident", 5, (512, 1, 2), 256 * 320 + 100480, 64, (5, 896),
     74816),
    ((2, 14, 64, 1280, 20), 8, "streamed", 4, (8, 5, 2), 133248, 128, (10, 14), 99392),
    # 32 frames: fp = 32, 4 positions a tile; odd s: one position a tile
    ((2, 32, 8, 128, 2), 4, "resident", 1, (2, 2, 2), 256 * 128 + 100480, 128, (1, 4), 99392),
    ((2, 14, 7, 320, 5), 1, "resident", 1, (7, 5, 2), 182400, 64, (5, 2), 74816),
], ids=["unet-l1", "ad-4096-ia320", "ad-1024-ia320", "ad-1024-ia640", "ad-256-ia640",
        "ad-256-ia1280", "ad-64-ia1280", "check-l0", "check-c1280", "f32", "odd-s"])
def test_hybrid_plan_hand_worked(args, ts, mode, hpc, grid, smem, out_n, out_grid, out_smem):
    p = ft.hybrid_plan(*args)
    assert (p.ts, p.mode, p.heads_per_cta, p.grid, p.smem_bytes) == (ts, mode, hpc, grid, smem)
    assert (p.out_n, p.out_grid, p.out_smem_bytes) == (out_n, out_grid, out_smem)
    assert p.smem_bytes <= SMEM_PER_BLOCK and 2 * p.out_smem_bytes <= 228 * 1024


@pytest.mark.parametrize("c,mode", [(64, "resident"), (512, "resident"), (576, "alias"),
                                    (704, "alias"), (768, "streamed"), (2560, "streamed")])
def test_hybrid_plan_takes_the_widest_layout_that_fits(c, mode):
    assert ft.hybrid_plan(2, 14, 64, c, 4).mode == mode


@pytest.mark.parametrize("args", [
    (2, 33, 64, 512, 8),   # more than 32 frames
    (2, 14, 64, 544, 8),   # c not a multiple of 64
    (2, 14, 64, 32, 1),    # c below one 64-channel chunk
    (2, 14, 64, 512, 0),   # no heads
], ids=["f33", "c544", "c32", "heads0"])
def test_hybrid_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ft.hybrid_plan(*args)


# ---------------------------------------------------------------- K1 plan
# A one-launch CTA's shared memory: its elements of x (bf16) + 256 bytes of
# per-group sums, statistics and mbarriers + 16 bytes for each channel it
# touches (elems / S + 2 at most).
@pytest.mark.parametrize("shape,branch,cluster,gpc,elems,grid,smem", [
    # 896 groups of 10 x 4096: one 80 KiB group a CTA, two CTAs an SM
    ((28, 320, 64, 64), "one_cta", 1, 1, 40960, 896, 81920 + 256 + 16 * 12),
    # 5 KiB groups: two a CTA (four would leave 224 < 2 x 132 CTAs)
    ((28, 1280, 8, 8), "several_groups", 1, 2, 5120, 448, 10240 + 256 + 16 * 82),
    # 64 groups of 1.15 MB: clusters of 8 CTAs of 143 KiB
    ((2, 320, 14, 64, 64), "cluster", 8, 1, 71680, 512, 143360 + 256 + 16 * 3),
    # 64 groups of 70 KiB would fill 64 SMs: clusters of 4 fill 256 CTAs
    ((2, 1280, 14, 8, 8), "cluster", 4, 1, 8960, 256, 17920 + 256 + 16 * 12),
    # SDXL's adapter at N = 2 (the CFG pair), 64 groups: 80 KiB groups fit one
    # CTA but 64 CTAs would leave half the SMs idle, so clusters of 4 fill 256
    ((2, 320, 64, 64), "cluster", 4, 1, 10240, 256, 20480 + 256 + 16 * 4),
    ((2, 1280, 32, 32), "cluster", 4, 1, 10240, 256, 20480 + 256 + 16 * 12),
    # 10 KiB groups: two a CTA would leave 32 < 2 x 132 CTAs, so clusters of 4
    ((2, 640, 16, 16), "cluster", 4, 1, 1280, 256, 2560 + 256 + 16 * 7),
], ids=["one-cta", "several-groups", "cluster-8", "cluster-fill", "sdxl-320x64x64",
        "sdxl-1280x32x32", "sdxl-640x16x16"])
def test_group_norm_plan_hand_worked(shape, branch, cluster, gpc, elems, grid, smem):
    p = gn.plan(shape, 32)
    assert (p.branch, p.cluster, p.groups_per_cta, p.elems, p.grid, p.smem_bytes, p.vec) == (
        branch, cluster, gpc, elems, grid, smem, True)
    assert p.smem_bytes <= SMEM_PER_BLOCK


def test_group_norm_plan_two_pass_branch():
    # a spatial size of 105 (not a multiple of 8): scalar loads, one split of 210
    p = gn.plan((2, 64, 3, 5, 7), 32)
    assert (p.branch, p.elems, p.grid, p.smem_bytes, p.vec) == ("two_pass", 210, 1, 0, False)
    # a 2 MiB group (more than 8 CTAs of 200 KiB): 64 splits of 16,384
    p = gn.plan((1, 32, 1, 1024, 1024), 32)
    assert (p.branch, p.elems, p.grid, p.vec) == ("two_pass", 16384, 64, True)
    # a base address that is not 16-byte aligned: scalar loads
    p = gn.plan((28, 320, 64, 64), 32, aligned=False)
    assert (p.branch, p.vec) == ("two_pass", False)



# fp32: the same byte budgets, 4 elements a 16-byte vector; where there are at
# least as many groups as SMs and a group is at most 96 KiB, the ring. A ring
# CTA's shared memory: its slot (a group, rounded up to 128 bytes), one
# 8-byte mbarrier a 16 KiB piece of it, and (gamma, beta) of the group's cg
# channels (8 bytes each); as many CTAs an SM as fit in its 228 KiB (1 KiB
# reserved a CTA), at most 4, each walking groups u, u + grid, ...; 128
# threads up to 16 KiB a group, 256 above.
@pytest.mark.parametrize("shape,branch,cluster,gpc,elems,grid,smem,threads", [
    # 160 KiB groups: two CTAs of 80 KiB a group
    ((28, 320, 64, 64), "cluster", 2, 1, 20480, 1792, 81920 + 256 + 16 * 7, 512),
    # the fp32 training path's adapter norm at b * f = 14
    ((14, 320, 64, 64), "cluster", 2, 1, 20480, 896, 81920 + 256 + 16 * 7, 512),
    # 20 KiB groups: two a CTA would pass 32 KiB, so clusters of 4 fill 256 CTAs
    ((2, 640, 16, 16), "cluster", 4, 1, 1280, 256, 5120 + 256 + 16 * 7, 512),
    # a spatial size of 12: a multiple of 4 (one launch), not of 8 (bf16: two passes)
    ((2, 64, 1, 2, 6), "cluster", 2, 1, 12, 128, 48 + 256 + 16 * 3, 512),
    # SVD's fp32 training rows (b f = 14: 448 groups). 40 KiB: three pieces,
    # cg 10; four CTAs an SM (4 x 41,064 + 4 KiB), 528 >= 448: one group each
    ((14, 320, 32, 32), "ring", 1, 1, 10240, 448, 40960 + 8 * 3 + 8 * 10, 256),
    # 80 KiB: five pieces, cg 20; two CTAs an SM fit, 264 CTAs walk 1 or 2 groups
    ((14, 640, 32, 32), "ring", 1, 2, 20480, 264, 81920 + 8 * 5 + 8 * 20, 256),
    ((14, 640, 16, 16), "ring", 1, 1, 5120, 448, 20480 + 8 * 2 + 8 * 20, 256),
    ((14, 1280, 16, 16), "ring", 1, 1, 10240, 448, 40960 + 8 * 3 + 8 * 40, 256),
    # 10 KiB: one piece, 128 threads (5 vectors a thread)
    ((14, 1280, 8, 8), "ring", 1, 1, 2560, 448, 10240 + 8 * 1 + 8 * 40, 128),
    # I2VGen-XL's (16 frames: 512 groups; four CTAs an SM still hold all)
    ((16, 320, 32, 32), "ring", 1, 1, 10240, 512, 40960 + 8 * 3 + 8 * 10, 256),
    ((16, 640, 32, 32), "ring", 1, 2, 20480, 264, 81920 + 8 * 5 + 8 * 20, 256),
    ((16, 1280, 8, 8), "ring", 1, 1, 2560, 512, 10240 + 8 * 1 + 8 * 40, 128),
    # 1,792 groups over 528 CTAs: 208 walk 4 groups, 320 walk 3
    ((56, 640, 16, 16), "ring", 1, 4, 5120, 528, 20480 + 8 * 2 + 8 * 20, 256),
], ids=["one-cta-pair", "train-b14", "cluster-fill", "s12", "ring-svd-320x32",
        "ring-svd-640x32", "ring-svd-640x16", "ring-svd-1280x16", "ring-svd-1280x8",
        "ring-i2v-320x32", "ring-i2v-640x32", "ring-i2v-1280x8", "ring-uneven"])
def test_group_norm_plan_fp32_hand_worked(shape, branch, cluster, gpc, elems, grid, smem,
                                          threads):
    p = gn.plan(shape, 32, itemsize=4)
    assert (p.branch, p.cluster, p.groups_per_cta, p.elems, p.grid, p.smem_bytes, p.vec,
            p.threads) == (branch, cluster, gpc, elems, grid, smem, True, threads)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert gn.plan((2, 64, 1, 2, 6), 32).branch == "two_pass"
    # spatial 105 is no multiple of 4 either: scalar loads, one split of 210
    p = gn.plan((2, 64, 3, 5, 7), 32, itemsize=4)
    assert (p.branch, p.elems, p.grid, p.smem_bytes, p.vec) == ("two_pass", 210, 1, 0, False)

def test_group_norm_plan_fp32_takes_the_ring_at_the_training_rows():
    """Every fp32 training row of SVD and I2VGen-XL goes to the ring, within
    an SM's shared memory and threads at the CTAs an SM the plan counts;
    SDXL's (32 groups) keep their clusters of 8; bf16 never takes the ring."""
    import chip_smoke

    for (shape, _), _n in [*chip_smoke.k1_rows(14, 1, 4).items(),
                           *chip_smoke.k1_rows(16, 1, 4).items()]:
        p = gn.plan(shape, 32, itemsize=4)
        ctas = -(-p.grid // 132)
        assert p.branch == "ring" and gn.ring_fits(p, ctas), (shape, p)
        assert (shape[0] * 32 - 1) // p.grid + 1 == p.groups_per_cta
        assert gn.plan(shape, 32).branch != "ring"
    for (shape, _), _n in chip_smoke.sdxl_k1_rows(batch=1, itemsize=4).items():
        assert gn.plan(shape, 32, itemsize=4).cluster == 8
    # a base that is not 16-byte aligned, or a spatial size not a multiple of 4
    assert gn.plan((14, 320, 32, 32), 32, aligned=False, itemsize=4).branch == "two_pass"
    assert gn.plan((14, 320, 3, 5, 7), 32, itemsize=4).branch == "two_pass"


def test_group_norm_plan_is_one_launch_on_every_adapter_shape():
    import chip_smoke

    for (shape, _), n in [*chip_smoke.k1_rows().items(), *chip_smoke.sdxl_k1_rows().items()]:
        p = gn.plan(shape, 32)
        assert p.branch != "two_pass" and p.smem_bytes <= SMEM_PER_BLOCK, (shape, p)


# ------------------------------------------------- main-path shape lists
def _drive_on_meta(monkeypatch):
    """Run the slice's adapter and UNet once on the meta device (shapes only;
    the kernels swapped for their plain versions) and record every temporal
    block's ``dispatch_mode`` call and every GroupNorm kernel call."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel

    dispatch, norms = [], []
    real = ft.dispatch_mode
    monkeypatch.setattr(ft, "dispatch_mode", lambda *a: dispatch.append(
        (a[:5], real(*a))) or dispatch[-1][1])
    dev, bf = torch.device("meta"), torch.bfloat16
    # the spies are undone (mp) before plain_kernels puts the wrappers back:
    # undone after, they would leave the plain versions in the ops modules
    with chip_smoke.plain_kernels(), torch.no_grad(), monkeypatch.context() as mp:
        mp.setattr(gn, "group_norm_silu", lambda x, w, b, g, eps, silu: norms.append(
            (tuple(x.shape), silu)) or gn._torch_group_norm_silu(x, w, b, g, eps, silu))
        adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                    adapter_locations=("A", "B", "C", "D", "M"),
                                    add_temporal_resnet=True, add_temporal_transformer=True,
                                    device=dev, dtype=bf)
        res = [torch.empty(28, c, h, h, device=dev, dtype=bf) for c, h in
               zip((320,) * 4 + (640,) * 3 + (1280,) * 5, (64,) * 3 + (32,) * 3 + (16,) * 3
                   + (8,) * 3)]
        adapter(res, torch.empty(28, 1280, 8, 8, device=dev, dtype=bf), num_frames=14,
                timestep=torch.ones(2, device=dev),
                encoder_hidden_states=torch.empty(2, 1, 1024, device=dev, dtype=bf))
        n_adapter = len(dispatch)
        unet = UNetSpatioTemporalConditionModel(device=dev, dtype=bf)
        unet(torch.empty(2, 14, 8, 64, 64, device=dev, dtype=bf), torch.ones(2, device=dev),
             torch.empty(2, 1, 1024, device=dev, dtype=bf), torch.empty(2, 3, device=dev))
    return dispatch[:n_adapter], dispatch[n_adapter:], norms


def test_chip_smoke_shape_lists_are_the_modules_dispatch(monkeypatch):
    """The K3 hybrid rows ``chip_smoke.py`` times (with their launches per
    controlled and per UNet-only step) and its 47 K1 calls per adapter call
    are what the port's adapter and UNet modules dispatch at full width."""
    import chip_smoke

    adapter, unet, norms = _drive_on_meta(monkeypatch)
    hybrid = Counter(a for a, m in adapter + unet if m == "hybrid")
    hybrid_unet = Counter(a for a, m in unet if m == "hybrid")
    rows = chip_smoke.hybrid_rows()
    assert {k: r["controlled"] for k, r in rows.items()} == dict(hybrid)
    assert {k: r["unet_only"] for k, r in rows.items() if r["unet_only"]} == dict(hybrid_unet)
    assert sum(hybrid.values()) == 18 and sum(hybrid_unet.values()) == 5
    assert Counter(m for _, m in unet) == {"full": 5, "hybrid": 5, None: 6}
    assert dict(Counter(norms)) == chip_smoke.k1_rows() and len(norms) == 47


def test_chip_smoke_i2vgenxl_shape_lists_are_the_modules_dispatch(monkeypatch):
    """The I2VGen-XL rows ``chip_smoke.py`` times and the launches per step it
    expects (K3 hybrid, K2 and K1, per controlled and per UNet-only step) are
    what the port's adapter (16 frames) and I2VGen-XL UNet dispatch at full
    width, run once on the meta device."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet

    f = chip_smoke.I2V_FRAMES
    dispatch, norms, flash = [], [], []
    real = ft.dispatch_mode
    monkeypatch.setattr(ft, "dispatch_mode", lambda *a: dispatch.append(
        (a[:5], real(*a))) or dispatch[-1][1])
    dev, bf = torch.device("meta"), torch.bfloat16
    e = lambda *shape: torch.empty(*shape, device=dev, dtype=bf)  # noqa: E731
    marks = {}
    with chip_smoke.plain_kernels(), torch.no_grad(), monkeypatch.context() as mp:
        mp.setattr(gn, "group_norm_silu", lambda x, w, b, g, eps, silu: norms.append(
            (tuple(x.shape), silu)) or gn._torch_group_norm_silu(x, w, b, g, eps, silu))
        mp.setattr(fa, "attention_bnth", lambda q, k, v: flash.append(
            tuple(q.shape)) or fa._torch_attention(q, k, v))
        adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                    adapter_locations=("A", "B", "C", "D", "M"),
                                    add_temporal_resnet=True, add_temporal_transformer=True,
                                    device=dev, dtype=bf)
        adapter([e(2 * f, c, h, h) for c, h in chip_smoke.adapter_blocks()[:-1]],
                e(2 * f, 1280, 8, 8), num_frames=f, timestep=981.0,
                encoder_hidden_states=e(2, 1, 1024))
        marks["adapter"] = (len(dispatch), len(flash))
        I2VGenXLUNet(device=dev, dtype=bf)(
            e(2, f, 4, 64, 64), 981.0, torch.full((2,), 16.0, device=dev), e(2, f, 4, 64, 64),
            e(2, 1, 1024), e(2, 77, 1024))
    n_dispatch, n_flash = marks["adapter"]
    assert not dispatch[n_dispatch:]  # the UNet has no TemporalBasicTransformerBlock
    hybrid = Counter(a for a, m in dispatch if m == "hybrid")
    assert len(dispatch) == sum(hybrid.values()) == 13
    assert {k: r["controlled"] for k, r in chip_smoke.i2v_hybrid_rows().items()} == dict(hybrid)
    rows = chip_smoke.i2v_flash_rows()
    assert {k: r["controlled"] for k, r in rows.items()} == dict(Counter(flash))
    assert {k: r["unet_only"] for k, r in rows.items() if r["unet_only"]} == dict(
        Counter(flash[n_flash:]))
    assert len(flash) == 16 and len(flash[n_flash:]) == 10
    # K1: only the adapter's norms ("prefer"), the ones the JAX rule admits
    assert dict(Counter(norms)) == chip_smoke.k1_rows(f) and len(norms) == 47


def test_chip_smoke_sdxl_shape_lists_are_the_modules_dispatch(monkeypatch):
    """The SDXL rows ``chip_smoke.py`` times and the launches per step it
    expects (K2 and K1, per controlled and per UNet-only step) are what the
    port's SDXL adapter and SDXL UNet dispatch at full width (1024x1024, batch
    2 after CFG), run once on the meta device: K2 79 times a controlled step
    and 70 a UNet-only one, K1 17 times (the adapter's norms only)."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG, UNet2DConditionModel

    norms, flash = [], []
    dev, bf = torch.device("meta"), torch.bfloat16
    e = lambda *shape: torch.empty(*shape, device=dev, dtype=bf)  # noqa: E731
    with chip_smoke.plain_kernels(), torch.no_grad(), monkeypatch.context() as mp:
        mp.setattr(gn, "group_norm_silu", lambda x, w, b, g, eps, silu: norms.append(
            (tuple(x.shape), silu)) or gn._torch_group_norm_silu(x, w, b, g, eps, silu))
        mp.setattr(fa, "attention_bnth", lambda q, k, v: flash.append(
            tuple(q.shape)) or fa._torch_attention(q, k, v))
        adapter = ControlNetAdapter(backbone_model_name="sdxl", cross_attention_dim=2048,
                                    num_blocks=1, adapter_locations=("A", "B", "C"),
                                    device=dev, dtype=bf)
        blocks = chip_smoke.adapter_blocks(chip_smoke.SDXL_CONTROL)[:-1]
        down, _ = adapter([e(2, c, h, h) for c, h in blocks], None, num_frames=1,
                          timestep=951.0, encoder_hidden_states=e(2, 77, 2048))
        assert [tuple(d.shape[-2:]) for d in down] == [(2 * h, 2 * h) for _, h in blocks]
        n_adapter = len(flash)
        lat = chip_smoke.SDXL_SIZE // 8
        unet = UNet2DConditionModel(SDXL_CONFIG, device=dev, dtype=bf)
        unet(e(2, 4, lat, lat), 951.0, e(2, 77, 2048),
             {"text_embeds": e(2, 1280), "time_ids": e(2, 6)},
             down_block_additional_residuals=down,
             mid_block_additional_residual=torch.zeros((), device=dev, dtype=bf))
    rows = chip_smoke.sdxl_flash_rows()
    assert {k: r["controlled"] for k, r in rows.items()} == dict(Counter(flash))
    assert {k: r["unet_only"] for k, r in rows.items() if r["unet_only"]} == dict(
        Counter(flash[n_adapter:]))
    assert len(flash) == 79 and len(flash[n_adapter:]) == 70
    assert Counter(flash[:n_adapter])[(2, 5, 16384, 64)] == 3
    assert dict(Counter(norms)) == chip_smoke.sdxl_k1_rows() and len(norms) == 17
    assert chip_smoke.sdxl_launches(2, 2) == dict(
        group_norm_silu=34, flash_attention=2 * 79 + 2 * 70, temporal_block=0,
        temporal_block_full=0, ln_ff_residual=0, geglu=0, flash_attention_bwd=0)


def _record_training_pass(monkeypatch, run):
    """``run()`` once on the meta device with the plain kernels and grad on:
    (temporal dispatches, K1 norms (shape, silu), K2 calls (shape, whether
    an input needs a gradient, so that K2's backward runs for it))."""
    import chip_smoke

    dispatch, norms, flash = [], [], []
    real = ft.dispatch_mode
    monkeypatch.setattr(ft, "dispatch_mode", lambda *a: dispatch.append(
        (a[:5], real(*a))) or dispatch[-1][1])
    with chip_smoke.plain_kernels(), torch.enable_grad(), monkeypatch.context() as mp:
        mp.setattr(gn, "group_norm_silu", lambda x, w, b, g, eps, silu: norms.append(
            (tuple(x.shape), silu)) or gn._torch_group_norm_silu(x, w, b, g, eps, silu))
        mp.setattr(fa, "attention_bnth", lambda q, k, v: flash.append(
            (tuple(q.shape), q.requires_grad or k.requires_grad or v.requires_grad))
            or fa._torch_attention(q, k, v))
        run()
    # copies: the helpers held against them call dispatch_mode too
    return list(dispatch), list(norms), list(flash)


def _check_training_rows(dispatch, norms, flash, k1, k2, k3, launches):
    """One pass's dispatch against the helper's rows, and the helper's
    launches per training step: the forward kernels twice (forward and
    the checkpointed recompute), K2's backward once per attention with an
    input that needs a gradient."""
    assert {k: r["controlled"] for k, r in k2.items()} == dict(Counter(s for s, _ in flash))
    assert {k: r["train_bwd"] for k, r in k2.items() if r["train_bwd"]} == dict(
        Counter(s for s, grad in flash if grad))
    assert dict(Counter(norms)) == k1
    hybrid = Counter(a for a, m in dispatch if m == "hybrid")
    assert {k: r["controlled"] for k, r in k3.items()} == dict(hybrid)
    assert launches == dict(
        group_norm_silu=2 * len(norms), flash_attention=2 * len(flash),
        temporal_block=2 * sum(hybrid.values()), temporal_block_full=0, ln_ff_residual=0,
        geglu=0, flash_attention_bwd=sum(grad for _, grad in flash))


def test_chip_smoke_i2vgenxl_training_launches_are_the_modules_dispatch(monkeypatch):
    """Phase 11's I2VGen-XL rows and launches per training step
    (``i2v_train_launches``: K1 94, K2 32, K2 backward 12, K3 hybrid 26) are
    what the trainable adapter (16 frames, batch 1) and the frozen I2VGen-XL
    UNet that takes its residuals dispatch at full width, run once on the
    meta device with grad on: K2's backward at the adapter's 6 attentions
    and the UNet's 6 up-block ones."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet

    f = chip_smoke.I2V_FRAMES
    dev, bf = torch.device("meta"), torch.bfloat16
    e = lambda *shape: torch.empty(*shape, device=dev, dtype=bf)  # noqa: E731

    def run():
        adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                    adapter_locations=("A", "B", "C", "D", "M"),
                                    add_temporal_resnet=True, add_temporal_transformer=True,
                                    device=dev, dtype=bf)
        t = torch.full((1,), 981.0, device=dev)
        down, mid = adapter([e(f, c, h, h) for c, h in chip_smoke.adapter_blocks()[:-1]],
                            e(f, 1280, 8, 8), num_frames=f, timestep=t,
                            encoder_hidden_states=e(1, 1, 1024))
        unet = I2VGenXLUNet(device=dev, dtype=bf).requires_grad_(False)
        out = unet(e(1, f, 4, 64, 64), t, torch.full((1,), 16.0, device=dev),
                   e(1, f, 4, 64, 64), e(1, 1, 1024), e(1, 77, 1024), down, mid)
        assert out.requires_grad

    dispatch, norms, flash = _record_training_pass(monkeypatch, run)
    _check_training_rows(dispatch, norms, flash, chip_smoke.k1_rows(f, 1),
                         chip_smoke.i2v_flash_rows(batch=1), chip_smoke.i2v_hybrid_rows(f, 1),
                         chip_smoke.i2v_train_launches())
    assert chip_smoke.i2v_train_launches() == dict(
        group_norm_silu=94, flash_attention=32, temporal_block=26, temporal_block_full=0,
        ln_ff_residual=0, geglu=0, flash_attention_bwd=12)


def test_chip_smoke_sdxl_training_launches_are_the_modules_dispatch(monkeypatch):
    """Phase 11's SDXL rows and launches per training step
    (``sdxl_train_launches``: K1 34, K2 158, K2 backward 45) are what the
    trainable SDXL adapter (batch 1) and the frozen SDXL UNet at 1024x1024
    dispatch, run once on the meta device with grad on: K2's backward at
    the adapter's 9 attentions (3 at T = 16384) and the UNet's 36 up-block
    ones, none in its down or mid blocks."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG, UNet2DConditionModel

    dev, bf = torch.device("meta"), torch.bfloat16
    e = lambda *shape: torch.empty(*shape, device=dev, dtype=bf)  # noqa: E731

    def run():
        adapter = ControlNetAdapter(backbone_model_name="sdxl", cross_attention_dim=2048,
                                    num_blocks=1, adapter_locations=("A", "B", "C"),
                                    device=dev, dtype=bf)
        t = torch.full((1,), 951.0, device=dev)
        blocks = chip_smoke.adapter_blocks(chip_smoke.SDXL_CONTROL)[:-1]
        down, _ = adapter([e(1, c, h, h) for c, h in blocks], None, num_frames=1, timestep=t,
                          encoder_hidden_states=e(1, 77, 2048))
        lat = chip_smoke.SDXL_SIZE // 8
        unet = UNet2DConditionModel(SDXL_CONFIG, device=dev, dtype=bf).requires_grad_(False)
        out = unet(e(1, 4, lat, lat), t, e(1, 77, 2048),
                   {"text_embeds": e(1, 1280), "time_ids": e(1, 6)}, down,
                   torch.zeros((), device=dev))
        assert out.requires_grad

    dispatch, norms, flash = _record_training_pass(monkeypatch, run)
    _check_training_rows(dispatch, norms, flash, chip_smoke.sdxl_k1_rows(batch=1),
                         chip_smoke.sdxl_flash_rows(batch=1), {},
                         chip_smoke.sdxl_train_launches())
    assert Counter(s for s, grad in flash if grad)[(1, 5, 16384, 64)] == 3
    assert chip_smoke.sdxl_train_launches() == dict(
        group_norm_silu=34, flash_attention=158, temporal_block=0, temporal_block_full=0,
        ln_ff_residual=0, geglu=0, flash_attention_bwd=45)


# --------------------------------------------------------------- roofline
def test_roofline_attention_hand_worked():
    cost = rl.attention(28, 5, 4096, 4096, 64)
    assert cost.flops == 4 * 28 * 5 * 4096 * 4096 * 64 == 601_295_421_440
    assert cost.bytes == 2 * 28 * 5 * 64 * 4 * 4096 == 293_601_280
    assert cost.bound_by == "operations"
    assert cost.bound_ms == pytest.approx(601_295_421_440 / 989e9, rel=1e-12)
    assert rl.attention(28, 10, 1024, 1024, 64).bound_ms == pytest.approx(0.0760, abs=1e-4)


def test_roofline_attention_backward_hand_worked():
    """Five T x T x H products per (b, n) pair against Q, K, V, O, dO, dQ, dK,
    dV (bf16) and the fp32 log-sum-exp: 0.760 ms and 0.095 ms on the H100's
    989 TFLOP/s at the training path's shapes."""
    big = rl.attention_bwd(14, 5, 4096, 64)
    assert big.flops == 10 * 70 * 4096 * 4096 * 64 == 751_619_276_800
    assert big.bytes == 2 * 8 * 70 * 4096 * 64 + 4 * 70 * 4096 == 294_748_160
    assert big.bound_by == "operations" and big.bound_ms == pytest.approx(0.760, abs=1e-3)
    small = rl.attention_bwd(14, 10, 1024, 64)
    assert small.flops == 93_952_409_600 and small.bound_ms == pytest.approx(0.095, abs=1e-3)



def test_roofline_fp32_rows_use_the_cuda_core_peak():
    """The fp32 kernels' bounds: 4-byte elements; K1 fp32's arithmetic against
    the 67 TFLOP/s of fp32 on the CUDA cores, K2 fp32's and its backward's
    products against the 3xTF32 rate they run at (494.5 TFLOP/s of tf32 over
    three passes): 1.824 ms and 4.560 ms at (14, 5, 4096, 64)."""
    assert rl.TF32X3_FLOPS == pytest.approx(494.5e12 / 3, rel=1e-12)
    fwd = rl.attention(14, 5, 4096, 4096, 64, itemsize=4)
    assert fwd.flops == 4 * 70 * 4096 * 4096 * 64 and fwd.peak_flops == rl.TF32X3_FLOPS
    assert fwd.bytes == 4 * 70 * 64 * 4 * 4096
    assert fwd.bound_by == "operations" and fwd.bound_ms == pytest.approx(1.824, abs=1e-3)
    bwd = rl.attention_bwd(14, 5, 4096, 64, itemsize=4)
    assert bwd.bytes == 4 * 8 * 70 * 4096 * 64 + 4 * 70 * 4096
    assert bwd.bound_ms == pytest.approx(751_619_276_800 / (494.5e9 / 3), rel=1e-12)
    assert bwd.bound_ms == pytest.approx(4.560, abs=1e-3)
    norm = rl.group_norm((14, 320, 64, 64), silu=True, itemsize=4)
    assert norm.peak_flops == rl.H100_FP32_FLOPS
    assert norm.bytes == 4 * (2 * 14 * 320 * 64 * 64 + 2 * 320) and norm.bound_by == "bytes"

def test_roofline_group_norm_counts_each_byte_once():
    cost = rl.group_norm((28, 320, 64, 64), silu=False)
    # x read once and y written once (bf16), plus the (C,) weight and bias
    assert cost.bytes == 2 * (2 * 28 * 320 * 64 * 64 + 2 * 320) == 146_801_920
    assert cost.bound_by == "bytes"
    assert cost.bound_ms == pytest.approx(146_801_920 / 3.35e9, rel=1e-12)
    five_d = rl.group_norm((2, 320, 14, 64, 64), silu=True)
    assert five_d.bytes == cost.bytes and five_d.bound_ms == cost.bound_ms


def test_roofline_temporal_blocks_hand_worked():
    full = rl.temporal_block_full(2, 14, 4096, 320, 320, 1280, cross=True)
    rows = 2 * 14 * 4096
    qkv, wo = 2 * rows * 320 * 960, 2 * rows * 320 * 320
    attn = 4 * 2 * 4096 * 14 * 14 * 320
    ffs = 2 * (2 * rows * 320 * 2560 + 2 * rows * 1280 * 320)
    assert full.flops == qkv + wo + attn + ffs == 659_722_076_160
    assert full.bound_ms == pytest.approx(0.6671, abs=1e-4)
    assert full.bound_by == "operations"
    l1 = rl.temporal_block(2, 14, 1024, 640, 640, cross=True)
    assert l1.flops == 94_980_014_080
    assert l1.bound_ms == pytest.approx(0.0960, abs=1e-4)


def test_roofline_feed_forwards_hand_worked():
    k4 = rl.ln_ff(114688, 320, 1280, 320, residual=True)
    assert k4.flops == 281_857_228_800 and k4.bound_by == "operations"
    k5 = rl.geglu(114688, 320, 1280)
    assert k5.flops == 187_904_819_200
    # 369 MB would take 0.110 ms; the products take 0.190 ms
    assert k5.bytes == 368_645_120
    assert k5.memory_ms == pytest.approx(0.1100, abs=1e-4)
    assert k5.bound_ms == pytest.approx(0.1900, abs=1e-4) and k5.bound_by == "operations"


def test_roofline_per_step_sums_hand_worked():
    """The per-step bounds ``chip_smoke.py`` prints: K3 hybrid 0.79 ms in the
    adapter (13 calls) + 0.48 ms in the UNet (5 at level 1) per controlled
    step; K1 0.70 ms over the 47 adapter norms the JAX rule sends to it (2.33 GB
    read and written)."""
    import chip_smoke

    rows = chip_smoke.hybrid_rows()
    # UNet level 1: 2*28672*640*1920 (QKV) + 2*28672*640*640 (out) + 4*2048*196*640
    l1 = rl.temporal_block(2, 14, 1024, 640, 640, True)
    assert l1.flops == 2 * 28672 * 640 * 2560 + 4 * 2048 * 196 * 640 == 94_980_014_080
    unet = sum(r["unet_only"] * rl.temporal_block(*k, True).bound_ms for k, r in rows.items())
    adapter = sum((r["controlled"] - r["unet_only"]) * rl.temporal_block(*k, True).bound_ms
                  for k, r in rows.items())
    assert unet == pytest.approx(5 * 94_980_014_080 / 989e9, rel=1e-9)
    assert unet == pytest.approx(0.480, abs=1e-3) and adapter == pytest.approx(0.790, abs=1e-3)
    k1 = chip_smoke.k1_rows()
    moved = sum(n * rl.group_norm(shape, silu).bytes for (shape, silu), n in k1.items())
    # per block (c, h): 3 norms of (28, c, h, h), and the 2 of (2, c, 14, h, h)
    # at 8x8 only (4 * 14 * 64 * 1280 * 2 bytes is within the 12 MiB rule, the
    # larger ones are not); each read and written, and their (c,) weight and bias
    blocks = chip_smoke.adapter_blocks()
    assert moved == sum(4 * (3 + 2 * (h == 8)) * (28 * c * h * h + c)
                        for c, h in blocks) == 2_330_631_680
    bound = sum(n * rl.group_norm(shape, silu).bound_ms for (shape, silu), n in k1.items())
    assert bound == pytest.approx(0.696, abs=1e-3)


def test_chip_smoke_row_carries_the_bound_and_the_first_library_call():
    import chip_smoke

    cost = rl.attention(28, 5, 4096, 4096, 64)
    row = chip_smoke.report("(28,5,4096,64)", 1e-3, 1.5, 30.0, cost,
                            {"SDPA default (CUDNN_ATTENTION)": 1.3, "SDPA FLASH_ATTENTION": None})
    assert row["library_ms"] == 1.3
    assert row["bound_ms"] == cost.bound_ms and row["bound_by"] == "operations"
    assert chip_smoke.report("x", 0.0, 1.0, 1.0, cost)["library_ms"] is None


def test_per_step_total_sums_each_clock_and_names_a_missing_one(capsys):
    """``per_step_total`` sums launches x ms on the host-inclusive clock and
    on device time (warm and cold L2); a clock that a launched row lacks is
    "not measured", and rows with no launches do not count."""
    import chip_smoke

    rows = [dict(controlled=2, ms=0.5, device_ms=0.4, cold_ms=0.45, bound_ms=0.1),
            dict(controlled=0, ms=9.0, device_ms=None, cold_ms=9.0, bound_ms=1.0),
            dict(controlled=1, ms=0.25, device_ms=None, cold_ms=0.2, bound_ms=0.05)]
    chip_smoke.per_step_total("K", rows, "controlled")
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "  K per controlled step (host-inclusive): 3 launches, 1.250 ms of kernel against "
        "0.250 ms of bound (20.0 %)",
        "  K per controlled step (device, warm L2): not measured",
        "  K per controlled step (device, cold L2): 3 launches, 1.100 ms of kernel against "
        "0.250 ms of bound (22.7 %)",
    ]


def test_launches_per_step_counts_each_step_and_marks_the_controlled_ones():
    """``chip_smoke.launches_per_step`` (K4's per-step counts in the
    fused-block run, every kernel's in the I2VGen-XL runs): a step runs from
    its first tower call to the end of its UNet call, and is controlled where
    the ControlNet ran in it; each named counter is counted apart."""
    import chip_smoke

    class Kernel:
        launches = 0

        def __call__(self, *_):
            self.launches += 1

    class Tower(torch.nn.Module):
        def __init__(self, kernel, n):
            super().__init__()
            self.kernel, self.n = kernel, n

        def forward(self, x):
            for _ in range(self.n):
                self.kernel()
            return x

    kernel, idle = Kernel(), Kernel()
    pipe = type("Pipe", (), {})()
    pipe.controlnet, pipe.unet = Tower(kernel, 2), Tower(kernel, 5)
    with chip_smoke.launches_per_step(pipe, {"k": kernel, "idle": idle}) as steps:
        for i in range(3):
            if i < 2:
                pipe.controlnet(0)
            pipe.unet(0)
    pipe.unet(0)  # after the context: not counted
    assert steps == [(True, {"k": 7, "idle": 0}), (True, {"k": 7, "idle": 0}),
                     (False, {"k": 5, "idle": 0})]


@pytest.mark.parametrize("kernel", ["k3-full", "k4", "k5"])
def test_gelu_form_inputs_tell_the_forms_apart(kernel):
    """The chip check that a kernel computed the gelu form asked for
    (``chip_smoke.gelu_form_check``) holds on its ``gelu_form_ff`` inputs for
    a stand-in kernel that rounds differently (the plain version in fp32,
    rounded once), and fails for one that ignores the flag."""
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale  # noqa: E731
    bf = torch.bfloat16

    def f32(a):
        if isinstance(a, tuple):
            return tuple(map(f32, a))
        return a.float() if torch.is_tensor(a) else a

    form = chip_smoke.gelu_form_ff(rand, 64, 256, 64)
    if kernel == "k3-full":
        ins = (rand(1, 6, 4, 64, scale=1e-2).to(bf), rand(1, 4, 64, scale=2e-3).to(bf),
               torch.ones(64, dtype=bf), torch.zeros(64, dtype=bf),
               *(rand(64, 64, scale=2e-3).to(bf) for _ in range(4)),
               rand(64, scale=2e-3).to(bf), 1, 1e-5, form,
               chip_smoke.gelu_form_ff(rand, 64, 256, 64))
        plain = ft._torch_temporal_block
    elif kernel == "k4":
        ins, plain = (rand(40, 64, scale=1e-2).to(bf), *form, 1e-5), fb._torch_ln_ff_residual
    else:
        ins, plain = (rand(40, 64).to(bf), form[2], form[3]), ff._torch_geglu
    tail = (True,) if kernel == "k4" else ()

    def run(approximate, fp32, flag=True):
        args = f32(ins) if fp32 else ins
        return plain(*args, approximate if flag else True, *tail).to(bf)

    chip_smoke.gelu_form_check(kernel, lambda a, k: run(a, k))
    with pytest.raises(RuntimeError, match="did not compute erf gelu"):
        chip_smoke.gelu_form_check(kernel, lambda a, k: run(a, k, flag=not k))


def test_device_activity_takes_the_union_of_kernel_spans(monkeypatch):
    """``chip_smoke.device_activity`` (the idle share of ``port_step_probe.py``
    and ``tools/fused_block_steps.py``): overlapping kernels count once, gaps
    not at all, host events are left out."""
    import chip_smoke
    from torch.autograd import DeviceType

    _fake_traces(monkeypatch, [[("a", 0, 10), ("b", 5, 12), ("a", 20, 25), ("c", 30, 31),
                                ("host", 0, 100, DeviceType.CPU)]])
    busy, span, per_name = chip_smoke.device_activity(lambda: None)
    assert (busy, span) == (12 + 5 + 1, 31)
    assert per_name == {"a": [15.0, 2], "b": [7.0, 1], "c": [1.0, 1]}


def _fake_traces(monkeypatch, traces):
    """``torch.profiler.profile`` replaced by one that yields the next of
    ``traces`` (lists of (device function name, start µs, end µs[, device
    type])) for each profiled run, as the raw kineto events that
    ``chip_smoke.device_activity`` reads (times in ns from a trace start of
    7 µs)."""
    import types

    import torch.profiler
    from torch.autograd import DeviceType

    def ev(name, start, end, kind=DeviceType.CUDA):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: kind, is_hidden_event=lambda: False,
            start_ns=lambda: 7000 + 1000 * start, end_ns=lambda: 7000 + 1000 * end)

    runs = iter(traces)

    class Profile:
        def __init__(self, **_):
            trace = [ev(*t) for t in next(runs)]
            results = types.SimpleNamespace(events=lambda: trace, trace_start_ns=lambda: 7000)
            self.profiler = types.SimpleNamespace(kineto_results=results)

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


def test_device_activity_refuses_a_partial_trace(monkeypatch, capsys):
    """A run that launched K2 twice and K1 once (their counters) but whose
    trace holds one K2 event is partial: it is traced again, and after three
    partial traces the result is None and "not measured" is printed; a
    complete retry is taken as it is, never scaled up."""
    import chip_smoke

    fa.KERNEL.reset()
    gn.KERNEL.reset()

    def run():
        fa.KERNEL.launches += 2
        gn.KERNEL.launches += 1

    k2 = "void (anonymous namespace)::flash_fwd_kernel<64>(CUtensorMap, float)"
    k1 = "void (anonymous namespace)::gn_fused_kernel<true>(bf16 const*)"
    partial = [(k2, 0, 10), (k1, 10, 12), ("other", 12, 14)]
    whole = partial + [(k2, 20, 30)]
    _fake_traces(monkeypatch, [partial] * 3)
    assert chip_smoke.device_activity(run) is None
    out = capsys.readouterr().out
    assert "flash_attention 1 events of 2 launches" in out and "not measured" in out
    _fake_traces(monkeypatch, [partial, whole])
    busy, span, per_name = chip_smoke.device_activity(run)
    assert (busy, span) == (14 + 10, 30) and per_name[k2] == [20.0, 2]
    # the two-pass branch of K1 counts by its apply kernel, K2's backward by its main pass
    names = ["gn_stats_kernel<8>", "gn_apply_kernel<8>", "flash_bwd_prep_kernel<64>",
             "flash_bwd_kernel<64>", "flash_bwd_dq_convert_kernel<64>"]
    assert chip_smoke.traced_launches(names, ["group_norm_silu", "flash_attention_bwd",
                                              "flash_attention"]) == {
        "group_norm_silu": 1, "flash_attention_bwd": 1, "flash_attention": 0}
    fa.KERNEL.reset()
    gn.KERNEL.reset()


def test_nondeterministic_ops_names_what_pytorch_flags():
    """Phase 14's diagnostic (``chip_smoke.nondeterministic_ops``): under
    ``use_deterministic_algorithms(True, warn_only=True)`` an op without a
    deterministic implementation still runs, is named once however often it
    runs, and the mode is off again afterwards; deterministic ops name
    nothing."""
    import chip_smoke

    def run():
        x = torch.zeros(4)
        for _ in range(3):
            x.put_(torch.tensor([0, 1]), torch.tensor([1.0, 2.0]), accumulate=False)
        return x

    out, named = chip_smoke.nondeterministic_ops(run)
    assert out.tolist() == [1.0, 2.0, 0.0, 0.0]
    assert len(named) == 1 and named[0].startswith("put_ does not have a deterministic")
    assert not torch.are_deterministic_algorithms_enabled()
    assert chip_smoke.nondeterministic_ops(lambda: torch.ones(3).sum())[1] == []
