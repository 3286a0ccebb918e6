"""Host-side planning of the redesigned kernels, and the roofline arithmetic
that ``chip_smoke.py`` prints, against hand-worked cases. Plain Python on
shapes: runs on the CPU.

- K2 (``ops/flash_attention.py``): :func:`plan` (128-row Q tiles, the K/V ring,
  grid, shared memory) and :func:`tma_view_error` (what a TMA tensor map needs
  of a strided view).
- K3 full (``ops/fused_temporal.py``): :func:`full_plan` (tile of ts
  positions, grid, shared memory).

The kernels launch the plans' grids and refuse shared-memory sizes other than
their own configurations', so a plan that drifts from the C side fails on the
card instead of launching.
- ``ops/roofline.py``: FLOPs, bytes and the bound of every kernel row.
"""

import pytest
import torch

from ctrl_adapter_tpu_torch.ops import flash_attention as fa
from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
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
], ids=["unet-l0", "unet-l1", "h128", "one-tile"])
def test_flash_plan_hand_worked(b, n, t, h, work, grid, stages, smem):
    p = fa.plan(b, n, t, h, sms=132)
    assert (p.work, p.grid, p.stages, p.smem_bytes) == (work, grid, stages, smem)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert fa.plan(b, n, t, h, sms=16).grid == (min(work, 16),)


@pytest.mark.parametrize("t,h", [(1088, 64), (1024, 96), (64, 64), (1024, 32)])
def test_flash_plan_refuses_what_the_tiling_does_not_fit(t, h):
    with pytest.raises(ValueError):
        fa.plan(2, 3, t, h, sms=132)


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


# --------------------------------------------------------------- roofline
def test_roofline_attention_hand_worked():
    cost = rl.attention(28, 5, 4096, 4096, 64)
    assert cost.flops == 4 * 28 * 5 * 4096 * 4096 * 64 == 601_295_421_440
    assert cost.bytes == 2 * 28 * 5 * 64 * 4 * 4096 == 293_601_280
    assert cost.bound_by == "operations"
    assert cost.bound_ms == pytest.approx(601_295_421_440 / 989e9, rel=1e-12)
    assert rl.attention(28, 10, 1024, 1024, 64).bound_ms == pytest.approx(0.0760, abs=1e-4)


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


def test_chip_smoke_row_carries_the_bound_and_the_first_library_call():
    import chip_smoke

    cost = rl.attention(28, 5, 4096, 4096, 64)
    row = chip_smoke.report("(28,5,4096,64)", 1e-3, 1.5, 30.0, cost,
                            {"SDPA default (CUDNN_ATTENTION)": 1.3, "SDPA FLASH_ATTENTION": None})
    assert row["library_ms"] == 1.3
    assert row["bound_ms"] == cost.bound_ms and row["bound_by"] == "operations"
    assert chip_smoke.report("x", 0.0, 1.0, 1.0, cost)["library_ms"] is None
