"""K3 full: K3 hybrid's work plus the two LayerNorm -> GEGLU feed-forwards
(inner width ``inner``) around it, in one launch."""

from harness.peaks import BF16, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.fused_temporal", "temporal_block_full")
COUNTERS = ("KERNEL_FULL",)
DEVICE_FUNCTIONS = ("temporal_full_kernel",)
ONE_PER_LAUNCH = ("temporal_full_kernel",)


def ff_flops(rows: int, c: int, inner: int, cout: int) -> int:
    return 2 * rows * c * 2 * inner + 2 * rows * inner * cout


def ff_weight_elems(c: int, inner: int, cout: int) -> int:
    return 2 * c + 2 * inner * c + 2 * inner + cout * inner + cout


def block_cost(b: int, f: int, s: int, c: int, ia: int, inner: int, cross: bool) -> Cost:
    rows = b * f * s
    weights = 2 * c + 4 * ia * c + c
    attn_flops = 2 * rows * c * 3 * ia + 2 * rows * ia * c + 4 * b * s * f * f * ia
    attn_bytes = BF16 * (2 * rows * c + cross * b * s * c + weights)
    return Cost(flops=attn_flops + 2 * ff_flops(rows, c, inner, c),
                bytes=attn_bytes + BF16 * 2 * ff_weight_elems(c, inner, c))


def cost(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps, ffin, ff,
         approximate=True) -> Cost:
    b, f, s, c = x.shape
    return block_cost(b, f, s, c, wq.shape[0], ffin[2].shape[0] // 2, cross_bias is not None)
