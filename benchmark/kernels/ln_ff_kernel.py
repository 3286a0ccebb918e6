"""K4: LayerNorm -> GEGLU feed-forward (-> + x) over m rows of width c."""

from harness.peaks import BF16, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.fused_block", "ln_ff_kernel")
COUNTERS = ("KERNEL",)
DEVICE_FUNCTIONS = ("ln_ff_kernel",)
ONE_PER_LAUNCH = ("ln_ff_kernel",)


def shape_cost(m: int, c: int, inner: int, cout: int) -> Cost:
    flops = 2 * m * c * 2 * inner + 2 * m * inner * cout
    weights = 2 * c + 2 * inner * c + 2 * inner + cout * inner + cout
    return Cost(flops=flops, bytes=BF16 * (m * c + m * cout + weights))


def cost(x, ln_w, ln_b, wg, bg, w2, b2, eps, approximate, residual=True) -> Cost:
    c = x.shape[-1]
    return shape_cost(x.numel() // c, c, wg.shape[0] // 2, w2.shape[0])
