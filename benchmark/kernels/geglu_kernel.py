"""K5: x (m, c) @ W (2d, c)^T + b, then value * gelu(gate), (m, d) out."""

from harness.peaks import BF16, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.fused_ff", "geglu_kernel")
COUNTERS = ("KERNEL",)
DEVICE_FUNCTIONS = ("geglu_kernel",)
ONE_PER_LAUNCH = ("geglu_kernel",)


def shape_cost(m: int, c: int, d: int) -> Cost:
    return Cost(flops=2 * m * c * 2 * d, bytes=BF16 * (m * c + m * d + 2 * d * c + 2 * d))


def cost(x, w, b, approximate=True) -> Cost:
    c = x.shape[-1]
    return shape_cost(x.numel() // c, c, w.shape[0] // 2)
