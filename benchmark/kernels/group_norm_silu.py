"""K1: GroupNorm of (N, C, *spatial) with the affine step and an optional SiLU.

Bytes: x read once and y written once, the (C,) weight and bias. Operations:
two fp32 operations an element for the statistics, three for the affine step,
four more for the SiLU, at the fp32 rate outside the tensor cores.
"""

from math import prod

from harness.peaks import BF16, FP32_FLOPS, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.group_norm", "group_norm_silu")
COUNTERS = ("KERNEL", "KERNEL_FP32")
DEVICE_FUNCTIONS = ("gn_fused_kernel", "gn_stats_kernel", "gn_apply_kernel", "gn_ring_kernel")
ONE_PER_LAUNCH = ("gn_fused_kernel", "gn_stats_kernel", "gn_ring_kernel")


def cost(x, weight, bias, num_groups=32, eps=1e-6, silu=False) -> Cost:
    shape = tuple(x.shape)
    elems, c = prod(shape), shape[1]
    itemsize = x.element_size() if hasattr(x, "element_size") else BF16
    return Cost(flops=elems * (5 + 4 * bool(silu)), bytes=itemsize * (2 * elems + 2 * c),
                peak_flops=FP32_FLOPS)
