"""K2 backward over (B, N) pairs of T x T self-attention, head dim H.

Operations: the five products S, dP, dV, dQ, dK, 2 T^2 H each. Bytes: Q, K, V,
O, dO read, dQ, dK, dV written, and the forward's fp32 log-sum-exp read. A
recompute inside the kernel is not counted: the bound is the function's.
"""

from harness.peaks import BF16, BF16_FLOPS, TF32X3_FLOPS, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.flash_attention", "attention_bnth_bwd")
COUNTERS = ("KERNEL_BWD", "KERNEL_FP32_BWD")
DEVICE_FUNCTIONS = ("flash_bwd_prep_kernel", "flash_bwd_kernel", "flash_bwd_dq_convert_kernel",
                    "fp32_bwd_dkv_kernel", "fp32_bwd_dq_kernel")
ONE_PER_LAUNCH = ("flash_bwd_kernel", "fp32_bwd_dkv_kernel")


def cost(q, k, v, o, do, lse) -> Cost:
    b, n, t, h = q.shape
    itemsize = q.element_size()
    return Cost(flops=10 * b * n * t * t * h, bytes=itemsize * 8 * b * n * t * h + 4 * b * n * t,
                peak_flops=BF16_FLOPS if itemsize == BF16 else TF32X3_FLOPS)
