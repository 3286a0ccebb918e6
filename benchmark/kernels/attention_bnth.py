"""K2: softmax(Q K^T / sqrt(H)) V over (B, N, T, H) views.

Operations: Q K^T and P V, 4 B N T S H. Bytes: Q, K, V read and O written once.
bf16 runs on the tensor cores (989 TFLOP/s); fp32 runs as three tf32 passes.
"""

from harness.peaks import BF16, BF16_FLOPS, TF32X3_FLOPS, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.flash_attention", "attention_bnth")
COUNTERS = ("KERNEL", "KERNEL_FP32")
DEVICE_FUNCTIONS = ("flash_fwd_kernel", "flash_fp32_fwd_kernel", "tf32_split_kernel")
ONE_PER_LAUNCH = ("flash_fwd_kernel", "flash_fp32_fwd_kernel")


def cost(q, k, v) -> Cost:
    b, n, t, h = q.shape
    s = k.shape[2]
    itemsize = q.element_size()
    return Cost(flops=4 * b * n * t * s * h, bytes=itemsize * b * n * h * (2 * t + 2 * s),
                peak_flops=BF16_FLOPS if itemsize == BF16 else TF32X3_FLOPS)
