"""K3 hybrid on x (b, f, s, c): LayerNorm, QKV, attention over the frames, the
output projection and the residual (+ the (b, s, c) cross bias).

Operations: the QKV and output projections and the f x f attention per
position and head. Bytes: x read and the output written, the cross bias and
the weights.
"""

from harness.peaks import BF16, Cost

ENTRY = ("ctrl_adapter_tpu_torch.ops.fused_temporal", "temporal_block")
COUNTERS = ("KERNEL",)
DEVICE_FUNCTIONS = ("hybrid_qkv_attn_kernel", "out_proj_kernel")
ONE_PER_LAUNCH = ("hybrid_qkv_attn_kernel",)


def attention_flops(rows: int, b: int, s: int, f: int, c: int, ia: int) -> int:
    return 2 * rows * c * 3 * ia + 2 * rows * ia * c + 4 * b * s * f * f * ia


def block_cost(b: int, f: int, s: int, c: int, ia: int, cross: bool) -> Cost:
    rows = b * f * s
    weights = 2 * c + 4 * ia * c + c
    return Cost(flops=attention_flops(rows, b, s, f, c, ia),
                bytes=BF16 * (2 * rows * c + cross * b * s * c + weights))


def cost(x, cross_bias, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps=1e-5) -> Cost:
    b, f, s, c = x.shape
    return block_cost(b, f, s, c, wq.shape[0], cross_bias is not None)
