"""The least time an H100 could take for each kernel's work: its roofline bound.

``bound_ms`` is the larger of two times: the bytes the function must move (each
input read once, each output written once, whatever a kernel re-reads) over the
card's memory rate, and the operations it does over the card's peak rate for
their type. Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W
(dense, no sparsity). The bf16 matrix kernels count only their tensor-core
products (bf16, 989 TFLOP/s); the normalisation counts its fp32 arithmetic
outside the tensor cores (67 TFLOP/s). The fp32 attention kernels count their
products at the 3xTF32 rate they run at: three tf32 tensor-core passes a
product (494.5 TFLOP/s each, ~164.8 TFLOP/s of fp32-accurate products); one
pass alone keeps ~3 decimal digits, not fp32's. K1 in fp32 stays at 67 TFLOP/s.

Plain Python on shapes, so the CPU tests check the arithmetic and
``chip_smoke.py`` prints it beside each kernel's measured time.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod

H100_BF16_FLOPS = 989e12   # tensor cores, dense bf16
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_TF32_FLOPS = 494.5e12  # tensor cores, dense tf32
TF32X3_FLOPS = H100_TF32_FLOPS / 3  # fp32 products as three tf32 passes
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_SM_CLOCK = 1.83e9      # the clock of the peaks above: 989 TFLOP/s = 132 SMs x 4,096 flop
H100_EXP2_PER_S = 132 * 16 * H100_SM_CLOCK  # ex2 on the SFUs, 16 a clock per SM
BF16 = 2                    # bytes per element
FP32 = 4


@dataclass(frozen=True)
class Cost:
    flops: float
    bytes: float
    peak_flops: float = H100_BF16_FLOPS
    exps: float = 0.0  # exponentials on the SFUs, counted where they can bound the kernel

    @property
    def compute_ms(self) -> float:
        return 1e3 * self.flops / self.peak_flops

    @property
    def memory_ms(self) -> float:
        return 1e3 * self.bytes / H100_BYTES_PER_S

    @property
    def exp_ms(self) -> float:
        return 1e3 * self.exps / H100_EXP2_PER_S

    @property
    def bound_ms(self) -> float:
        return max(self.compute_ms, self.memory_ms, self.exp_ms)

    @property
    def bound_by(self) -> str:
        if self.exp_ms > max(self.compute_ms, self.memory_ms):
            return "exponentials"
        return "operations" if self.compute_ms >= self.memory_ms else "bytes"


def group_norm(shape, silu: bool, itemsize: int = BF16) -> Cost:
    """K1 on an (N, C, *spatial) tensor of ``itemsize`` bytes an element (bf16
    or fp32): x read once, y written once, the (C,) weight and bias; per
    element two fp32 ops for the statistics, three for the affine, four more
    for SiLU."""
    elems, c = prod(shape), shape[1]
    return Cost(flops=elems * (5 + 4 * silu), bytes=itemsize * (2 * elems + 2 * c),
                peak_flops=H100_FP32_FLOPS)


def attention(b: int, n: int, t: int, s: int, h: int, itemsize: int = BF16) -> Cost:
    """K2: Q K^T and P V over (b, n) pairs, T queries, S keys, head dim H; bf16
    on the tensor cores, or (``itemsize`` 4) fp32 in 3xTF32."""
    return Cost(flops=4 * b * n * t * s * h, bytes=itemsize * b * n * h * (2 * t + 2 * s),
                peak_flops=H100_BF16_FLOPS if itemsize == BF16 else TF32X3_FLOPS)


def attention_narrow(b: int, n: int, t: int, s: int, h: int) -> Cost:
    """K2 at head dim 40 or 80 (bf16): the products at the true H on the
    tensor cores (the padded columns are the kernel's cost, not the
    function's), and one exponential a logit on the SFUs, which bounds these
    head dims at T = 4096."""
    return Cost(flops=4 * b * n * t * s * h, bytes=BF16 * b * n * h * (2 * t + 2 * s),
                exps=b * n * t * s)


def attention_bwd(b: int, n: int, t: int, h: int, itemsize: int = BF16) -> Cost:
    """K2's backward over (b, n) pairs of T x T self-attention, head dim H: the
    five products S, dP, dV, dQ, dK (2 T^2 H flop each) against Q, K, V, O, dO
    read and dQ, dK, dV written (bf16, or fp32 for ``itemsize`` 4, in 3xTF32)
    and the forward's fp32 log-sum-exp read. The fp32 kernel's recompute of S
    and dP is not counted: the bound is the function's."""
    return Cost(flops=10 * b * n * t * t * h,
                bytes=itemsize * 8 * b * n * t * h + 4 * b * n * t,
                peak_flops=H100_BF16_FLOPS if itemsize == BF16 else TF32X3_FLOPS)


def _temporal_attention_flops(rows: int, b: int, s: int, f: int, c: int, ia: int) -> int:
    # QKV and out projections, and frame attention (f x f per position and head)
    return 2 * rows * c * 3 * ia + 2 * rows * ia * c + 4 * b * s * f * f * ia


def _ff_flops(rows: int, c: int, inner: int, cout: int) -> int:
    return 2 * rows * c * 2 * inner + 2 * rows * inner * cout


def _ff_weight_elems(c: int, inner: int, cout: int) -> int:
    return 2 * c + 2 * inner * c + 2 * inner + cout * inner + cout


def temporal_block(b: int, f: int, s: int, c: int, ia: int, cross: bool) -> Cost:
    """K3 hybrid on x (b, f, s, c): LN1, QKV, frame attention, out + residual
    (+ the (b, s, c) cross bias)."""
    rows = b * f * s
    weights = 2 * c + 4 * ia * c + c
    return Cost(flops=_temporal_attention_flops(rows, b, s, f, c, ia),
                bytes=BF16 * (2 * rows * c + cross * b * s * c + weights))


def temporal_block_full(b: int, f: int, s: int, c: int, ia: int, inner: int,
                        cross: bool) -> Cost:
    """K3 full: K3 hybrid's work plus the two LN -> GEGLU FFs (inner width
    ``inner``) around it, one launch."""
    rows = b * f * s
    attn = temporal_block(b, f, s, c, ia, cross)
    return Cost(flops=attn.flops + 2 * _ff_flops(rows, c, inner, c),
                bytes=attn.bytes + BF16 * 2 * _ff_weight_elems(c, inner, c))


def ln_ff(m: int, c: int, inner: int, cout: int, residual: bool) -> Cost:
    """K4: LN -> GEGLU FF (-> + x) over m rows."""
    return Cost(flops=_ff_flops(m, c, inner, cout),
                bytes=BF16 * (m * c + m * cout + _ff_weight_elems(c, inner, cout)))


def geglu(m: int, c: int, d: int) -> Cost:
    """K5: x (m, c) @ W (2d, c)^T + b, then value * gelu(gate): (m, d) out."""
    return Cost(flops=2 * m * c * 2 * d, bytes=BF16 * (m * c + m * d + 2 * d * c + 2 * d))
