"""The numerics of K2 fp32 and K2 bwd fp32's products, emulated on the CPU.

The kernels (``csrc/tf32_tiles.cuh``) split each fp32 operand x into
hi = x rounded to tf32 (to nearest, ties away from zero: ``cvt.rna.tf32.f32``)
and lo = x - hi, rounded to tf32 too, and compute a product A B as
A_hi B_lo + A_lo B_hi + A_hi B_hi on the tensor cores (3xTF32). Here the split
is made with int32 bit masks and the three products in fp32 (a product of two
tf32 values is exact in fp32), for attention's forward (S = Q K^T, O = P V) and
its backward's five products (S, dP = dO V^T, dV = P^T dO, dQ = dS K,
dK = dS^T Q), against the plain fp32 versions the card holds the kernels to.
3xTF32 lands within the card's gate, 1e-5 of each output's norm
(``chip_smoke.FP32_TOL``); one tf32 pass (hi B_hi alone) lands outside it, so
the gate sees a dropped lo term.
"""

import numpy as np
import pytest
import torch

from ctrl_adapter_tpu_torch.ops import flash_attention as fa

GATE = 1e-5  # chip_smoke.FP32_TOL: ||kernel - plain|| <= GATE ||plain||


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero: add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels' tensor-core products: 3xTF32 or one tf32 pass."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return ah @ bl + al @ bh + ah @ bh


def _inputs(b, n, t, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, t, h), dtype=np.float32))
            for _ in range(4)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()


def _forward(q, k, v, passes):
    """The kernel's forward on one block of keys: P = exp(s S - m) split as
    registers, O = (P V) / l."""
    s = _mm(q, k.transpose(-1, -2), passes) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _mm(p, v, passes) / p.sum(-1, keepdim=True)


def _backward(q, k, v, o, do, lse, passes):
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_mm(q, k.transpose(-1, -2), passes) * scale - lse[..., None])
    dp = _mm(do, v.transpose(-1, -2), passes)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return (_mm(ds, k, passes) * scale, _mm(ds.transpose(-1, -2), q, passes) * scale,
            _mm(p.transpose(-1, -2), do, passes))


SHAPES = pytest.mark.parametrize("b,n,t,h", [(1, 2, 512, 64), (2, 2, 1024, 64)],
                                 ids=["t512", "t1024"])


def test_tf32_split_is_exact_in_two_parts():
    """hi + lo gives x back to ~2^-22 of |x|: hi keeps 11 significant bits,
    lo the next 11; hi alone is off by up to 2^-11."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000, dtype=np.float32))
    hi, lo = _split(x)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert ((x - (hi + lo)).abs() <= 2.0 ** -21 * x.abs()).all()
    assert (x - hi).abs().max() > 2.0 ** -13 * x.abs().max()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()


@SHAPES
def test_3xtf32_forward_is_within_the_fp32_gate(b, n, t, h):
    q, k, v, _ = _inputs(b, n, t, h, seed=t + b)
    want = fa._torch_attention(q, k, v)
    three, one = _rel(_forward(q, k, v, 3), want), _rel(_forward(q, k, v, 1), want)
    assert three <= GATE / 5, three
    assert one > GATE, one


@SHAPES
def test_3xtf32_backward_is_within_the_fp32_gate(b, n, t, h):
    q, k, v, do = _inputs(b, n, t, h, seed=t + b + 1)
    o, lse = fa._torch_attention(q, k, v, True)
    want = fa._torch_attention_bwd(q, k, v, o, do, lse)
    three = [_rel(x, y) for x, y in zip(_backward(q, k, v, o, do, lse, 3), want)]
    one = [_rel(x, y) for x, y in zip(_backward(q, k, v, o, do, lse, 1), want)]
    assert max(three) <= GATE / 5, three
    assert min(one) > GATE, one
