"""The benchmark's frozen kernel costs equal the program's ``ops/roofline.py``
of today at the main path's shapes and at odd ones."""

import pytest
import torch

from harness.manifest import kernel_ops
from ctrl_adapter_tpu_torch.ops import roofline

OPS = kernel_ops()


def t(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def same(a, b):
    assert a.flops == b.flops and a.bytes == b.bytes and a.peak_flops == b.peak_flops


@pytest.mark.parametrize("shape,silu,dtype", [((28, 320, 64, 64), True, torch.bfloat16),
                                              ((2, 1280, 14, 8, 8), False, torch.bfloat16),
                                              ((28, 640, 32, 32), True, torch.float32)])
def test_group_norm(shape, silu, dtype):
    x = t(*shape, dtype=dtype)
    same(OPS["group_norm_silu"].cost(x, t(shape[1]), t(shape[1]), 32, 1e-6, silu),
         roofline.group_norm(shape, silu, x.element_size()))


@pytest.mark.parametrize("b,n,tq,h,dtype", [(28, 5, 4096, 64, torch.bfloat16),
                                            (32, 20, 256, 64, torch.bfloat16),
                                            (2, 8, 1024, 128, torch.float32)])
def test_attention(b, n, tq, h, dtype):
    q = t(b, n, tq, h, dtype=dtype)
    same(OPS["attention_bnth"].cost(q, q, q), roofline.attention(b, n, tq, tq, h,
                                                                  q.element_size()))
    same(OPS["attention_bnth_bwd"].cost(q, q, q, q, q, t(b, n, tq, dtype=torch.float32)),
         roofline.attention_bwd(b, n, tq, h, q.element_size()))


@pytest.mark.parametrize("b,f,s,c,ia,cross", [(2, 14, 1024, 640, 640, True),
                                              (2, 14, 4096, 320, 512, False)])
def test_temporal_blocks(b, f, s, c, ia, cross):
    x = t(b, f, s, c)
    w = t(ia, c)
    bias = t(b, s, c) if cross else None
    same(OPS["temporal_block"].cost(x, bias, t(c), t(c), w, w, w, t(c, ia), t(c), 8, 1e-5),
         roofline.temporal_block(b, f, s, c, ia, cross))
    inner = 4 * c
    ff = (t(c), t(c), t(2 * inner, c), t(2 * inner), t(c, inner), t(c))
    same(OPS["temporal_block_full"].cost(x, bias, t(c), t(c), w, w, w, t(c, ia), t(c), 8, 1e-5,
                                         ff, ff, True),
         roofline.temporal_block_full(b, f, s, c, ia, inner, cross))


@pytest.mark.parametrize("m,c,inner,cout", [(57344, 320, 1280, 320), (4096, 640, 2560, 512)])
def test_feed_forwards(m, c, inner, cout):
    x = t(m, c)
    same(OPS["ln_ff_kernel"].cost(x, t(c), t(c), t(2 * inner, c), t(2 * inner), t(cout, inner),
                                  t(cout), 1e-5, True, True),
         roofline.ln_ff(m, c, inner, cout, True))
    same(OPS["geglu_kernel"].cost(x, t(2 * inner, c), t(2 * inner), True),
         roofline.geglu(m, c, inner))
