"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device of capability
>= (9, 0). This file imports no JAX, so it runs on a machine with only PyTorch
and the CUDA toolkit:

    python -m pytest tests/test_torch_port_gpu.py --noconftest -p no:cacheprovider -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)

Tolerances. Kernel against plain version, bf16: ``|err| <= atol + rtol*|plain|``
with atol covering one bf16 rounding of outputs of order one (2^-8 relative)
plus fp32 summation-order differences, rtol 2e-2 for two such roundings of
larger values; K3 gets atol 3e-2 for its residual sums of order four. Module
wiring tests compare a bf16 module on the
card with the same bf16-rounded weights in fp32 on the CPU, within 5e-2 of the
output's largest magnitude: a wrong head split or transpose gives errors of
the order of the output itself.
"""

import copy

import pytest
import torch

from ctrl_adapter_tpu_torch.nn.attention import Attention, TemporalBasicTransformerBlock
from ctrl_adapter_tpu_torch.nn.resnet import GroupNorm
from ctrl_adapter_tpu_torch.ops import flash_attention as tfa
from ctrl_adapter_tpu_torch.ops import fused_temporal as tft
from ctrl_adapter_tpu_torch.ops import group_norm as tgn

BF = torch.bfloat16


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels are built for sm_90a)")
    return torch.device("cuda")


def _rand(gen, dev, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * scale


def _check(got, want, atol, rtol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    assert (err <= bound).all(), f"max abs err {err.max().item():.3e}"


def _launches(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,silu,flat", [
    ((4, 320, 16, 16), True, False),
    ((2, 64, 3, 5, 7), False, False),
    ((2, 320, 14, 8, 8), True, False),
    ((2, 64, 8, 8), True, True),
], ids=["bf16-vec", "bf16-scalar-S105", "bf16-5d-vec", "bf16-near-constant"])
def test_gpu_k1_kernel_matches_plain(shape, silu, flat):
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(0)
    x = _rand(g, dev, *shape)
    if flat:  # variance far below eps: the clamp keeps rstd finite
        x[:, :2] = 0.1 + 1e-4 * x[:, :2]
    x = x.to(BF)
    c = shape[1]
    w = (1.0 + _rand(g, dev, c, scale=0.1)).to(BF)
    b = _rand(g, dev, c, scale=0.1).to(BF)
    got = _launches(tgn.KERNEL, lambda: tgn.group_norm_silu(x, w, b, 32, 1e-6, silu))
    want = tgn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu)
    _check(got, want, atol=1e-2, rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("layout", ["bnth", "btnh-view"])
def test_gpu_k2_kernel_matches_plain(h, layout):
    """Contiguous (B, N, T, H) tensors and head-split views of (B, T, N*H)
    projections (what ``Attention`` passes)."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(1)
    b, n, t = 2, 3, 1024
    if layout == "bnth":
        q, k, v = (_rand(g, dev, b, n, t, h).to(BF) for _ in range(3))
    else:
        q, k, v = (_rand(g, dev, b, t, n * h).to(BF).view(b, t, n, h).transpose(1, 2)
                   for _ in range(3))
    got = _launches(tfa.KERNEL, lambda: tfa.attention_bnth(q, k, v))
    want = tfa._torch_attention(q, k, v)
    _check(got, want, atol=1e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("f,s,c,heads,cross", [
    (14, 64, 128, 2, False),
    (14, 48, 512, 5, True),
    (14, 12, 1280, 20, True),
    (14, 7, 320, 5, True),
    (32, 8, 128, 2, True),
], ids=["ia=c", "adapter-c512-ia320", "c1280-ts4", "odd-s-ts1", "f32"])
def test_gpu_k3_kernel_matches_plain(f, s, c, heads, cross):
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(2)
    ia = heads * 64
    x = _rand(g, dev, 2, f, s, c).to(BF)
    cb = _rand(g, dev, 2, s, c, scale=0.5).to(BF) if cross else None
    args = ((1.0 + _rand(g, dev, c, scale=0.1)).to(BF), _rand(g, dev, c, scale=0.1).to(BF),
            _rand(g, dev, ia, c, scale=c ** -0.5).to(BF),
            _rand(g, dev, ia, c, scale=c ** -0.5).to(BF),
            _rand(g, dev, ia, c, scale=c ** -0.5).to(BF),
            _rand(g, dev, c, ia, scale=ia ** -0.5).to(BF), _rand(g, dev, c, scale=0.1).to(BF),
            heads, 1e-5)
    got = _launches(tft.KERNEL, lambda: tft.temporal_block(x, cb, *args))
    want = tft._torch_temporal_block(x, cb, *args)
    _check(got, want, atol=3e-2, rtol=2e-2)


@pytest.mark.gpu
def test_gpu_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _dev()
    for dtype in (torch.float16, torch.float32):  # K1 takes bf16 only
        x_ = torch.zeros(2, 64, 4, 4, device=dev, dtype=dtype)
        w_ = torch.ones(64, device=dev, dtype=dtype)
        with pytest.raises(TypeError):
            tgn.group_norm_silu(x_, w_, w_, 32)
    xt = torch.zeros(2, 64, 4, 4, device=dev, dtype=BF).transpose(2, 3)
    w = torch.ones(64, device=dev, dtype=BF)
    with pytest.raises(ValueError):
        tgn.group_norm_silu(xt, w, w, 32)
    q32 = torch.zeros(1, 2, 1024, 64, device=dev)
    with pytest.raises(TypeError):
        tfa.attention_bnth(q32, q32, q32)
    q = torch.zeros(1, 2, 1024, 96, device=dev, dtype=BF)
    with pytest.raises(ValueError):
        tfa.attention_bnth(q, q, q)
    x = torch.zeros(2, 14, 8, 128, device=dev, dtype=BF)
    wt = torch.zeros(128, 128, device=dev, dtype=BF)
    b = torch.zeros(128, device=dev, dtype=BF)
    with pytest.raises(ValueError):  # 4 heads of 32: the kernel takes head_dim 64
        tft.temporal_block(x, None, b, b, wt, wt, wt, wt, b, 4)


@pytest.mark.gpu
def test_gpu_modules_raise_where_the_kernels_refuse():
    """The modules dispatch on the JAX rule alone, so a card tensor the kernel
    does not take reaches the wrapper and raises instead of running plain."""
    dev = _dev()
    with torch.no_grad():
        attn = Attention(128, 2, 64, device=dev)  # fp32, flash-eligible T = 1024
        with pytest.raises(TypeError):
            attn(torch.zeros(1, 1024, 128, device=dev))
        block = TemporalBasicTransformerBlock(128, 128, 4, 32, device=dev, dtype=BF)
        with pytest.raises(ValueError):  # bf16 dispatches to K3, which takes head_dim 64
            block(torch.zeros(2 * 14, 8, 128, device=dev, dtype=BF), 14)


def _bf16_pair(module: torch.nn.Module, dev):
    """The module with bf16-rounded weights: fp32 on the CPU and bf16 on ``dev``."""
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_((torch.randn(p.shape, generator=g) * 0.05).to(BF).float())
    cpu = module.float().eval()
    return cpu, copy.deepcopy(cpu).to(dev, BF)


@pytest.mark.gpu
def test_gpu_modules_dispatch_to_the_kernels():
    """bf16 modules on the card launch K1, K2 and K3 where the JAX dispatch
    runs its Pallas kernels, and agree with the fp32 CPU path."""
    dev = _dev()
    g = torch.Generator().manual_seed(4)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(BF).float()  # noqa: E731
    b, f, s = 2, 14, 16
    cases = [
        (GroupNorm(32, 320, 1e-6, kernel=True), tgn.KERNEL, (rand(2, 320, 14, 8, 8),),
         dict(silu=True)),
        (Attention(128, 2, 64), tfa.KERNEL, (rand(2, 1024, 128),), {}),
        (TemporalBasicTransformerBlock(128, 128, 2, 64, 96), tft.KERNEL,
         (rand(b * f, s, 128), f, rand(b * s, 1, 96)), {}),
    ]
    with torch.no_grad():
        for module, kernel, args, kw in cases:
            cpu, card = _bf16_pair(module, dev)
            on_card = [a.to(dev, BF) if torch.is_tensor(a) else a for a in args]
            got = _launches(kernel, lambda: card(*on_card, **kw)).float().cpu()
            want = cpu(*args, **kw)
            err = (got - want).abs().max()
            assert err <= 5e-2 * want.abs().max(), f"{type(module).__name__}: {err:.3e}"
