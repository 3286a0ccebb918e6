"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device of capability
>= (9, 0). This file imports no JAX, so it runs on a machine with only PyTorch
and the CUDA toolkit:

    python -m pytest tests/test_torch_port_gpu.py --noconftest -p no:cacheprovider -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)

Tolerances. Kernel against plain version, bf16: ``|err| <= atol + rtol*|plain|``
with atol covering one bf16 rounding of outputs of order one (2^-8 relative)
plus fp32 summation-order differences, rtol 2e-2 for two such roundings of
larger values; K3 and K4 get atol 3e-2 for their residual sums of order
four. K3 "hybrid"'s update (out - x - cross bias), which the residual hides
under that atol, is also held to 2e-2 of the plain update's norm, and its
output to an fp32 run as K3 "full"'s is. K3 "full" chains three residual
sub-blocks, each rounding the bf16
stream at other points in the two versions, so it gets atol 1e-1 against the
plain version and must also be no farther than 1.25x the plain version (+1e-2)
from an fp32 run of the plain version on the same inputs. K2 is also held
to a relative norm, ``||kernel - plain|| <= 1e-2 ||plain||``: its outputs are
averages over T keys, small beside the elementwise atol, and a K/V tile that
is skipped or read from the wrong ring slot moves them by far more than 1 %
of their norm while staying inside the atol; so is K5 at c = 640, whose
outputs (std ~0.1 at these inputs) sit far below its atol. Module
wiring tests compare a bf16 module on the
card with the same bf16-rounded weights in fp32 on the CPU, within 5e-2 of the
output's largest magnitude: a wrong head split or transpose gives errors of
the order of the output itself.
"""

import copy

import pytest
import torch

from ctrl_adapter_tpu_torch.nn.attention import (Attention, BasicTransformerBlock, FeedForward,
                                                 TemporalBasicTransformerBlock)
from ctrl_adapter_tpu_torch.nn.resnet import GroupNorm
from ctrl_adapter_tpu_torch.ops import flash_attention as tfa
from ctrl_adapter_tpu_torch.ops import fused_block as tfb
from ctrl_adapter_tpu_torch.ops import fused_ff as tff
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


def _check(got, want, atol, rtol, rel_norm=None):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    assert (err <= bound).all(), f"max abs err {err.max().item():.3e}"
    if rel_norm is not None:
        rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
        assert rel <= rel_norm, f"relative norm error {rel:.3e}"


def _launches(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,silu,flat,branch", [
    ((4, 320, 16, 16), True, False, "cluster"),
    ((2, 64, 3, 5, 7), False, False, "two_pass"),
    ((2, 320, 14, 8, 8), True, False, "cluster"),
    ((2, 64, 8, 8), True, True, "cluster"),
    ((28, 320, 32, 32), True, False, "one_cta"),
    ((28, 1280, 8, 8), False, False, "several_groups"),
    ((2, 320, 14, 64, 64), True, False, "cluster"),
    ((1, 32, 1, 1024, 1024), True, False, "two_pass"),
], ids=["bf16-vec", "bf16-scalar-S105", "bf16-5d-vec", "bf16-near-constant", "one-cta",
        "several-groups", "cluster8-1.1MB-group", "two-pass-2MB-group"])
def test_gpu_k1_kernel_matches_plain(shape, silu, flat, branch):
    """Every branch of the plan: one group a CTA, several a CTA, a group over a
    cluster (8 CTAs at the adapter's (2, 320, 14, 64, 64)), two passes (a
    spatial size of 105, a 2 MB group); one launch per call."""
    dev = _dev()
    assert tgn.plan(shape, 32).branch == branch
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
    again = tgn.group_norm_silu(x, w, b, 32, 1e-6, silu)  # fixed-order sums: bitwise equal
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1024, 4096])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("layout", ["bnth", "btnh-view"])
def test_gpu_k2_kernel_matches_plain(t, h, layout):
    """Contiguous (B, N, T, H) tensors and head-split views of (B, T, N*H)
    projections (what ``Attention`` passes), at both sequence lengths of the
    SVD path."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(1)
    b, n = 2, 3
    if layout == "bnth":
        q, k, v = (_rand(g, dev, b, n, t, h).to(BF) for _ in range(3))
    else:
        q, k, v = (_rand(g, dev, b, t, n * h).to(BF).view(b, t, n, h).transpose(1, 2)
                   for _ in range(3))
    got = _launches(tfa.KERNEL, lambda: tfa.attention_bnth(q, k, v))
    want = tfa._torch_attention(q, k, v)
    _check(got, want, atol=1e-2, rtol=2e-2, rel_norm=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("f,s,c,heads,cross,mode", [
    (14, 64, 128, 2, False, "resident"),
    (14, 48, 512, 5, True, "resident"),
    (14, 256, 512, 10, True, "resident"),
    (14, 24, 512, 20, True, "resident"),
    (14, 256, 640, 10, True, "alias"),
    (14, 12, 1280, 20, True, "streamed"),
    (14, 8, 768, 3, False, "streamed"),
    (14, 256, 768, 12, True, "streamed"),
    (14, 7, 320, 5, True, "resident"),
    (32, 8, 128, 2, True, "resident"),
    (8, 32, 704, 2, True, "alias"),
], ids=["ia=c", "adapter-c512-ia320", "adapter-c512-ia640", "adapter-c512-ia1280",
        "unet-l1-c640-alias", "c1280-streamed", "c768-streamed-no-cross", "c768-streamed-heads",
        "odd-s-ts1", "f32",
        "f8-c704-alias"])
def test_gpu_k3_kernel_matches_plain(f, s, c, heads, cross, mode):
    """Each (c, ia) of the main path (512/320, 512/640, 512/1280, 640/640) at
    small s and each layout of the plan, with one and several heads a CTA. The output against the plain version
    elementwise; the block's update (out - x - cross bias), which the residual
    would hide, to a relative norm of 2e-2; and both against an fp32 run of
    the plain version."""
    dev = _dev()
    assert tft.hybrid_plan(2, f, s, c, heads).mode == mode
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
    base = x.float() + (0 if cb is None else cb.float()[:, None])
    upd_k, upd_p = got.float() - base, want.float() - base
    rel = (torch.linalg.vector_norm(upd_k - upd_p) / torch.linalg.vector_norm(upd_p)).item()
    assert rel <= 2e-2, f"update relative norm error {rel:.3e}"
    f32 = lambda a: a.float() if torch.is_tensor(a) else a  # noqa: E731
    ref = tft._torch_temporal_block(f32(x), f32(cb), *map(f32, args))
    err_kernel = (got.float() - ref).abs().max().item()
    err_plain = (want.float() - ref).abs().max().item()
    assert err_kernel <= 1.25 * err_plain + 1e-2, (err_kernel, err_plain)


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
    q = torch.zeros(1, 2, 1088, 64, device=dev, dtype=BF)  # T % 128 != 0: off K2's tiling
    with pytest.raises(ValueError):
        tfa.attention_bnth(q, q, q)
    q = torch.zeros(1, 1024, 2 * 64 + 4, device=dev, dtype=BF)[..., :128].view(
        1, 1024, 2, 64).transpose(1, 2)  # row stride of 264 bytes: no tensor map
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
    """bf16 modules on the card launch K1, K2 and K3 ("full" here) where the
    JAX dispatch runs its Pallas kernels, and agree with the fp32 CPU path."""
    dev = _dev()
    g = torch.Generator().manual_seed(4)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(BF).float()  # noqa: E731
    b, f, s = 2, 14, 16
    cases = [
        (GroupNorm(32, 320, 1e-6, kernel=True), tgn.KERNEL, (rand(2, 320, 14, 8, 8),),
         dict(silu=True)),
        (Attention(128, 2, 64), tfa.KERNEL, (rand(2, 1024, 128),), {}),
        (TemporalBasicTransformerBlock(128, 128, 2, 64, 96), tft.KERNEL_FULL,
         (rand(b * f, s, 128), f, rand(b * s, 1, 96)), {}),  # "full" at this shape
    ]
    with torch.no_grad():
        for module, kernel, args, kw in cases:
            cpu, card = _bf16_pair(module, dev)
            on_card = [a.to(dev, BF) if torch.is_tensor(a) else a for a in args]
            got = _launches(kernel, lambda: card(*on_card, **kw)).float().cpu()
            want = cpu(*args, **kw)
            err = (got - want).abs().max()
            assert err <= 5e-2 * want.abs().max(), f"{type(module).__name__}: {err:.3e}"


def _ff(g, dev, c, inner, cout):
    """(ln_w, ln_b, wg, bg, w2, b2) of a GEGLU FF in nn.Linear layout, bf16."""
    return ((1.0 + _rand(g, dev, c, scale=0.1)).to(BF), _rand(g, dev, c, scale=0.1).to(BF),
            _rand(g, dev, 2 * inner, c, scale=c ** -0.5).to(BF),
            _rand(g, dev, 2 * inner, scale=0.1).to(BF),
            _rand(g, dev, cout, inner, scale=inner ** -0.5).to(BF),
            _rand(g, dev, cout, scale=0.1).to(BF))


def _k3_full_check(b, f, s, c, heads, cross, approximate):
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(5)
    ia = heads * 64
    x = _rand(g, dev, b, f, s, c).to(BF)
    cb = _rand(g, dev, b, s, c, scale=0.5).to(BF) if cross else None
    args = ((1.0 + _rand(g, dev, c, scale=0.1)).to(BF), _rand(g, dev, c, scale=0.1).to(BF),
            *(_rand(g, dev, ia, c, scale=c ** -0.5).to(BF) for _ in range(3)),
            _rand(g, dev, c, ia, scale=ia ** -0.5).to(BF), _rand(g, dev, c, scale=0.1).to(BF),
            heads, 1e-5, _ff(g, dev, c, 4 * c, c), _ff(g, dev, c, 4 * c, c), approximate)
    got = _launches(tft.KERNEL_FULL, lambda: tft.temporal_block_full(x, cb, *args))
    want = tft._torch_temporal_block(x, cb, *args)
    _check(got, want, atol=1e-1, rtol=2e-2)
    f32 = lambda a: a.float() if torch.is_tensor(a) else a  # noqa: E731
    ref = tft._torch_temporal_block(f32(x), f32(cb), *(
        tuple(map(f32, a)) if isinstance(a, tuple) else f32(a) for a in args))
    err_kernel = (got.float() - ref).abs().max().item()
    err_plain = (want.float() - ref).abs().max().item()
    assert err_kernel <= 1.25 * err_plain + 1e-2, (err_kernel, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,s,c,heads,cross", [
    (2, 14, 4096, 320, 5, True),
    (2, 6, 12, 128, 2, False),
    (1, 14, 7, 64, 1, True),
    (2, 32, 8, 192, 3, True),
    (2, 16, 64, 256, 4, False),
    (1, 16, 32, 320, 5, True),
], ids=["unet-l0", "thin-ts4", "odd-s-ts1", "f32-ts2", "f16-c256", "f16-c320"])
def test_gpu_k3_full_kernel_matches_plain(b, f, s, c, heads, cross):
    """Widths c = 64..320, 6 to 32 frames, with and without the cross bias."""
    _k3_full_check(b, f, s, c, heads, cross, True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,s,c,heads,cross", [
    (2, 14, 4096, 320, 5, True),
    (2, 6, 12, 128, 2, False),
], ids=["unet-l0", "thin-ts4"])
def test_gpu_k3_full_erf_gelu_matches_plain(b, f, s, c, heads, cross):
    """K3 full with exact (erf) gelu, what ``CTRL_ADAPTER_EXACT_GELU=1`` asks
    for, at the same tolerances."""
    _k3_full_check(b, f, s, c, heads, cross, False)


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,cout,residual", [
    (114688, 320, 320, True),
    (100, 64, 128, False),
    (777, 192, 192, True),
    (4160, 320, 320, False),
], ids=["unet-l0", "odd-dim-out", "odd-rows", "c320-no-residual"])
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_gpu_k4_kernel_matches_plain(m, c, cout, residual, approximate):
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(6)
    x = _rand(g, dev, m, c).to(BF)
    w = _ff(g, dev, c, 4 * c, cout)
    got = _launches(tfb.KERNEL, lambda: tfb.ln_ff_kernel(x, *w, 1e-5, approximate, residual))
    want = tfb._torch_ln_ff_residual(x, *w, 1e-5, approximate, residual)
    _check(got, want, atol=3e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,exact", [
    (114688, 320, False),
    (28672, 640, False),
    (77, 96, True),
], ids=["l0-c320", "l1-c640", "odd-rows-erf"])
def test_gpu_k5_kernel_matches_plain(m, c, exact):
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(7)
    x = _rand(g, dev, m, c).to(BF)
    d = 4 * c
    w = _rand(g, dev, 2 * d, c, scale=c ** -0.5).to(BF)
    bias = _rand(g, dev, 2 * d, scale=0.1).to(BF)
    got = _launches(tff.KERNEL, lambda: tff.geglu_kernel(x, w, bias, not exact))
    want = tff._torch_geglu(x, w, bias, not exact)
    _check(got, want, atol=2e-2, rtol=2e-2, rel_norm=1e-2 if c == 640 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k3-full", "k4", "k5"])
def test_gpu_kernels_compute_the_gelu_form_asked_for(kernel):
    """The two gelu forms differ by less than the tolerances above; on inputs
    that expose the gap (``chip_smoke.gelu_form_ff``) each kernel's output
    must follow ``approximate`` (``chip_smoke.gelu_form_check``)."""
    import chip_smoke

    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(9)
    rand = lambda *s, scale=1.0: _rand(g, dev, *s, scale=scale)  # noqa: E731
    form = chip_smoke.gelu_form_ff(rand, 320, 1280, 320)
    if kernel == "k3-full":  # (kernel, plain, arguments before and after approximate)
        fns = tft.temporal_block_full, tft._torch_temporal_block
        ins = (rand(2, 14, 64, 320, scale=1e-2).to(BF), rand(2, 64, 320, scale=2e-3).to(BF),
               torch.ones(320, device=dev, dtype=BF), torch.zeros(320, device=dev, dtype=BF),
               *(rand(320, 320, scale=2e-3).to(BF) for _ in range(4)),
               rand(320, scale=2e-3).to(BF), 5, 1e-5, form,
               chip_smoke.gelu_form_ff(rand, 320, 1280, 320))
        tail = ()
    elif kernel == "k4":
        fns = tfb.ln_ff_kernel, tfb._torch_ln_ff_residual
        ins, tail = (rand(777, 320, scale=1e-2).to(BF), *form, 1e-5), (True,)
    else:
        fns = tff.geglu_kernel, tff._torch_geglu
        ins, tail = (rand(777, 320).to(BF), form[2], form[3]), ()
    chip_smoke.gelu_form_check(kernel, lambda a, k: fns[0 if k else 1](*ins, a, *tail))


@pytest.mark.gpu
def test_gpu_new_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(8)
    x, w = _rand(g, dev, 8, 64), _ff(g, dev, 64, 256, 64)
    with pytest.raises(TypeError):  # fp32 activations
        tfb.ln_ff_kernel(x, *w, 1e-5, True, True)
    with pytest.raises(ValueError):  # C = 96 is not a multiple of 64
        tfb.ln_ff_kernel(_rand(g, dev, 8, 96).to(BF), *_ff(g, dev, 96, 384, 96), 1e-5, True,
                         True)
    with pytest.raises(ValueError):  # C = C_out = 512: above the 64 x 320 accumulator
        tfb.ln_ff_kernel(_rand(g, dev, 8, 512).to(BF), *_ff(g, dev, 512, 2048, 512), 1e-5,
                         True, True)
    wk, bk = _rand(g, dev, 256, 64).to(BF), _rand(g, dev, 256).to(BF)
    with pytest.raises(TypeError):
        tff.geglu_kernel(x, wk, bk, True)
    with pytest.raises(ValueError):  # D = 96 is not a multiple of 64
        tff.geglu_kernel(x.to(BF), wk[:192], bk[:192], True)
    x4 = _rand(g, dev, 1, 4, 8, 64)
    attn = (w[0], w[1], *(_rand(g, dev, 64, 64).to(BF) for _ in range(4)), w[1], 1, 1e-5)
    with pytest.raises(TypeError):
        tft.temporal_block_full(x4, None, *attn, w, w, True)
    with pytest.raises(ValueError):  # c = 384 is above the kernel's widths
        x384 = torch.zeros(1, 4, 8, 384, device=dev, dtype=BF)
        tft.temporal_block_full(x384, None, *attn, w, w, True)


@pytest.mark.gpu
@pytest.mark.parametrize("fused,exact", [(False, False), (True, False), (True, True)],
                         ids=["default", "fused-block", "fused-block-exact-gelu"])
def test_gpu_basic_block_launches_k4_under_fused_block(monkeypatch, fused, exact):
    """K4 launches under ``CTRL_ADAPTER_FUSED_BLOCK=1`` unless
    ``CTRL_ADAPTER_EXACT_GELU=1`` asks for erf-gelu, which the JAX rule keeps
    off its kernel."""
    dev = _dev()
    for name, on in (("CTRL_ADAPTER_FUSED_BLOCK", fused), ("CTRL_ADAPTER_EXACT_GELU", exact)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    with torch.no_grad():
        block = BasicTransformerBlock(320, 5, 64, 64, device=dev, dtype=BF)
        x = torch.randn(1, 4096, 320, device=dev).to(BF)
        before = tfb.KERNEL.launches
        out = block(x, torch.randn(1, 7, 64, device=dev).to(BF))
        torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert tfb.KERNEL.launches == before + int(fused and not exact)


@pytest.mark.gpu
def test_gpu_feed_forward_launches_k5_under_fused_ff(monkeypatch):
    dev = _dev()
    monkeypatch.setenv("CTRL_ADAPTER_FUSED_FF", "1")
    with torch.no_grad():
        cpu, card = _bf16_pair(FeedForward(320, 320), dev)
        x = torch.randn(2, 128, 320).to(BF).float()
        got = _launches(tff.KERNEL, lambda: card(x.to(dev, BF))).float().cpu()
        want = cpu(x)
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()


@pytest.mark.gpu
def test_gpu_level0_temporal_block_launches_k3_full_only():
    """A UNet level-0-shaped block (c = 320, 5 heads, 14 frames) takes "full":
    one launch of K3 full and none of K3 hybrid."""
    dev = _dev()
    b, f, s = 1, 14, 64
    assert tft.dispatch_mode(b, f, s, 320, 320, 1280, BF) == "full"
    with torch.no_grad():
        cpu, card = _bf16_pair(TemporalBasicTransformerBlock(320, 320, 5, 64, 1024), dev)
        x = torch.randn(b * f, s, 320).to(BF).float()
        ctx = torch.randn(b * s, 1, 1024).to(BF).float()
        hybrid = tft.KERNEL.launches
        got = _launches(tft.KERNEL_FULL,
                        lambda: card(x.to(dev, BF), f, ctx.to(dev, BF))).float().cpu()
        want = cpu(x, f, ctx)
    assert tft.KERNEL.launches == hybrid
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()
