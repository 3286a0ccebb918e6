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
outputs (std ~0.1 at these inputs) sit far below its atol. The fp32
kernels (K1 fp32, K2 fp32 and its backward) compute to fp32's accuracy as
their plain versions do (K2's products in 3xTF32, ~4e-7 of the norm), in
another summation order: each output within 1e-5 of the plain version's norm
(TF32 off for the plain version's products), and the elementwise check at
1e-4 absolute and relative. Module
wiring tests compare a bf16 module on the
card with the same bf16-rounded weights in fp32 on the CPU, within 5e-2 of the
output's largest magnitude: a wrong head split or transpose gives errors of
the order of the output itself.
"""

import copy
import threading

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


# the SD-v1.5 ControlNet's self-attentions at a 64^2 latent: down.0 (T = 4096,
# 8 heads of 40) and down.1 (T = 1024, 8 heads of 80), at the SVD clip's CFG
# batch (28), I2VGen-XL's (32) and SVD training's (14)
NARROW_SHAPES = [(28, 8, 4096, 40), (32, 8, 4096, 40), (14, 8, 4096, 40), (28, 8, 1024, 80),
                 (32, 8, 1024, 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t,h", NARROW_SHAPES,
                         ids=["svd-down0", "i2vgenxl-down0", "svd-train-down0", "svd-down1",
                              "i2vgenxl-down1"])
def test_gpu_k2_narrow_matches_plain(b, n, t, h):
    """K2 at head dims 40 and 80 on head-split views of (B, T, N*H)
    projections (head strides of 80 and 160 bytes), against the plain
    version with K2's tolerance: the columns TMA fills past H with zeros
    neither take the next head's values nor reach the output. One launch of
    the narrow entry, none of K2's own."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (_rand(g, dev, b, t, n * h).to(BF).view(b, t, n, h).transpose(1, 2)
               for _ in range(3))
    k2 = tfa.KERNEL.launches
    got = _launches(tfa.KERNEL_NARROW, lambda: tfa.attention_narrow(q, k, v))
    assert tfa.KERNEL.launches == k2
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    _check(got, tfa._torch_attention(q, k, v), atol=1e-2, rtol=2e-2, rel_norm=1e-2)


@pytest.mark.gpu
def test_gpu_dot_product_attention_takes_k2_narrow_where_the_rule_admits_it():
    """``dot_product_attention`` on (B, T, N, H) views: bf16 self-attention of
    T >= 1024 at H = 40 or 80 without grad launches K2 narrow once and
    matches the plain path; fp32, T = 256, a cross-attention of 77 keys,
    inputs that require grad and H = 64 stay plain."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(6)

    def proj(t, h, dtype=BF, n=8, b=2):
        return _rand(g, dev, b, t, n * h).to(dtype).view(b, t, n, h)

    def plain(q, k, v):
        return tfa._torch_attention(*(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2)

    for t, h in ((4096, 40), (1024, 80)):
        q, k, v = proj(t, h), proj(t, h), proj(t, h)
        got = _launches(tfa.KERNEL_NARROW, lambda: tfa.dot_product_attention(q, k, v))
        assert got.is_contiguous()
        _check(got, plain(q, k, v), atol=1e-2, rtol=2e-2, rel_norm=1e-2)
    grad = proj(1024, 40).requires_grad_()
    cases = {"fp32": [proj(1024, 40, torch.float32)] * 3, "t256": [proj(256, 40)] * 3,
             "cross": [proj(1024, 40), proj(77, 40), proj(77, 40)],
             "grad": [grad, proj(1024, 40), proj(1024, 40)], "h64": [proj(1024, 64)] * 3}
    for name, (q, k, v) in cases.items():
        before = tfa.KERNEL_NARROW.launches, tfa.KERNEL.launches
        got = tfa.dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        assert (tfa.KERNEL_NARROW.launches, tfa.KERNEL.launches) == before, name
        _check(got.detach(), plain(q.detach(), k, v), atol=1e-2, rtol=2e-2, rel_norm=1e-2)


@pytest.mark.gpu
def test_gpu_controlnet_at_a_64_latent_takes_k2_narrow_four_times(monkeypatch):
    """One forward of the SD-v1.5 ControlNet at a 64^2 latent, as both
    generation cells run it: its two down.0 and two down.1 self-attentions
    are 4 launches of K2 narrow under ``op.attention.narrow``; no
    self-attention of T >= 1024 is left to the plain path, and K2's own
    kernel, which none of the ControlNet's heads fit, does not launch."""
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
    from ctrl_adapter_tpu_torch.utils import profiling

    dev = _dev()
    torch.manual_seed(0)
    net = ControlNetModel(ControlNetConfig(), device=dev, dtype=BF)
    plain_lengths, orig = [], tfa._torch_attention

    def spy(q, k, v, *args):
        plain_lengths.append((q.shape[2], k.shape[2]))
        return orig(q, k, v, *args)

    monkeypatch.setattr(tfa, "_torch_attention", spy)
    g = torch.Generator(device=dev).manual_seed(7)
    b = 2
    sample = _rand(g, dev, b, 4, 64, 64).to(BF)
    text = _rand(g, dev, b, 77, 768).to(BF)
    cond = torch.rand(b, 3, 512, 512, generator=g, device=dev).to(BF)
    narrow, k2 = tfa.KERNEL_NARROW.launches, tfa.KERNEL.launches
    with torch.no_grad(), profiling.recording() as rec:
        down, mid = net(sample, 500, text, cond)
    torch.cuda.synchronize()
    assert tfa.KERNEL_NARROW.launches - narrow == 4
    assert tfa.KERNEL.launches == k2
    assert [s.name for s in rec.spans].count("op.attention.narrow") == 4
    assert not [tk for tq, tk in plain_lengths if tq == tk and tq >= 1024], plain_lengths
    assert plain_lengths  # the cross-attentions and down.2's T = 256 stay plain
    assert all(torch.isfinite(x.float()).all() for x in (*down, mid))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t,h", [(2, 3, 1024, 64), (1, 2, 4096, 64), (2, 2, 1024, 128),
                                     (2, 3, 128, 64), (1, 2, 128, 128), (3, 7, 2048, 64),
                                     (16, 5, 4096, 64), (1, 5, 16384, 64), (1, 1, 32768, 64)])
def test_gpu_k2_backward_matches_plain(b, n, t, h):
    """K2's forward with its log-sum-exp and its backward (one call, one count)
    through ``FlashAttention`` on head-split views, against the plain backward
    on the kernel's own output and lse. P and dS are rounded to bf16 before
    their products in the kernel, not in the plain version: ~0.3 % in norm.
    T = 128 is one key block and one query tile; (3, 7, 2048, 64) launches 336
    CTAs, two waves of 132 SMs and a part of a third. (16, 5, 4096, 64) is the
    I2VGen-XL training step's UNet and adapter A-block attention at 16
    frames; (1, 5, 16384, 64) the SDXL training step's adapter A blocks after
    their x2 upsample: 128 key blocks add into each query row's fp32 dQ
    scratch, in turn. (1, 1, 32768, 64) has more key blocks (256) than the
    card has SMs: two cycles of 128 take their dQ turns one after the other
    (``bwd_group``)."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (_rand(g, dev, b, t, n * h).to(BF).view(b, t, n, h).transpose(1, 2)
                   for _ in range(4))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fwd, bwd = tfa.KERNEL.launches, tfa.KERNEL_BWD.launches
    out = tfa.attention_bnth(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (tfa.KERNEL.launches - fwd, tfa.KERNEL_BWD.launches - bwd) == (1, 1)
    o, lse = tfa._forward(q, k, v, True)
    plain_out, plain_lse = tfa._torch_attention(q, k, v, True)
    _check(lse, plain_lse, atol=1e-3, rtol=1e-4)
    assert torch.equal(out.detach(), o)
    want = tfa._torch_attention_bwd(q, k, v, o, do, lse)
    for x, y in zip(got, want):
        _check(x, y, atol=5e-2 * y.abs().max().item(), rtol=5e-2, rel_norm=2e-2)


def _k2_bwd_inputs(dev, b, n, t, h, seed):
    """Head-split views q, k, v, do of (B, T, N*H) tensors, K2's output and lse."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (_rand(g, dev, b, t, n * h).to(BF).view(b, t, n, h).transpose(1, 2)
                   for _ in range(4))
    o, lse = tfa._forward(q, k, v, True)
    return q, k, v, o, do, lse


@pytest.mark.gpu
def test_gpu_k2_backward_takes_a_do_that_tma_cannot_map():
    """A dO whose strides are not multiples of 16 bytes (a slice of a wider
    tensor) is made contiguous before the launch, and gives the plain
    version's gradients."""
    dev = _dev()
    b, n, t, h = 2, 3, 1024, 64
    q, k, v, o, _, lse = _k2_bwd_inputs(dev, b, n, t, h, 7)
    g = torch.Generator(device=dev).manual_seed(8)
    do = _rand(g, dev, b, t, n, h + 4).to(BF)[..., :h].transpose(1, 2)
    assert tfa.tma_view_error(do.shape, do.stride(), do.data_ptr()) is not None
    got = _launches(tfa.KERNEL_BWD, lambda: tfa.attention_bnth_bwd(q, k, v, o, do, lse))
    want = tfa._torch_attention_bwd(q, k, v, o, do, lse)
    for x, y in zip(got, want):
        _check(x, y, atol=5e-2 * y.abs().max().item(), rtol=5e-2, rel_norm=2e-2)


@pytest.mark.gpu
def test_gpu_k2_launches_from_a_thread_without_a_current_context():
    """Autograd runs a backward on a worker thread of its own. Where every
    tensor the backward allocates comes from PyTorch's caching allocator, that
    thread has made no CUDA runtime call, so no context is current on it when
    a kernel encodes its TMA maps (a driver call). K2's forward and backward
    from a new thread, once the same calls on this one have filled the cache,
    give this thread's results."""
    dev = _dev()
    q, k, v, o, do, lse = _k2_bwd_inputs(dev, 2, 3, 1024, 64, 10)
    want_o, want_lse = tfa._forward(q, k, v, True)
    want = tfa.attention_bnth_bwd(q, k, v, o, do, lse)
    # once more, outputs dropped: their blocks wait in the cache for the thread
    tfa._forward(q, k, v, True)
    tfa.attention_bnth_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["fwd"] = tfa._forward(q, k, v, True)
            got["bwd"] = tfa.attention_bnth_bwd(q, k, v, o, do, lse)
        except RuntimeError as err:
            got["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    assert torch.equal(got["fwd"][0], want_o) and torch.equal(got["fwd"][1], want_lse)
    assert all(torch.equal(x, y) for x, y in zip(got["bwd"], want))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [64, 128])
def test_gpu_k2_backward_dk_dv_are_reproducible(h):
    """Two calls on the same inputs give dQ, dK and dV equal to the bit: each
    CTA owns its keys, and each query tile's dQ partials are added across the
    key blocks in a turn order fixed by the indices."""
    dev = _dev()
    q, k, v, o, do, lse = _k2_bwd_inputs(dev, 2, 3, 2048, h, 9)
    first = tfa.attention_bnth_bwd(q, k, v, o, do, lse)
    second = tfa.attention_bnth_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    for name, x, y in zip(("dQ", "dK", "dV"), first, second):
        assert torch.equal(x, y), f"{name} differs between two calls"


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t,h", [(16, 5, 4096, 64), (1, 20, 1024, 64)],
                         ids=["several-waves", "under-a-wave"])
def test_gpu_k2_backward_dq_does_not_depend_on_the_grid(b, n, t, h):
    """Each (b, n) pair's gradients from a (B, N) call equal, to the bit, the
    same pair's called alone: the dQ turns depend on the key block and the
    query tile only, not on the other pairs, the ticket a CTA drew or when it
    ran. (16, 5, 4096, 64) is 2,560 CTAs, about 19 waves of 132; (1, 20,
    1024, 64) 160."""
    dev = _dev()
    q, k, v, o, do, lse = _k2_bwd_inputs(dev, b, n, t, h, 11)
    whole = tfa.attention_bnth_bwd(q, k, v, o, do, lse)
    for bi in range(b):
        for ni in range(n):
            one = lambda x: x[bi:bi + 1, ni:ni + 1]  # noqa: E731
            alone = tfa.attention_bnth_bwd(*(one(x) for x in (q, k, v, o, do, lse)))
            for name, x, y in zip(("dQ", "dK", "dV"), whole, alone):
                assert torch.equal(one(x), y), f"pair ({bi}, {ni}): {name} differs"



def _rel(got, want):
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()


@pytest.fixture
def fp32_matmuls():
    """The plain versions' fp32 products in full fp32 (no TF32)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("shape,silu,branch", [
    ((14, 320, 64, 64), True, "cluster"),
    # the bf16 plan's one_cta and several_groups shapes: fp32 takes the ring
    ((28, 320, 32, 32), True, "ring"),
    ((28, 1280, 8, 8), False, "ring"),
    ((2, 640, 16, 16), True, "cluster"),
    ((2, 64, 3, 5, 7), False, "two_pass"),
    ((2, 64, 1, 2, 6), True, "cluster"),
    ((1, 32, 1, 1024, 1024), True, "two_pass"),
    # the fp32 training rows of SVD (b f = 14) and I2VGen-XL (16)
    ((14, 320, 32, 32), True, "ring"),
    ((14, 640, 32, 32), False, "ring"),
    ((14, 640, 16, 16), True, "ring"),
    ((14, 1280, 16, 16), False, "ring"),
    ((14, 1280, 8, 8), True, "ring"),
    ((16, 640, 32, 32), True, "ring"),
    ((16, 1280, 8, 8), False, "ring"),
    # 1,792 groups of 20 KB: CTAs walk three or four groups (the slot's pieces
    # refilled), as the groups do not divide evenly among the CTAs
    ((56, 640, 16, 16), True, "ring"),
], ids=["train-b14", "one-cta", "several-groups", "cluster4", "scalar-S105", "S12",
        "two-pass-4MB-group", "ring-svd-320x32", "ring-svd-640x32", "ring-svd-640x16",
        "ring-svd-1280x16", "ring-svd-1280x8", "ring-i2v-640x32", "ring-i2v-1280x8",
        "ring-refills-uneven"])
def test_gpu_k1_fp32_kernel_matches_plain(shape, silu, branch):
    """K1 on fp32 input (4 elements a vector) in every branch of its plan, one
    launch per call (on K1 fp32's counter), within 1e-5 of the plain
    version's norm; the same bits from call to call. The ring at the fp32
    training rows, and where CTAs refill their slots and walk unequal
    numbers of groups."""
    dev = _dev()
    p = tgn.plan(shape, 32, itemsize=4,
                 sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    assert p.branch == branch
    if shape == (56, 640, 16, 16):
        groups = shape[0] * 32
        assert p.groups_per_cta >= 3 and groups % p.grid
    g = torch.Generator(device=dev).manual_seed(20)
    x = _rand(g, dev, *shape)
    c = shape[1]
    w = 1.0 + _rand(g, dev, c, scale=0.1)
    b = _rand(g, dev, c, scale=0.1)
    bf16 = tgn.KERNEL.launches
    got = _launches(tgn.KERNEL_FP32, lambda: tgn.group_norm_silu(x, w, b, 32, 1e-6, silu))
    assert tgn.KERNEL.launches == bf16  # counted apart from bf16's launches
    want = tgn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu)
    assert got.dtype == torch.float32
    _check(got, want, atol=1e-4, rtol=1e-4, rel_norm=1e-5)
    assert torch.equal(got, tgn.group_norm_silu(x, w, b, 32, 1e-6, silu))


@pytest.mark.gpu
def test_gpu_k1_ring_refuses_a_plan_it_does_not_derive():
    """The C side derives the ring's groups a CTA walks, elements, shared
    memory and limits from its threads, slots and CTAs, and refuses a plan
    that differs (no launch, no count), as it does for the other branches;
    the ring takes fp32 only."""
    import dataclasses

    dev = _dev()
    shape = (14, 640, 16, 16)
    g = torch.Generator(device=dev).manual_seed(21)
    x = _rand(g, dev, *shape)
    w = 1.0 + _rand(g, dev, shape[1], scale=0.1)
    b = _rand(g, dev, shape[1], scale=0.1)
    p = tgn.plan(shape, 32, itemsize=4,
                 sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    assert p.branch == "ring"
    _launches(tgn.KERNEL_FP32, lambda: tgn.launch(x, w, b, 32, 1e-6, True, p))
    groups = shape[0] * 32
    wrong = [dict(smem_bytes=p.smem_bytes + 128), dict(groups_per_cta=p.groups_per_cta + 1),
             dict(elems=p.elems - 4), dict(threads=512), dict(threads=64),
             dict(grid=groups + 1, groups_per_cta=1), dict(cluster=2), dict(vec=False)]
    for change in wrong:
        before = tgn.KERNEL_FP32.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            tgn.launch(x, w, b, 32, 1e-6, True, dataclasses.replace(p, **change))
        assert tgn.KERNEL_FP32.launches == before, change
    xb, wb, bb = x.to(BF), w.to(BF), b.to(BF)
    before = tgn.KERNEL.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tgn.launch(xb, wb, bb, 32, 1e-6, True, p)
    assert tgn.KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t,h", [
    (2, 3, 1024, 64), (2, 3, 4096, 64), (2, 3, 1024, 128), (2, 3, 4096, 128),
    # SDXL's fp32 training shapes: the adapter's A blocks at 1024^2, 2048^2 and 4096^2 tokens
    (1, 5, 16384, 64), (1, 10, 4096, 64), (1, 20, 1024, 64),
], ids=["t1024-h64", "t4096-h64", "t1024-h128", "t4096-h128", "sdxl-t16384", "sdxl-t4096",
        "sdxl-t1024"])
@pytest.mark.parametrize("layout", ["bnth", "btnh-view"])
def test_gpu_k2_fp32_kernel_matches_plain(fp32_matmuls, b, n, t, h, layout):
    """K2 fp32 on contiguous (B, N, T, H) tensors and on head-split views,
    with and without the rows' log-sum-exp, against the plain version."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(21)
    if layout == "bnth":
        q, k, v = (_rand(g, dev, b, n, t, h) for _ in range(3))
    else:
        q, k, v = (_rand(g, dev, b, t, n * h).view(b, t, n, h).transpose(1, 2)
                   for _ in range(3))
    got = _launches(tfa.KERNEL_FP32, lambda: tfa.attention_bnth(q, k, v))
    want, want_lse = tfa._torch_attention(q, k, v, True)
    assert got.dtype == torch.float32
    _check(got, want, atol=1e-4, rtol=1e-4, rel_norm=1e-5)
    out, lse = tfa._forward(q, k, v, True)
    assert torch.equal(out, got)
    _check(lse, want_lse, atol=1e-4, rtol=1e-5, rel_norm=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t,h", [(2, 3, 1024, 64), (1, 5, 4096, 64), (2, 2, 1024, 128),
                                     (2, 3, 64, 64), (1, 2, 64, 128), (3, 7, 2048, 64),
                                     (1, 5, 16384, 64), (1, 10, 4096, 64), (1, 20, 1024, 64)])
def test_gpu_k2_fp32_backward_matches_plain_and_is_reproducible(fp32_matmuls, b, n, t, h):
    """K2 fp32's forward with its log-sum-exp and K2 bwd fp32 (one call, one
    count each) through ``FlashAttention`` on head-split views, against the
    plain backward on the kernel's own output and lse, each gradient within
    1e-5 of its norm; a second backward call gives the same bits (dQ, dK and
    dV are each summed in a fixed order). T = 64 is one block (at H = 64 half
    a CTA's rows: its second consumer stores nothing); the last three are
    SDXL's fp32 training shapes."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(22)
    q, k, v, do = (_rand(g, dev, b, t, n * h).view(b, t, n, h).transpose(1, 2)
                   for _ in range(4))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fwd, bwd = tfa.KERNEL_FP32.launches, tfa.KERNEL_FP32_BWD.launches
    bf16 = tfa.KERNEL.launches, tfa.KERNEL_BWD.launches
    out = tfa.attention_bnth(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (tfa.KERNEL_FP32.launches - fwd, tfa.KERNEL_FP32_BWD.launches - bwd) == (1, 1)
    assert (tfa.KERNEL.launches, tfa.KERNEL_BWD.launches) == bf16
    o, lse = tfa._forward(q, k, v, True)
    want = tfa._torch_attention_bwd(q, k, v, o, do, lse)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        _check(x, y, atol=1e-4 * y.abs().max().item(), rtol=1e-4, rel_norm=1e-5)
    again = tfa.attention_bnth_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(tfa.attention_bnth_bwd(q, k, v, o, do, lse),
                                                 again))

@pytest.mark.gpu
@pytest.mark.parametrize("name", ["k1", "k3", "k3-full", "k4", "k5"])
def test_gpu_kernel_gradients_are_the_plain_versions(name):
    """Under grad each kernel runs forward (one launch) and its backward is
    autograd of the plain version on the saved inputs (``mirror_vjp``): the
    gradients equal those of the plain version run under autograd, to the
    kernels' forward tolerance (the two backward passes see the same inputs)."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(6)
    r = lambda *s, scale=1.0: _rand(g, dev, *s, scale=scale).to(BF)  # noqa: E731
    if name == "k1":
        kernel, wrapper, plain = tgn.KERNEL, tgn.group_norm_silu, tgn._torch_group_norm_silu
        args = (r(2, 320, 14, 8, 8), 1.0 + r(320, scale=0.1), r(320, scale=0.1), 32, 1e-6, True)
    elif name in ("k3", "k3-full"):
        c, ia = 128, 128
        args = (r(2, 14, 16, c), r(2, 16, c, scale=0.5), 1.0 + r(c, scale=0.1),
                r(c, scale=0.1), *(r(ia, c, scale=c ** -0.5) for _ in range(3)),
                r(c, ia, scale=ia ** -0.5), r(c, scale=0.1), 2, 1e-5)
        if name == "k3":
            kernel, wrapper, plain = tft.KERNEL, tft.temporal_block, tft._torch_temporal_block
        else:
            args += (_ff(g, dev, c, 4 * c, c), _ff(g, dev, c, 4 * c, c), True)
            kernel = tft.KERNEL_FULL
            wrapper, plain = tft.temporal_block_full, tft._torch_temporal_block
    elif name == "k4":
        kernel, wrapper, plain = tfb.KERNEL, tfb.ln_ff_kernel, tfb._torch_ln_ff_residual
        args = (r(4096, 320), *_ff(g, dev, 320, 1280, 320), 1e-5, True, True)
    else:
        kernel, wrapper, plain = tff.KERNEL, tff.geglu_kernel, tff._torch_geglu
        args = (r(4096, 320), r(2560, 320, scale=320 ** -0.5), r(2560, scale=0.1), True)

    def run(fn):
        leaves = [a.detach().requires_grad_() if torch.is_tensor(a) else
                  tuple(t.detach().requires_grad_() for t in a) if isinstance(a, tuple) else a
                  for a in args]
        out = fn(*leaves)
        flat = [t for a in leaves for t in (a if isinstance(a, tuple) else (a,))
                if torch.is_tensor(t)]
        grads = torch.autograd.grad(out, flat, torch.ones_like(out) * 0.01)
        return out, grads

    out, got = _launches(kernel, lambda: run(wrapper))
    want_out, want = run(plain)
    _check(out, want_out, atol=1e-1, rtol=2e-2)
    for x, y in zip(got, want):
        _check(x, y, atol=5e-2 * y.abs().max().item() + 1e-3, rtol=5e-2, rel_norm=5e-2)


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
    _k3_hybrid_check(dev, f, s, c, heads, cross)


@pytest.mark.gpu
@pytest.mark.parametrize("f,s,heads", [
    (16, 4096, 5), (16, 1024, 5), (16, 1024, 10), (16, 256, 10), (16, 256, 20), (16, 64, 20),
    (4, 4096, 5), (4, 1024, 10), (2, 256, 20),
], ids=["f16-A-4096", "f16-B-1024-ia320", "f16-B-1024-ia640", "f16-C-256-ia640",
        "f16-C-256-ia1280", "f16-D-64", "sparse-f4-4096", "sparse-f4-1024", "sparse-f2-256"])
def test_gpu_k3_at_the_i2vgenxl_adapter_shapes(f, s, heads):
    """The I2VGen-XL adapter's temporal blocks (b = 2 after CFG, c = 512, ia =
    the block's channels) at its 16 frames, where the 16-row frame tiles hold
    no padded row, and at the key-frame counts of a sparse-frame run; the
    checks of ``test_gpu_k3_kernel_matches_plain``."""
    dev = _dev()
    assert tft.dispatch_mode(2, f, s, 512, heads * 64, 2048, BF) == "hybrid"
    _k3_hybrid_check(dev, f, s, 512, heads, True)


def _k3_hybrid_check(dev, f, s, c, heads, cross):
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
    for dtype in (torch.float16, torch.float64):  # K1 takes bf16 and fp32 only
        x_ = torch.zeros(2, 64, 4, 4, device=dev, dtype=dtype)
        w_ = torch.ones(64, device=dev, dtype=dtype)
        with pytest.raises(TypeError):
            tgn.group_norm_silu(x_, w_, w_, 32)
    x32 = torch.zeros(2, 64, 4, 4, device=dev)
    with pytest.raises(ValueError):  # weight and bias in x's type
        tgn.group_norm_silu(x32, w_.to(BF), w_.to(BF), 32)
    xt = torch.zeros(2, 64, 4, 4, device=dev, dtype=BF).transpose(2, 3)
    w = torch.ones(64, device=dev, dtype=BF)
    with pytest.raises(ValueError):
        tgn.group_norm_silu(xt, w, w, 32)
    q16 = torch.zeros(1, 2, 1024, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):  # K2 takes bf16 and fp32 only
        tfa.attention_bnth(q16, q16, q16)
    q32 = torch.zeros(1, 2, 1024, 64, device=dev)
    with pytest.raises(TypeError):  # all three of one type
        tfa.attention_bnth(q32, q32.to(BF), q32)
    q32 = torch.zeros(1, 2, 1056, 64, device=dev)  # T % 64 != 0: off K2 fp32's tiling
    with pytest.raises(ValueError):
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
@pytest.mark.parametrize("b,n,t", [(32, 5, 4096), (32, 10, 1024)])
def test_gpu_k2_at_the_i2vgenxl_shapes(b, n, t):
    """The I2VGen-XL path's spatial self-attentions: 2 x 16 frames after CFG,
    at 64x64 (5 heads) and 32x32 (10 heads), as head-split views."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (_rand(g, dev, b, t, n * 64).to(BF).view(b, t, n, 64).transpose(1, 2)
               for _ in range(3))
    got = _launches(tfa.KERNEL, lambda: tfa.attention_bnth(q, k, v))
    _check(got, tfa._torch_attention(q, k, v), atol=1e-2, rtol=2e-2, rel_norm=1e-2)


def _thin_i2vgenxl(dev, experts=1, router_type=None):
    """Thin I2VGen-XL towers in bf16 (head dim 64, so at 4 frames of 256x256
    the UNet's level-0 attention is flash-eligible at T = 1024), weights at
    scale 0.05 from a seeded generator, and the generate() arguments of a
    2-step run to the latents with ``experts`` ControlNets."""
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
    from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
    from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline

    kw = dict(device=dev, dtype=BF)
    nets = [ControlNetModel(ControlNetConfig(block_out_channels=(64, 64, 128, 128),
                                             num_attention_heads=(2, 2, 2, 2),
                                             cross_attention_dim=32,
                                             conditioning_embedding_out_channels=(16, 16, 32, 32)),
                            **kw) for _ in range(experts)]
    router = (None if router_type is None else
              ControlNetRouter(experts, router_type, embedding_dim=256 + 64, device=dev))
    towers = [I2VGenXLUNet(I2VGenXLUNetConfig(block_out_channels=(64, 64, 128, 128),
                                              cross_attention_dim=64), **kw),
              nets[0] if experts == 1 else MultiControlNetModel(nets),
              ControlNetAdapter(num_blocks=1, cross_attention_dim=64,
                                adapter_locations=("A", "B", "C", "D", "M"),
                                add_temporal_resnet=True, add_temporal_transformer=True,
                                custom_down_block_channels=(64,) * 7 + (128,) * 5,
                                custom_mid_block_channels=128, **kw),
              AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 32, 32)), **kw)]
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for module in towers[:1] + nets + towers[2:]:
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
    pipe = I2VGenXLControlNetAdapterPipeline(*towers, router=router)
    r = lambda *shape: (torch.randn(*shape, generator=g, device=dev) * 0.1).to(BF)  # noqa: E731
    images = torch.rand(experts, 4, 256, 256, 3, generator=g, device=dev).to(BF)
    inputs = dict(prompt_embeds=r(2, 7, 64), controlnet_prompt_embeds=r(2, 7, 32),
                  image_embeddings=r(1, 1, 64), first_frame_latent=r(1, 32, 32, 4),
                  control_images=images[0] if experts == 1 else images,
                  latents=torch.randn(1, 4, 32, 32, 4, generator=g, device=dev),
                  height=256, width=256, num_frames=4, num_inference_steps=2,
                  guidance_scale=9.0, control_guidance_end=1.0, control_latent_size=32,
                  output_type="latent")
    return pipe, inputs


@pytest.mark.gpu
def test_gpu_i2vgenxl_thin_denoise_matches_the_plain_path():
    """Two I2VGen-XL denoise steps of thin towers in bf16: the kernel path
    launches K1, K2 and K3 hybrid, and its first controlled step (the
    adapter's outputs and the CFG-combined noise prediction) is no farther
    from an fp32 run of the plain path than 2x the bf16 plain path, tensor by
    tensor, while a K1 without its SiLU, a K2 without a head and a K3 hybrid
    returning its input each are: ``chip_smoke.py``'s check at full width."""
    import chip_smoke

    pipe, inputs = _thin_i2vgenxl(_dev())
    kernels = (tgn.KERNEL, tfa.KERNEL, tft.KERNEL)
    before = [k.launches for k in kernels]
    pipe.generate(**inputs)
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in zip(kernels, before)), [k.launches for k in kernels]
    chip_smoke.step_reference_check(pipe, "thin i2vgenxl", inputs)


@pytest.mark.gpu
@pytest.mark.parametrize("router_type", ["timestep_embedding_weights", "simple_weights"])
def test_gpu_i2vgenxl_denoise_loop_does_not_wait_for_the_card(router_type):
    """The denoise loop of a two-expert I2VGen-XL run with a router makes no
    call that waits for the card (``torch.cuda.set_sync_debug_mode("error")``
    raises on a device-to-host copy, a blocking host-to-device copy, a
    stream synchronisation): a conditional router builds its input from the
    timestep and the CLIP embedding on the card, each step."""
    pipe, inputs = _thin_i2vgenxl(_dev(), experts=2, router_type=router_type)
    pipe.generate(**inputs)  # builds the kernels and warms the allocator
    sample = pipe._sample

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return sample(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    pipe._sample = guarded
    latents = pipe.generate(**inputs)
    assert torch.isfinite(latents).all()


@pytest.mark.gpu
def test_gpu_i2vgenxl_training_step_does_not_wait_for_the_card():
    """The I2VGen-XL training step's loss and backward, with two experts and
    a trainable router, make no call that waits for the card
    (``set_sync_debug_mode("error")``): DDIM indexes its alphas on the
    timesteps' device, the router's mask and weights stay there. Only the
    optimizer's clip reads the gradient norm on the host, outside the
    guard."""
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

    dev = _dev()
    pipe, inputs = _thin_i2vgenxl(dev, experts=2, router_type="simple_weights")
    cfg = TrainConfig(model_name="i2vgenxl", n_sample_frames=4, control_latent_size=32,
                      num_experts=2, train_router=True)
    trainer = CtrlAdapterTrainer(cfg, pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae,
                                 router=pipe.router, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    batch = {"frames": torch.rand(1, 4, 256, 256, 3, generator=g, device=dev) * 2 - 1,
             "controlnet_cond": inputs["control_images"].float(),
             "controlnet_text_emb": inputs["controlnet_prompt_embeds"][1:],
             "prompt_embeds": inputs["prompt_embeds"][1:],
             "image_embeddings": inputs["image_embeddings"],
             "expert_mask": torch.tensor([1.0, 0.0], device=dev)}
    trainer.train_step(batch, generator=g)  # builds the kernels, moves DDIM's table
    draws = trainer.draw(g, 1, 4, 32, 32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, weights = trainer.loss_and_weights(batch, draws)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss) and (weights["down_block_weights"][:, 1] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t", [(2, 5, 16384), (2, 10, 4096), (2, 20, 1024)])
def test_gpu_k2_at_the_sdxl_shapes(b, n, t):
    """The SDXL path's self-attentions after CFG, as head-split views: the
    adapter's A blocks after the x2 upsample (T = 16384, 128 key tiles per
    query tile), the UNet's level 1 (T = 4096) and level 2 and mid (T = 1024)."""
    dev = _dev()
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_rand(g, dev, b, t, n * 64).to(BF).view(b, t, n, 64).transpose(1, 2)
               for _ in range(3))
    got = _launches(tfa.KERNEL, lambda: tfa.attention_bnth(q, k, v))
    _check(got, tfa._torch_attention(q, k, v), atol=1e-2, rtol=2e-2, rel_norm=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,silu", [((2, 320, 64, 64), True), ((2, 1280, 32, 32), False),
                                        ((2, 640, 16, 16), True)])
def test_gpu_k1_at_the_sdxl_shapes(shape, silu):
    """K1 at N = 2 (the SDXL adapter's CFG pair): 64 groups, each spread over
    a cluster of 4 CTAs so that the grid covers the card."""
    dev = _dev()
    assert tgn.plan(shape, 32).branch == "cluster"
    g = torch.Generator(device=dev).manual_seed(9)
    x = _rand(g, dev, *shape).to(BF)
    w = (1.0 + _rand(g, dev, shape[1], scale=0.1)).to(BF)
    b = _rand(g, dev, shape[1], scale=0.1).to(BF)
    got = _launches(tgn.KERNEL, lambda: tgn.group_norm_silu(x, w, b, 32, 1e-6, silu))
    _check(got, tgn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu), atol=1e-2, rtol=1e-2)


def _thin_sdxl(dev):
    """Thin SDXL towers in bf16 (head dim 64: at 512x512 the UNet's level-1
    attention is flash-eligible at T = 1024 and the adapter's A blocks run at
    T = 4096 after the x2 upsample), weights at scale 0.05 from a seeded
    generator, and the generate() arguments of a 2-step run to the latents
    with rescaled CFG."""
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_2d import UNet2DConditionModel, UNet2DConfig
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline

    kw = dict(device=dev, dtype=BF)
    unet = UNet2DConditionModel(UNet2DConfig(
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
        block_out_channels=(64, 128, 128), transformer_layers_per_block=(1, 1, 2),
        num_attention_heads=(1, 2, 2), cross_attention_dim=64, use_linear_projection=True,
        addition_embed_type="text_time", addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=32 + 48), **kw)
    towers = [unet,
              ControlNetModel(ControlNetConfig(block_out_channels=(64, 128, 128, 128),
                                               num_attention_heads=(2, 2, 2, 2),
                                               cross_attention_dim=32,
                                               conditioning_embedding_out_channels=(16, 16, 32,
                                                                                    32)), **kw),
              ControlNetAdapter(backbone_model_name="sdxl", num_blocks=1, cross_attention_dim=64,
                                adapter_locations=("A", "B", "C"),
                                custom_down_block_channels=(64,) * 4 + (128,) * 5, **kw),
              AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 32, 32)), **kw)]
    g = torch.Generator(device=dev).manual_seed(10)
    with torch.no_grad():
        for module in towers:
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
    pipe = SDXLControlNetAdapterPipeline(*towers)
    r = lambda *shape: (torch.randn(*shape, generator=g, device=dev) * 0.1).to(BF)  # noqa: E731
    inputs = dict(prompt_embeds=r(2, 7, 64), add_text_embeds=r(2, 32),
                  controlnet_prompt_embeds=r(2, 7, 32),
                  control_image=torch.rand(1, 256, 256, 3, generator=g, device=dev).to(BF),
                  latents=torch.randn(1, 64, 64, 4, generator=g, device=dev),
                  height=512, width=512, num_inference_steps=2, guidance_scale=7.5,
                  guidance_rescale=0.7, control_guidance_end=1.0, control_latent_size=32,
                  output_type="latent")
    return pipe, inputs


@pytest.mark.gpu
def test_gpu_sdxl_thin_denoise_matches_the_plain_path():
    """Two SDXL denoise steps of thin towers in bf16: the kernel path launches
    K1 and K2 (in the adapter and the UNet), and its first controlled step
    (the adapter's outputs, the UNet's output and the rescaled-CFG noise
    prediction) is no farther from an fp32 run of the plain path than 2x the
    bf16 plain path, while a K1 without its SiLU and a K2 without a head are:
    ``chip_smoke.py``'s check at full width."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.pipelines.common import classifier_free_guidance_rescaled

    pipe, inputs = _thin_sdxl(_dev())
    counts = {"adapter": [], "unet": []}  # K2's counter before and after each call
    for name in counts:
        module = getattr(pipe, name)
        module.register_forward_pre_hook(lambda *_, n=name: counts[n].append(
            tfa.KERNEL.launches))
        module.register_forward_hook(lambda *_, n=name: counts[n].append(tfa.KERNEL.launches))
    k1_before = tgn.KERNEL.launches
    pipe.generate(**inputs)
    torch.cuda.synchronize()
    assert tgn.KERNEL.launches > k1_before
    for name, (before, after, *_) in counts.items():
        assert after > before, f"K2 not launched in the {name}"
    chip_smoke.step_reference_check(
        pipe, "thin sdxl", inputs,
        combine=lambda out: classifier_free_guidance_rescaled(out, 7.5, 0.7),
        faults=("K1 without its SiLU", "K2 without head 0"))


@pytest.mark.gpu
def test_gpu_sdxl_denoise_loop_does_not_wait_for_the_card():
    """The SDXL denoise loop (ControlNet, adapter, UNet, rescaled CFG and the
    Euler step) makes no call that waits for the card, as the I2VGen-XL
    loop's test checks."""
    pipe, inputs = _thin_sdxl(_dev())
    pipe.generate(**inputs)  # builds the kernels and warms the allocator
    sample = pipe._sample

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return sample(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    pipe._sample = guarded
    latents = pipe.generate(**inputs)
    assert torch.isfinite(latents).all()


@pytest.mark.gpu
def test_gpu_modules_raise_where_the_kernels_refuse():
    """The modules dispatch on the JAX rule alone, so a card tensor the kernel
    does not take reaches the wrapper and raises instead of running plain:
    K2 takes bf16 and fp32, so an fp16 self-attention raises."""
    dev = _dev()
    with torch.no_grad():
        attn = Attention(128, 2, 64, device=dev, dtype=torch.float16)  # flash-eligible
        with pytest.raises(TypeError):
            attn(torch.zeros(1, 1024, 128, device=dev, dtype=torch.float16))
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
        (GroupNorm(32, 320, 1e-6, kernel="prefer"), tgn.KERNEL, (rand(2, 320, 14, 8, 8),),
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
