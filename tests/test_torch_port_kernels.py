"""Kernel modules of the PyTorch port against the JAX package, fp32 on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version, so these tests
hold the plain versions (the arithmetic the CUDA kernels implement) against the
JAX functions, which run their Pallas kernels in interpret mode where the JAX
package's own tests do:

- K1 ``group_norm_silu`` vs JAX ``group_norm_silu(..., use_pallas=True)``;
- K2 the flash path of ``Attention`` / ``attention_bnth`` vs
  ``jax.nn.dot_product_attention`` (what ``ops/flash_attention.py`` runs off
  the TPU), plus the single-key and tiny-sequence paths;
- K3 ``temporal_block`` (the "attn" part of the hybrid decomposition) vs JAX
  ``temporal_block(..., force_pallas=True)``.

K3 "full", K4 and K5 are held against JAX in ``test_torch_port_ff_kernels.py``;
here they join the check that a CPU tensor runs the plain version.

Tolerances: fp32 everywhere; 2e-5 absolute for single ops (summation order
only), 1e-4 where a projection or softmax chain sits in between.

The CUDA kernels themselves are tested on the card by ``test_torch_port_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.nn.attention import Attention as JAttention
from ctrl_adapter_tpu.ops import flash_attention as jfa
from ctrl_adapter_tpu.ops import fused_temporal as jft
from ctrl_adapter_tpu.ops.group_norm import group_norm_silu as j_group_norm_silu
from ctrl_adapter_tpu_torch.nn.attention import Attention
from ctrl_adapter_tpu_torch.ops import flash_attention as tfa
from ctrl_adapter_tpu_torch.ops import fused_block as tfb
from ctrl_adapter_tpu_torch.ops import fused_ff as tff
from ctrl_adapter_tpu_torch.ops import fused_temporal as tft
from ctrl_adapter_tpu_torch.ops import group_norm as tgn

from .torch_port_common import assert_close, nchw_to_nhwc, nhwc_to_nchw, port
from .utils import fake_init


# ---------------------------------------------------------------- K1 GroupNorm
@pytest.mark.parametrize("shape", [(2, 8, 8, 320), (2, 3, 4, 4, 64)],
                         ids=["nchw", "ncfhw"])
@pytest.mark.parametrize("silu", [False, True])
def test_k1_group_norm_matches_jax_pallas(shape, silu):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    c = shape[-1]
    scale = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = j_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6,
                             silu, use_pallas=True)
    got = tgn.group_norm_silu(nhwc_to_nchw(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), 32, 1e-6, silu)
    assert_close(nchw_to_nhwc(got), want, atol=2e-5, what="K1")


def test_k1_near_constant_groups_stay_finite():
    """Groups whose fp32 E[x^2] - E[x]^2 cancels to ~0 (or below): the clamp
    keeps rstd finite on both sides and they agree."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    x[..., :2] = 0.1 + 1e-7 * rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
    x[0, ..., 2:4] = 3.0
    scale = np.ones(64, np.float32)
    bias = np.full(64, 0.25, np.float32)
    want = np.asarray(j_group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), 32, 1e-6, True, use_pallas=True))
    got = nchw_to_nhwc(tgn.group_norm_silu(nhwc_to_nchw(x), torch.from_numpy(scale),
                                           torch.from_numpy(bias), 32, 1e-6, True))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert_close(got, want, atol=1e-4, what="K1 near-constant")


def _cpu_dispatch_case(name):
    g = torch.Generator().manual_seed(0)
    if name == "k1":
        args = (torch.randn(2, 64, 4, 4, generator=g), torch.ones(64), torch.zeros(64), 32,
                1e-6, True)
        return tgn.KERNEL, tgn.group_norm_silu, tgn._torch_group_norm_silu, args
    if name == "k2":
        args = tuple(torch.randn(1, 2, 1024, 64, generator=g) for _ in range(3))
        return tfa.KERNEL, tfa.attention_bnth, tfa._torch_attention, args
    c = 128
    w = lambda *s: torch.randn(*s, generator=g) * 0.1  # noqa: E731
    ff = lambda: (1.0 + w(c), w(c), w(8 * c, c), w(8 * c), w(c, 4 * c), w(c))  # noqa: E731
    if name == "k4":
        args = (torch.randn(2, 5, c, generator=g), *ff(), 1e-5, False, True)
        return tfb.KERNEL, tfb.ln_ff_kernel, tfb._torch_ln_ff_residual, args
    if name == "k5":
        args = (torch.randn(2, 5, c, generator=g), w(8 * c, c), w(8 * c), False)
        return tff.KERNEL, tff.geglu_kernel, tff._torch_geglu, args
    args = (torch.randn(2, 6, 8, c, generator=g), w(2, 8, c), 1.0 + w(c), w(c), w(c, c),
            w(c, c), w(c, c), w(c, c), w(c), 2, 1e-5)
    if name == "k3-full":
        args = (*args, ff(), ff(), False)  # fp32: exact gelu
        return tft.KERNEL_FULL, tft.temporal_block_full, tft._torch_temporal_block, args
    return tft.KERNEL, tft.temporal_block, tft._torch_temporal_block, args


@pytest.mark.parametrize("name", ["k1", "k2", "k3", "k3-full", "k4", "k5"])
def test_cpu_dispatch_runs_plain_and_counts_nothing(name):
    """On a CPU tensor each wrapper runs its plain version; only a kernel launch
    on the card moves its counter."""
    kernel, wrapper, plain, args = _cpu_dispatch_case(name)
    before = kernel.launches
    torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert kernel.launches == before


# ---------------------------------------------------------------- K2 attention
def test_k2_attention_bnth_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 1024, 2, 64)).astype(np.float32) for _ in range(3))
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))  # (B, N, T, H)
    got = tfa.attention_bnth(tq, tk, tv).transpose(1, 2)
    assert_close(got.numpy(), want, atol=2e-5, what="K2 attention_bnth")


def test_k2_attention_module_flash_path_matches_jax():
    """Port ``Attention`` at T = 1024, H = 64 takes the flash path (JAX runs
    ``jax.nn.dot_product_attention`` off the TPU); weights via the bridge."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 1024, 128)).astype(np.float32)
    jmod = JAttention(query_dim=128, heads=2, dim_head=64)
    params = fake_init(jmod, jnp.asarray(x), seed=3, scale=0.05)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = port(Attention(128, 2, 64), params)
    assert tfa.flash_eligible(1024, 1024, 64)
    calls = []
    orig = tfa.attention_bnth

    def spy(*a):
        calls.append(1)
        return orig(*a)

    tfa.attention_bnth = spy  # ``Attention`` calls the wrapper through its module
    try:
        got = tmod(torch.from_numpy(x))
    finally:
        tfa.attention_bnth = orig
    assert calls, "flash path not taken"
    assert_close(got.detach().numpy(), want, atol=1e-4, what="K2 module")


@pytest.mark.parametrize("tq,tk", [(16, 1), (14, 14), (40, 77)],
                         ids=["single-key", "tiny-seq", "plain"])
def test_k2_dot_product_attention_paths_match_jax(tq, tk):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, tq, 2, 16)).astype(np.float32)
    k = rng.standard_normal((3, tk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, tk, 2, 16)).astype(np.float32)
    want = jfa.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_close(got.numpy(), want, atol=2e-5, what=f"K2 {tq}x{tk}")


# ------------------------------------------- K2 narrow: head dims 40 and 80
# (tq, tk, H, dtype, on a Hopper card, an input that needs grad) -> whether
# ``dot_product_attention`` takes K2 narrow
_NARROW_RULE = {
    "svd-down0": ((4096, 4096, 40, torch.bfloat16, True, False), True),
    "svd-down1": ((1024, 1024, 80, torch.bfloat16, True, False), True),
    "h64": ((4096, 4096, 64, torch.bfloat16, True, False), False),
    "h128": ((1024, 1024, 128, torch.bfloat16, True, False), False),
    "down2-t256": ((256, 256, 40, torch.bfloat16, True, False), False),
    "t1088": ((1088, 1088, 40, torch.bfloat16, True, False), False),
    "cross-77": ((4096, 77, 40, torch.bfloat16, True, False), False),
    "fp32": ((4096, 4096, 40, torch.float32, True, False), False),
    "grad": ((4096, 4096, 40, torch.bfloat16, True, True), False),
    "cpu": ((1024, 1024, 80, torch.bfloat16, False, False), False),
}


@pytest.mark.parametrize("case", list(_NARROW_RULE))
def test_k2_narrow_rule_and_jax_rule_unchanged(case):
    """The narrow entry's rule, and beside it JAX's rule (``flash_eligible``,
    which ``Attention``'s K2 branch keeps) on the same shapes: JAX's takes
    H = 64 and 128 only, so the two never take the same call."""
    args, want = _NARROW_RULE[case]
    assert tfa.narrow_eligible(*args) == want
    tq, tk, h = args[:3]
    shape = lambda t: jax.ShapeDtypeStruct((1, t, 8, h), jnp.float32)  # noqa: E731
    assert tfa.flash_eligible(tq, tk, h) == jfa._eligible(shape(tq), shape(tk))
    assert not (want and tfa.flash_eligible(tq, tk, h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_narrow_head_dim_40_on_the_cpu_stays_plain_and_matches_jax(dtype):
    """At (2, 1024, 8, 40) on the CPU ``dot_product_attention`` keeps the plain
    path (no card): it matches ``jax.nn.dot_product_attention`` and the narrow
    entry's counter does not move."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 1024, 8, 40)).astype(np.float32) for _ in range(3))
    ins = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    want = jax.nn.dot_product_attention(*(jnp.asarray(x.float().numpy()) for x in ins))
    before = tfa.KERNEL_NARROW.launches, tfa.KERNEL.launches
    got = tfa.dot_product_attention(*ins)
    assert (tfa.KERNEL_NARROW.launches, tfa.KERNEL.launches) == before
    atol = 2e-5 if dtype == torch.float32 else 2e-2  # bf16: one rounding of P and of out
    assert_close(got.float().numpy(), want, atol=atol, what=f"dot_product_attention H=40 {dtype}")


# ---------------------------------------------------- K3 temporal attention
def _temporal_params(rng, c, ia):
    mk = lambda *s, sc=0.05: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(ln1_s=1.0 + mk(c), ln1_b=mk(c), wq=mk(c, ia, sc=0.1), wk=mk(c, ia, sc=0.1),
                wv=mk(c, ia), wo=mk(ia, c), bo=mk(c))


@pytest.mark.parametrize("cross", [False, True], ids=["no-cross", "cross-bias"])
@pytest.mark.parametrize("nh,hd", [(2, 64), (5, 16)], ids=["ia=c", "ia!=c"])
def test_k3_temporal_block_matches_jax_pallas(cross, nh, hd):
    b, f, s, c = 2, 6, 32, 128
    rng = np.random.default_rng(5)
    p = _temporal_params(rng, c, nh * hd)
    x = rng.standard_normal((b, f, s, c)).astype(np.float32)
    cb = rng.standard_normal((b, s, c)).astype(np.float32) * 0.5 if cross else None
    cfg = (("attn",), True, cross, nh, hd, 1e-5, False)
    want = jft.temporal_block(jnp.asarray(x), None if cb is None else jnp.asarray(cb),
                              {k: jnp.asarray(v) for k, v in p.items()}, cfg, True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tft.temporal_block(torch.from_numpy(x), None if cb is None else torch.from_numpy(cb),
                             t["ln1_s"], t["ln1_b"], t["wq"].T, t["wk"].T, t["wv"].T,
                             t["wo"].T, t["bo"], nh, 1e-5)
    assert_close(got.numpy(), want, atol=1e-4, what="K3")
