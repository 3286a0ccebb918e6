"""Gradients of the port's kernel ops against ``jax.vjp`` of the JAX ops, fp32 on the CPU.

- K2: ``attention_bnth`` under grad goes through ``FlashAttention`` (the port
  of the Pallas kernel's custom VJP); on the CPU its forward is the plain
  version with the rows' log-sum-exp and its backward
  ``_torch_attention_bwd``. Both are held against ``jax.vjp`` of
  ``jax.nn.dot_product_attention`` (what ``ops/flash_attention.py`` runs off
  the TPU) at (1, 2, 1024, 64) and at H = 128.
- K1, K3 hybrid, K3 full, K4 and K5: on a card their wrappers run the kernel
  forward through ``mirror_vjp.MirrorVJP``, whose backward is autograd of the
  plain version, as each JAX ``custom_vjp`` takes the VJP of its XLA mirror.
  Here ``MirrorVJP`` runs with the plain version standing in for the kernel
  (there is no card), and its gradients for every tensor input are held
  against ``jax.vjp`` of the JAX op, its Pallas kernel in interpret mode.

Tolerances, fp32: 1e-5 of the largest gradient element for K2 and the
normalisations (summation order only), 1e-4 for the blocks with a softmax and
two LayerNorms between input and output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.ops import fused_block as jfb
from ctrl_adapter_tpu.ops import fused_ff as jff
from ctrl_adapter_tpu.ops import fused_temporal as jft
from ctrl_adapter_tpu.ops.group_norm import group_norm_silu as j_group_norm_silu
from ctrl_adapter_tpu_torch.ops import flash_attention as tfa
from ctrl_adapter_tpu_torch.ops import fused_block as tfb
from ctrl_adapter_tpu_torch.ops import fused_ff as tff
from ctrl_adapter_tpu_torch.ops import fused_temporal as tft
from ctrl_adapter_tpu_torch.ops import group_norm as tgn
from ctrl_adapter_tpu_torch.ops import mirror_vjp

from .test_torch_port_ff_kernels import _ff_weights
from .test_torch_port_kernels import _temporal_params
from .torch_port_common import assert_close


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grads_close(got, want, rel, what):
    """Each gradient within ``rel`` of the largest gradient element of its tensor."""
    for name in want:
        w = np.asarray(want[name], np.float64)
        assert_close(np.asarray(got[name]), w, atol=rel * np.abs(w).max(), what=f"{what} d{name}")


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("h", [64, 128])
def test_k2_backward_matches_jax_vjp(h):
    rng = np.random.default_rng(20 + h)
    q, k, v, do = (_np(rng, 1, 1024, 2, h) for _ in range(4))  # (B, T, N, H)
    want_out, vjp = jax.vjp(jax.nn.dot_product_attention, *map(jnp.asarray, (q, k, v)))
    want = dict(zip("qkv", vjp(jnp.asarray(do))))
    logits = jnp.einsum("btnh,bsnh->bnts", q, k) * h ** -0.5
    want_lse = jax.nn.logsumexp(logits, axis=-1)

    bnth = lambda a: torch.from_numpy(a).transpose(1, 2)  # noqa: E731
    tq, tk, tv = (bnth(a).requires_grad_() for a in (q, k, v))
    out = tfa.attention_bnth(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), bnth(do))
    assert_close(out.detach().transpose(1, 2).numpy(), want_out, atol=2e-5, what="K2 output")
    _grads_close({n: g.transpose(1, 2).numpy() for n, g in zip("qkv", got)}, want, 1e-5,
                 "K2 FlashAttention")

    # the plain backward on its own, from the plain forward's output and lse
    o, lse = tfa._torch_attention(bnth(q), bnth(k), bnth(v), with_lse=True)
    assert_close(lse.numpy(), want_lse, atol=1e-5, what="K2 log-sum-exp")
    plain = tfa._torch_attention_bwd(bnth(q), bnth(k), bnth(v), o, bnth(do), lse)
    _grads_close({n: g.transpose(1, 2).numpy() for n, g in zip("qkv", plain)}, want, 1e-5,
                 "K2 _torch_attention_bwd")


@pytest.mark.parametrize("op", ["k2", "mirror"])
def test_backward_under_gradient_checkpointing(op):
    """The trainer recomputes the adapter and the UNet under non-reentrant
    checkpointing, which lets a backward unpack each saved tensor once:
    ``FlashAttention`` and ``MirrorVJP`` give the same gradients with and
    without it."""
    from torch.utils.checkpoint import checkpoint

    g = torch.Generator().manual_seed(7)
    if op == "k2":
        x = torch.randn(1, 2, 1024, 64, generator=g)
        fn = lambda t: tfa.attention_bnth(t, t * 0.5, t * 0.25)  # noqa: E731
    else:
        x = torch.randn(2, 64, 4, 4, generator=g)
        w, b = torch.ones(64), torch.zeros(64)
        fn = lambda t: mirror_vjp.apply(  # noqa: E731
            tgn._torch_group_norm_silu, tgn._torch_group_norm_silu, t, w, b, 32, 1e-6, True)
    grads = []
    for remat in (False, True):
        leaf = x.clone().requires_grad_()
        out = checkpoint(fn, leaf, use_reentrant=False) if remat else fn(leaf)
        grads.append(torch.autograd.grad((out * out).sum(), leaf)[0])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)


def test_k2_without_grad_saves_nothing():
    """Serving: without grad the forward takes the no-lse launch and records
    no backward."""
    q = torch.randn(1, 2, 1024, 64, requires_grad=True)
    with torch.no_grad():
        out = tfa.attention_bnth(q, q, q)
    assert out.grad_fn is None


# --------------------------------------------- K1, K3, K4, K5: MirrorVJP
def _mirror(plain, *args):
    """``mirror_vjp.apply`` with the plain version standing in for the kernel;
    checks that the kernel ran once and that the output's backward is
    ``MirrorVJP``'s."""
    calls = []

    def kernel(*a):
        calls.append(1)
        return plain(*a)

    out = mirror_vjp.apply(kernel, plain, *args)
    assert calls == [1] and type(out.grad_fn).__name__ == "MirrorVJPBackward"
    return out


def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def test_mirror_vjp_runs_the_kernel_alone_without_grad():
    x = torch.randn(2, 64, 4, 4, requires_grad=True)
    w, b = torch.ones(64), torch.zeros(64)
    calls = []
    with torch.no_grad():
        out = mirror_vjp.apply(lambda *a: calls.append(1) or tgn._torch_group_norm_silu(*a),
                               tgn._torch_group_norm_silu, x, w, b, 32, 1e-6, True)
    assert calls == [1] and out.grad_fn is None


@pytest.mark.parametrize("silu", [False, True])
def test_k1_gradient_matches_jax_vjp(silu):
    rng = np.random.default_rng(21)
    x, g = _np(rng, 2, 4, 4, 64), _np(rng, 2, 4, 4, 64)  # NHWC
    scale, bias = 1.0 + _np(rng, 64, scale=0.1), _np(rng, 64, scale=0.1)
    _, vjp = jax.vjp(lambda *a: j_group_norm_silu(*a, 32, 1e-6, silu, True),
                     *map(jnp.asarray, (x, scale, bias)))
    want = dict(zip(("x", "weight", "bias"), vjp(jnp.asarray(g))))
    want["x"] = np.moveaxis(np.asarray(want["x"]), -1, 1)
    tx, tw, tb = _leaf(np.moveaxis(x, -1, 1)), _leaf(scale), _leaf(bias)
    out = _mirror(tgn._torch_group_norm_silu, tx, tw, tb, 32, 1e-6, silu)
    got = torch.autograd.grad(out, (tx, tw, tb), torch.from_numpy(np.moveaxis(g, -1, 1).copy()))
    _grads_close(dict(zip(("x", "weight", "bias"), (t.numpy() for t in got))), want, 1e-5, "K1")


def _temporal_case(rng, full, cross):
    """(JAX params, port args after x and the cross bias, port weight names in
    the JAX keys' order) of a (2, 6, 32, 128) block with 2 heads of 64."""
    c, nh, hd = 128, 2, 64
    p = _temporal_params(rng, c, nh * hd)
    names = ["ln1_s", "ln1_b", "wq", "wk", "wv", "wo", "bo"]
    if full:
        for prefix, ln in (("ffin", "lnin"), ("ff", "ln3")):
            w = _ff_weights(rng, c, 4 * c, c)
            p.update({f"{ln}_s": w["ln_s"], f"{ln}_b": w["ln_b"]})
            p.update({f"{prefix}_{k}": w[k] for k in ("wg", "bg", "w2", "b2")})
    return p, names, nh, hd


@pytest.mark.parametrize("full", [False, True], ids=["hybrid", "full"])
@pytest.mark.parametrize("cross", [False, True], ids=["no-cross", "cross-bias"])
def test_k3_gradient_matches_jax_vjp(full, cross):
    """The cross bias and every weight get gradients where the JAX VJP
    returns them."""
    rng = np.random.default_rng(22 + 2 * full + cross)
    p, names, nh, hd = _temporal_case(rng, full, cross)
    x, g = _np(rng, 2, 6, 32, 128), _np(rng, 2, 6, 32, 128)
    cb = _np(rng, 2, 32, 128, scale=0.5) if cross else None
    parts = ("ffin", "attn", "ff") if full else ("attn",)
    cfg = (parts, True, cross, nh, hd, 1e-5, False)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if cross:
        _, vjp = jax.vjp(lambda xx, cc, pp: jft.temporal_block(xx, cc, pp, cfg, True),
                         jnp.asarray(x), jnp.asarray(cb), jp)
        dx, dcb, dp = vjp(jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda xx, pp: jft.temporal_block(xx, None, pp, cfg, True),
                         jnp.asarray(x), jp)
        (dx, dp), dcb = vjp(jnp.asarray(g)), None
    # the port's weights in nn.Linear layout: the JAX kernels transposed
    tr = lambda k, a: a.T if k in ("wq", "wk", "wv", "wo", "ffin_wg", "ffin_w2", "ff_wg",  # noqa: E731
                                   "ff_w2") else a
    t = {k: _leaf(tr(k, v)) for k, v in p.items()}
    tx, tcb = _leaf(x), None if cb is None else _leaf(cb)
    args = [tx, tcb, *(t[n] for n in names), nh, 1e-5]
    if full:
        ffs = [tuple(t[k] for k in (f"{ln}_s", f"{ln}_b", f"{pre}_wg", f"{pre}_bg", f"{pre}_w2",
                                    f"{pre}_b2"))
               for pre, ln in (("ffin", "lnin"), ("ff", "ln3"))]
        args += [*ffs, False]
    out = _mirror(tft._torch_temporal_block, *args)
    leaves = {"x": tx, **({"cross_bias": tcb} if cross else {}), **t}
    got = dict(zip(leaves, torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(g))))
    want = {"x": dx, **({"cross_bias": dcb} if cross else {}),
            **{k: tr(k, np.asarray(v)) for k, v in dp.items()}}
    assert set(got) == set(want)
    _grads_close({k: v.numpy() for k, v in got.items()}, want, 1e-4,
                 f"K3 {'full' if full else 'hybrid'}")


@pytest.mark.parametrize("residual", [True, False])
def test_k4_gradient_matches_jax_vjp(residual):
    rng = np.random.default_rng(24)
    c = 64
    w = _ff_weights(rng, c, 4 * c, c)
    x, g = _np(rng, 2, 32, c), _np(rng, 2, 32, c)
    keys = ("ln_s", "ln_b", "wg", "bg", "w2", "b2")
    _, vjp = jax.vjp(lambda xx, *ws: jfb.ln_ff_residual(xx, *ws, 1e-5, False, residual, None,
                                                        True),
                     jnp.asarray(x), *(jnp.asarray(w[k]) for k in keys))
    want = dict(zip(("x", *keys), vjp(jnp.asarray(g))))
    want = {k: np.asarray(v).T if k in ("wg", "w2") else v for k, v in want.items()}
    leaves = {"x": _leaf(x), **{k: _leaf(w[k].T if k in ("wg", "w2") else w[k]) for k in keys}}
    out = _mirror(tfb._torch_ln_ff_residual, *leaves.values(), 1e-5, False, residual)
    got = torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(g))
    _grads_close(dict(zip(leaves, (t.numpy() for t in got))), want, 1e-5, "K4")


def test_k5_gradient_matches_jax_vjp():
    rng = np.random.default_rng(25)
    c, d = 64, 128
    x, g = _np(rng, 2, 32, c), _np(rng, 2, 32, d)
    wk, bias = _np(rng, c, 2 * d, scale=c ** -0.5), _np(rng, 2 * d, scale=0.1)
    _, vjp = jax.vjp(lambda *a: jff.geglu(*a, False, None, True),
                     *map(jnp.asarray, (x, wk, bias)))
    dx, dw, db = vjp(jnp.asarray(g))
    tx, tw, tb = _leaf(x), _leaf(wk.T), _leaf(bias)
    out = _mirror(tff._torch_geglu, tx, tw, tb, False)
    got = torch.autograd.grad(out, (tx, tw, tb), torch.from_numpy(g))
    _grads_close({"x": got[0].numpy(), "w": got[1].numpy(), "b": got[2].numpy()},
                 {"x": dx, "w": np.asarray(dw).T, "b": db}, 1e-5, "K5")
