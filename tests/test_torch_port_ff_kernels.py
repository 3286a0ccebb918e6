"""K3 "full", K4 and K5 of the PyTorch port against the JAX package, on the CPU.

On the CPU each wrapper runs its plain version, so these tests hold the plain
versions (the arithmetic the CUDA kernels implement) against the JAX functions
running their Pallas kernels in interpret mode, on the same seeded numpy
inputs and weights:

- K3 "full": ``temporal_block_full`` vs JAX ``temporal_block(..., force_pallas=True)``
  with parts ("ffin", "attn", "ff"), with and without a cross bias, fp32 and bf16;
- K4: ``ln_ff_residual`` vs JAX ``ln_ff_residual(..., use_pallas=True)``, with
  and without the residual and with C_out != C;
- K5: ``geglu`` vs JAX ``geglu(..., use_pallas=True)``, tanh and exact gelu;
- the dispatch rules (temporal ``dispatch_mode``, the K4 and K5 rules) equal
  to JAX's with its device test patched to "TPU", over the SVD slice's blocks
  and a grid of thin shapes, with and without ``CTRL_ADAPTER_EXACT_GELU=1``;
- the gelu form each module asks its op for (``GEGLU``,
  ``BasicTransformerBlock``, the temporal block's "full", "hybrid" and module
  branches) equal to what the JAX module passes at the same site, with and
  without ``CTRL_ADAPTER_EXACT_GELU=1``;
- ``TemporalBasicTransformerBlock`` in bf16 at a thin shape where the rule
  picks "full".

Tolerances: fp32 2e-5 absolute for K4/K5 (summation order only) and 1e-4 for
K3 full (three sub-blocks, a softmax and LayerNorms in between). bf16: 4
steps of bf16 at the output's magnitude, |err| <= 4 * 2^-8 * max|want|: the
two sides round at different points (the Pallas kernel rounds every product
and bias add, the plain version rounds each ``F.linear`` once), and the
difference passes through up to three residual sub-blocks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctrl_adapter_tpu.ops.backend as jbackend
from ctrl_adapter_tpu.nn import attention as jattn
from ctrl_adapter_tpu.nn.attention import TemporalBasicTransformerBlock as JTemporalBlock
from ctrl_adapter_tpu.ops import fused_block as jfb
from ctrl_adapter_tpu.ops import fused_ff as jff
from ctrl_adapter_tpu.ops import fused_temporal as jft
from ctrl_adapter_tpu_torch.nn import attention as tattn
from ctrl_adapter_tpu_torch.nn.attention import TemporalBasicTransformerBlock
from ctrl_adapter_tpu_torch.ops import fused_block as tfb
from ctrl_adapter_tpu_torch.ops import fused_ff as tff
from ctrl_adapter_tpu_torch.ops import fused_temporal as tft

from .torch_port_common import assert_close, port
from .utils import fake_init

BF16_STEPS = 4 * 2.0 ** -8


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _close(got, want, dtype, atol_fp32, what):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    atol = atol_fp32 if dtype == torch.float32 else BF16_STEPS * np.abs(want).max()
    assert_close(got, want, atol=atol, what=what)


# ------------------------------------------------------------- K3 "full"
def _ff_weights(rng, c, iff, cout):
    """JAX layout: wg (c, 2*iff) = [value | gate] columns, w2 (iff, cout)."""
    return dict(ln_s=1.0 + _np(rng, c, scale=0.1), ln_b=_np(rng, c, scale=0.1),
                wg=_np(rng, c, 2 * iff, scale=c ** -0.5), bg=_np(rng, 2 * iff, scale=0.1),
                w2=_np(rng, iff, cout, scale=iff ** -0.5), b2=_np(rng, cout, scale=0.1))


def _ff_port(w, dtype):
    return tuple(_t(a, dtype) for a in (w["ln_s"], w["ln_b"], w["wg"].T, w["bg"], w["w2"].T,
                                        w["b2"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cross", [False, True], ids=["no-cross", "cross-bias"])
def test_k3_full_matches_jax_pallas(cross, dtype):
    b, f, s, c, nh, hd = 2, 6, 32, 128, 2, 64
    ia, iff = nh * hd, 4 * c
    rng = np.random.default_rng(10)
    ffin, ff = _ff_weights(rng, c, iff, c), _ff_weights(rng, c, iff, c)
    attn = dict(ln1_s=1.0 + _np(rng, c, scale=0.1), ln1_b=_np(rng, c, scale=0.1),
                wq=_np(rng, c, ia, scale=c ** -0.5), wk=_np(rng, c, ia, scale=c ** -0.5),
                wv=_np(rng, c, ia, scale=c ** -0.5), wo=_np(rng, ia, c, scale=ia ** -0.5),
                bo=_np(rng, c, scale=0.1))
    x = _np(rng, b, f, s, c)
    cb = _np(rng, b, s, c, scale=0.5) if cross else None
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    p = {k: _j(v, jd) for k, v in attn.items()}
    for prefix, w in (("ffin", ffin), ("ff", ff)):
        p[f"{'lnin' if prefix == 'ffin' else 'ln3'}_s"] = _j(w["ln_s"], jd)
        p[f"{'lnin' if prefix == 'ffin' else 'ln3'}_b"] = _j(w["ln_b"], jd)
        for key in ("wg", "bg", "w2", "b2"):
            p[f"{prefix}_{key}"] = _j(w[key], jd)
    cfg = (("ffin", "attn", "ff"), True, cross, nh, hd, 1e-5, dtype == torch.bfloat16)
    want = jft.temporal_block(_j(x, jd), None if cb is None else _j(cb, jd), p, cfg, True)
    got = tft.temporal_block_full(
        _t(x, dtype), None if cb is None else _t(cb, dtype), _t(attn["ln1_s"], dtype),
        _t(attn["ln1_b"], dtype), _t(attn["wq"].T, dtype), _t(attn["wk"].T, dtype),
        _t(attn["wv"].T, dtype), _t(attn["wo"].T, dtype), _t(attn["bo"], dtype), nh, 1e-5,
        _ff_port(ffin, dtype), _ff_port(ff, dtype), dtype == torch.bfloat16)
    assert got.dtype == dtype
    _close(got, want, dtype, 1e-4, "K3 full")


# ------------------------------------------------------------------- K4
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("residual,cout_mult", [(True, 1), (False, 1), (False, 2)],
                         ids=["residual", "no-residual", "dim-out"])
def test_k4_ln_ff_residual_matches_jax_pallas(residual, cout_mult, approximate):
    m, c = 64, 64
    inner, cout = 4 * c, cout_mult * c
    rng = np.random.default_rng(11)
    w = _ff_weights(rng, c, inner, cout)
    x = _np(rng, 2, m // 2, c)
    want = jfb.ln_ff_residual(jnp.asarray(x), *(jnp.asarray(w[k]) for k in
                                                ("ln_s", "ln_b", "wg", "bg", "w2", "b2")),
                              1e-5, approximate, residual, None, True)
    got = tfb.ln_ff_residual(_t(x, torch.float32), *_ff_port(w, torch.float32), 1e-5,
                             approximate, residual)
    assert got.shape == (2, m // 2, cout)
    _close(got, want, torch.float32, 2e-5, "K4")


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_k5_geglu_matches_jax_pallas(approximate):
    m, c, d = 256, 64, 256
    rng = np.random.default_rng(12)
    x = _np(rng, 2, m // 2, c)
    wk = _np(rng, c, 2 * d, scale=c ** -0.5)
    bias = _np(rng, 2 * d, scale=0.1)
    want = jff.geglu(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias), approximate, None,
                     True)
    got = tff.geglu(_t(x, torch.float32), _t(wk.T, torch.float32), _t(bias, torch.float32),
                    approximate)
    assert got.shape == (2, m // 2, d)
    _close(got, want, torch.float32, 2e-5, "K5")


# ---------------------------------------------------------- dispatch rules
# (name, b, f, s, c, ia, iff, JAX mode) of the SVD slice's temporal blocks
# (bf16, 14 frames, b = 2 after CFG)
SVD_BLOCKS = [
    ("unet-l0", 2, 14, 4096, 320, 320, 1280, "full"),
    ("unet-l1", 2, 14, 1024, 640, 640, 2560, "hybrid"),
    ("unet-l2", 2, 14, 256, 1280, 1280, 5120, None),
    ("unet-mid", 2, 14, 64, 1280, 1280, 5120, None),
    ("adapter-A", 2, 14, 4096, 512, 320, 2048, "hybrid"),
    ("adapter-B", 2, 14, 1024, 512, 640, 2048, "hybrid"),
    ("adapter-C", 2, 14, 256, 512, 1280, 2048, "hybrid"),
    ("adapter-D", 2, 14, 64, 512, 1280, 2048, "hybrid"),
]


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """The JAX dispatch as it decides on a TPU (its device test patched)."""
    monkeypatch.setattr(jft, "_on_tpu", lambda: True)
    monkeypatch.setattr(jbackend, "is_tpu_backend", lambda: True)
    return monkeypatch


@pytest.mark.parametrize("block", SVD_BLOCKS, ids=[blk[0] for blk in SVD_BLOCKS])
def test_dispatch_mode_matches_jax_on_the_svd_slice(jax_on_tpu, block):
    _, b, f, s, c, ia, iff, mode = block
    assert jft.dispatch_mode(b, f, s, c, ia, iff, jnp.bfloat16) == mode
    assert tft.dispatch_mode(b, f, s, c, ia, iff, torch.bfloat16) == mode
    assert tft.dispatch_mode(b, f, s, c, ia, iff, torch.float32) is None


# the I2VGen-XL adapter's 13 temporal blocks (c = 512 bug-compatible, ia = the
# block's channels, iff = 2048; b = 2 after CFG) at its 16 frames and at the 2
# to 4 key frames of a sparse-frame run
def _i2vgenxl_adapter_blocks():
    import chip_smoke

    return [(f"{c}@{h}x{h}", h * h, c) for c, h in chip_smoke.adapter_blocks()]


@pytest.mark.parametrize("f", [16, 4, 2], ids=["f16", "sparse-f4", "sparse-f2"])
@pytest.mark.parametrize("block", _i2vgenxl_adapter_blocks(),
                         ids=[f"block{i}-{blk[0]}" for i, blk in
                              enumerate(_i2vgenxl_adapter_blocks())])
def test_dispatch_mode_is_hybrid_on_the_i2vgenxl_adapter(jax_on_tpu, block, f):
    _, s, ia = block
    assert jft.dispatch_mode(2, f, s, 512, ia, 2048, jnp.bfloat16) == "hybrid"
    assert tft.dispatch_mode(2, f, s, 512, ia, 2048, torch.bfloat16) == "hybrid"


def test_dispatch_mode_matches_jax_on_thin_shapes(jax_on_tpu):
    seen = set()
    for f in (1, 4, 14, 16, 32, 33):
        for s in (7, 8, 16, 64, 256):
            for c in (64, 128, 320, 384, 448, 512):
                for ia in (64, c):
                    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
                        want = jft.dispatch_mode(2, f, s, c, ia, 4 * c, jd)
                        got = tft.dispatch_mode(2, f, s, c, ia, 4 * c, td)
                        assert got == want, (f, s, c, ia, td)
                        seen.add(want)
    assert seen == {"full", "hybrid", None}


def _jax_kernel_taken(module, pallas_name, out_shape, fn, *shapes):
    """Whether the JAX function would launch its Pallas kernel for these
    argument shapes: traced abstractly, with the kernel call replaced by a spy
    that returns zeros of ``out_shape(*its arguments)``."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return jnp.zeros(out_shape(*args), args[0].dtype)

    orig = getattr(module, pallas_name)
    setattr(module, pallas_name, spy)
    try:
        jax.eval_shape(fn, *shapes)
    finally:
        setattr(module, pallas_name, orig)
    return bool(calls)


def _set_env(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-block"])
def test_k4_rule_matches_jax(jax_on_tpu, env):
    """K4's rule against JAX's, with the gelu form each package's blocks ask
    for (``approximate``) under ``CTRL_ADAPTER_EXACT_GELU`` unset and "1": the
    kernel takes tanh-gelu only, so under the switch neither package runs it."""
    _set_env(jax_on_tpu, "CTRL_ADAPTER_FUSED_BLOCK", env)
    for exact in (None, "1"):
        _set_env(jax_on_tpu, "CTRL_ADAPTER_EXACT_GELU", exact)
        taken = set()
        for m in (2048, 4096, 4104, 28 * 4096, 14 * 4096 + 8):
            for c in (64, 320, 384, 640, 1280):
                for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
                    inner = 4 * c
                    approx = jd == jnp.bfloat16 and exact != "1"  # the JAX blocks' rule
                    assert tattn.gelu_approximate(td) == approx
                    sd = lambda *s: jax.ShapeDtypeStruct(s, jd)  # noqa: E731
                    fn = lambda x, a, b_, wg, bg, w2, b2: jfb.ln_ff_residual(  # noqa: E731
                        x, a, b_, wg, bg, w2, b2, 1e-5, approx, True, jd)
                    want = _jax_kernel_taken(
                        jfb, "_pallas_ln_ff_residual",
                        lambda x2, *a: (x2.shape[0], a[4].shape[1]), fn, sd(m, c), sd(c), sd(c),
                        sd(c, 2 * inner), sd(2 * inner), sd(inner, c), sd(c))
                    got = tfb.use_kernel(m, c, inner, td, tattn.gelu_approximate(td))
                    assert got == want, (m, c, td, exact)
                    taken.add(want)
        assert taken == ({False} if env is None or exact == "1" else {False, True})


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-ff"])
def test_k5_rule_matches_jax(jax_on_tpu, env):
    if env is None:
        jax_on_tpu.delenv("CTRL_ADAPTER_FUSED_FF", raising=False)
    else:
        jax_on_tpu.setenv("CTRL_ADAPTER_FUSED_FF", env)
    taken = {}
    for m in (100, 256, 28 * 1024, 28 * 4096):
        for c in (64, 320, 640, 1280):
            for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
                d2 = 8 * c
                sd = lambda *s: jax.ShapeDtypeStruct(s, jd)  # noqa: E731
                fn = lambda x, k, b_: jff.geglu(x, k, b_, jd == jnp.bfloat16, None)  # noqa: E731
                want = _jax_kernel_taken(
                    jff, "_pallas_geglu", lambda x2, k, *a: (x2.shape[0], k.shape[1] // 2), fn,
                    sd(m, c), sd(c, d2), sd(d2))
                assert tff.use_kernel(m, c, d2, td) == want, (m, c, td)
                if td == torch.bfloat16 and m == 28 * 4096:
                    taken[c] = want
    # C = 320 and 640 qualify and C = 1280 does not (under the switch)
    assert taken == {64: env == "1", 320: env == "1", 640: env == "1", 1280: False}


# ------------------------------------------- the gelu form at every site
def _record(calls, out_shape, pick):
    """A spy that records ``pick(args, kwargs)`` and returns zeros of
    ``out_shape(*args)`` (JAX, traced abstractly)."""
    def spy(*args, **kwargs):
        calls.append(pick(args, kwargs))
        return jnp.zeros(out_shape(*args), args[0].dtype)
    return spy


def _jax_site(site, monkeypatch, jd):
    """The gelu forms (``approximate``) the JAX module passes to its ops at
    ``site``, in call order, from an abstract trace of its apply."""
    b, f, s, c, nh, hd = 1, 2, 4, 64, 1, 64
    calls, static = [], ()
    same = lambda x, *a: x.shape  # noqa: E731
    ff_out = lambda x, *a: x.shape[:-1] + (a[4].shape[1],)  # noqa: E731
    if site == "geglu":
        mod, args = jattn.GEGLU(4 * c, dtype=jd), (jnp.zeros((b, s, c), jd),)
        monkeypatch.setattr(jff, "geglu", _record(
            calls, lambda x, k, *a: x.shape[:-1] + (k.shape[1] // 2,),
            lambda a, kw: kw["approximate"]))
    elif site == "basic":
        mod = jattn.BasicTransformerBlock(c, nh, hd, dtype=jd)
        args = (jnp.zeros((b, s, c), jd),)
        monkeypatch.setattr(jfb, "ln_ff_residual", _record(calls, ff_out, lambda a, kw: a[8]))
    else:
        mode = {"temporal-full": "full", "temporal-hybrid": "hybrid", "temporal-module": None}[site]
        mod = jattn.TemporalBasicTransformerBlock(c, c, nh, hd, dtype=jd)
        args, static = (jnp.zeros((b * f, s, c), jd),), (f,)
        monkeypatch.setattr(jft, "dispatch_mode", lambda *a, **k: mode)
        monkeypatch.setattr(jft, "temporal_block", _record(
            calls, same, lambda a, kw: a[3][-1] if "ff" in a[3][0] else "attn"))
        monkeypatch.setattr(jft, "_xla_temporal_block", _record(
            calls, same, lambda a, kw: a[3]["approximate"]))
        monkeypatch.setattr(jfb, "ln_ff_residual", _record(calls, ff_out, lambda a, kw: a[8]))
    params = jax.eval_shape(lambda k, *a: mod.init(k, *a, *static), jax.random.PRNGKey(0), *args)
    calls.clear()
    jax.eval_shape(lambda p, *a: mod.apply(p, *a, *static), params, *args)
    return [v for v in calls if v != "attn"]


def _port_site(site, monkeypatch, td):
    """The gelu forms the port's module passes to its ops at ``site``, in
    call order, from a forward on the CPU."""
    b, f, s, c, nh, hd = 1, 2, 4, 64, 1, 64
    calls = []

    def spy(module, name, pick):
        orig = getattr(module, name)

        def wrapped(*a, **kw):
            calls.append(pick(a))
            return orig(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    if site == "geglu":
        mod, args = tattn.GEGLU(c, 4 * c), (torch.zeros(b, s, c),)
        spy(tff, "geglu", lambda a: a[3])
    elif site == "basic":
        mod, args = tattn.BasicTransformerBlock(c, nh, hd), (torch.zeros(b, s, c),)
        spy(tfb, "ln_ff_residual", lambda a: a[8])
    else:
        mode = {"temporal-full": "full", "temporal-hybrid": "hybrid", "temporal-module": None}[site]
        mod, args = TemporalBasicTransformerBlock(c, c, nh, hd), (torch.zeros(b * f, s, c), f)
        monkeypatch.setattr(tft, "dispatch_mode", lambda *a, **k: mode)
        if mode == "full":
            spy(tft, "temporal_block_full", lambda a: a[13])
        else:  # the hybrid branch's FFs are plain on (b, f, s, c); the module path's go to K4's op
            spy(tfb, "_torch_ln_ff_residual" if mode else "ln_ff_residual", lambda a: a[8])
    mod = mod.to(td)
    with torch.no_grad():
        mod(*(a.to(td) if torch.is_tensor(a) else a for a in args))
    return calls


SITES = ["geglu", "basic", "temporal-full", "temporal-hybrid", "temporal-module"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("exact", [None, "1"], ids=["default", "exact-gelu"])
@pytest.mark.parametrize("site", SITES)
def test_gelu_form_matches_jax_at_every_site(monkeypatch, site, exact, dtype):
    """Each port module asks its op for the gelu form the JAX module passes at
    the same site: tanh under bf16, erf under fp32 or ``CTRL_ADAPTER_EXACT_GELU=1``
    (read per call). Before the repair the port ignored the switch and gave
    its ops tanh-gelu under bf16 at every site."""
    _set_env(monkeypatch, "CTRL_ADAPTER_EXACT_GELU", exact)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _jax_site(site, monkeypatch, jd)
    got = _port_site(site, monkeypatch, dtype)
    n = {"geglu": 1, "basic": 1, "temporal-full": 1}.get(site, 2)
    assert len(want) == n and got == want, (got, want)
    assert want == [dtype == torch.bfloat16 and exact != "1"] * n


# ------------------------------------------ the block where "full" is picked
def test_temporal_block_bf16_full_mode_matches_jax(monkeypatch):
    """A bf16 block at a thin shape where the rule picks "full" goes through
    ``temporal_block_full`` (its plain version here) and agrees with the JAX
    block's "full" path in bf16 (which runs the XLA mirror off the TPU)."""
    b, f, s, c, nh, hd = 1, 6, 16, 128, 2, 64
    assert tft.dispatch_mode(b, f, s, c, nh * hd, 4 * c, torch.bfloat16) == "full"
    rng = np.random.default_rng(13)
    x = _np(rng, b * f, s, c)
    ctx = _np(rng, b * s, 1, 32)
    jmod = JTemporalBlock(dim=c, time_mix_inner_dim=c, num_attention_heads=nh,
                          attention_head_dim=hd, cross_attention_dim=32, dtype=jnp.bfloat16)
    params = fake_init(jmod, jnp.asarray(x), f, encoder_hidden_states=jnp.asarray(ctx), seed=4,
                       scale=0.05)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    monkeypatch.setattr(jft, "dispatch_mode", lambda *a, **k: "full")
    want = jmod.apply(params, jnp.asarray(x, jnp.bfloat16), f,
                      encoder_hidden_states=jnp.asarray(ctx, jnp.bfloat16))
    tmod = port(TemporalBasicTransformerBlock(c, c, nh, hd, 32), params).to(torch.bfloat16)
    calls = []
    orig = tft.temporal_block_full

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tft, "temporal_block_full", spy)
    with torch.no_grad():
        got = tmod(_t(x, torch.bfloat16), f, _t(ctx, torch.bfloat16))
    assert calls == [1]
    _close(got, want, torch.bfloat16, None, "bf16 block, full mode")
