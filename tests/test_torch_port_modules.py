"""Modules of the PyTorch port against the JAX package, through the weight bridge.

Each test fabricates a JAX param tree (``tests/utils.py:fake_init``), loads it
into the port module with ``convert/from_jax.py`` (strict: every leaf used once,
every parameter filled) and feeds both sides the same numpy inputs, NHWC to the
JAX module and NCHW / NCFHW to the port. All fp32 on the CPU (the dispatch
test of the temporal block also runs bf16).

Tolerances: 1e-5 absolute per block (fp32 summation order only); 2e-5 for the
ControlNet, adapter, UNet and VAE, whose outputs pass through tens of blocks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter
from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.unet_svd import SVDUNetConfig
from ctrl_adapter_tpu.models.unet_svd import UNetSpatioTemporalConditionModel as JUNet
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JVAE
from ctrl_adapter_tpu.nn.attention import TemporalBasicTransformerBlock as JTemporalBlock
from ctrl_adapter_tpu.nn.resnet import ResnetBlock2D as JResnet
from ctrl_adapter_tpu.nn.resnet import TemporalResnetBlock as JTemporalResnet
from ctrl_adapter_tpu.schedulers import euler_discrete as jsched
from ctrl_adapter_tpu_torch.convert.from_jax import state_dict_from_jax
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
from ctrl_adapter_tpu_torch.models.vae import VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.nn.attention import TemporalBasicTransformerBlock
from ctrl_adapter_tpu_torch.nn.resnet import ResnetBlock2D, TemporalResnetBlock
from ctrl_adapter_tpu_torch.schedulers import euler_discrete as tsched

from .torch_port_common import assert_close, nchw_to_nhwc, nhwc_to_nchw, port
from .utils import fake_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------- blocks
def test_resnet_block_2d_matches_jax():
    rng = np.random.default_rng(0)
    x, temb = _np(rng, 2, 8, 8, 64), _np(rng, 2, 128)
    jmod = JResnet(in_channels=64, out_channels=96, temb_channels=128)
    params = fake_init(jmod, jnp.asarray(x), jnp.asarray(temb), seed=1, scale=0.1)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(temb))
    tmod = port(ResnetBlock2D(64, 96, 128), params)
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(nchw_to_nhwc(got), want, atol=1e-5, what="ResnetBlock2D")


def test_temporal_resnet_block_matches_jax():
    rng = np.random.default_rng(1)
    x, temb = _np(rng, 2, 3, 4, 4, 64), _np(rng, 2, 3, 128)
    jmod = JTemporalResnet(in_channels=64, out_channels=64, temb_channels=128)
    params = fake_init(jmod, jnp.asarray(x), jnp.asarray(temb), seed=2, scale=0.1)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(temb))
    tmod = port(TemporalResnetBlock(64, 64, 128), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))),
                   torch.from_numpy(temb))
    assert_close(got.numpy().transpose(0, 2, 3, 4, 1), want, atol=1e-5,
                 what="TemporalResnetBlock")


@pytest.mark.parametrize("nh,hd,ctx_keys", [(2, 64, 0), (5, 16, 1), (2, 64, 3)],
                         ids=["hybrid-no-cross", "hybrid-cross-ia!=c", "module-path-3-keys"])
def test_temporal_transformer_block_matches_jax(nh, hd, ctx_keys):
    """In fp32 the block takes the transposing module path, as JAX does off the
    TPU. With a single-key or absent context the port's hybrid decomposition
    (which bf16 dispatches to; K3's plain version on the CPU) is checked too."""
    b, f, s, c = 2, 6, 16, 128
    rng = np.random.default_rng(2)
    x = _np(rng, b * f, s, c)
    cross = 96 if ctx_keys else None
    ctx = jnp.asarray(_np(rng, b * s, ctx_keys, 96)) if ctx_keys else None
    jmod = JTemporalBlock(dim=c, time_mix_inner_dim=c, num_attention_heads=nh,
                          attention_head_dim=hd, cross_attention_dim=cross)
    params = fake_init(jmod, jnp.asarray(x), f, encoder_hidden_states=ctx, seed=3, scale=0.05)
    want = jmod.apply(params, jnp.asarray(x), f, encoder_hidden_states=ctx)
    tmod = port(TemporalBasicTransformerBlock(c, c, nh, hd, cross), params)
    tctx = None if ctx is None else torch.from_numpy(np.array(ctx))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), f, tctx)
        hybrid = tmod._hybrid(torch.from_numpy(x), f, tctx) if ctx_keys <= 1 else None
    assert_close(got.numpy(), want, atol=1e-5, what="TemporalBasicTransformerBlock")
    if hybrid is not None:
        assert_close(hybrid.numpy(), want, atol=1e-5, what="hybrid decomposition")


@pytest.mark.parametrize("dtype,hybrid", [(torch.bfloat16, True), (torch.float32, False)],
                         ids=["bf16-hybrid", "fp32-module-path"])
def test_temporal_transformer_block_dispatch_follows_jax_rule(dtype, hybrid):
    """The JAX dispatch rule: bf16 with a single-key context goes through
    ``ft.temporal_block`` (K3 on a card, its plain version here); fp32 takes
    the module path whatever the device."""
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft

    b, f, s, c = 1, 4, 8, 128
    g = torch.Generator().manual_seed(0)
    module = TemporalBasicTransformerBlock(c, c, 2, 64, 32, dtype=dtype)
    calls = []
    orig = ft.temporal_block

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    ft.temporal_block = spy
    try:
        with torch.no_grad():
            out = module(torch.randn(b * f, s, c, generator=g).to(dtype), f,
                         torch.randn(b * s, 1, 32, generator=g).to(dtype))
    finally:
        ft.temporal_block = orig
    assert out.shape == (b * f, s, c) and torch.isfinite(out.float()).all()
    assert bool(calls) == hybrid


# --------------------------------------------- ControlNet + adapter, real widths
@pytest.fixture(scope="module")
def controlnet_and_adapter():
    """SD-v1.5 ControlNet and the 13-block SVD adapter at the real widths
    320/640/1280 with 8x8 latents (64x64 condition), two frames."""
    rng = np.random.default_rng(4)
    n, f = 2, 2
    lat, cond = _np(rng, n, 8, 8, 4), rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)
    txt, ts = _np(rng, n, 7, 768), np.full((n,), 501.0, np.float32)
    jc = JControlNet()
    cparams = fake_init(jc, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(txt),
                        jnp.asarray(cond))
    downs, mid = jax.jit(lambda p, *a: jc.apply(p, *a, skip_conv_in=True))(
        cparams, lat, ts, txt, cond)
    kw = dict(cross_attention_dim=1024, num_blocks=1,
              adapter_locations=("A", "B", "C", "D", "M"), add_temporal_resnet=True,
              add_temporal_transformer=True)
    ja = JAdapter(backbone_model_name="svd", **kw)
    emb = _np(rng, 1, 1, 1024)
    aparams = fake_init(ja, list(downs), mid, f, jnp.asarray(ts), jnp.asarray(emb), seed=5)
    adown, amid = jax.jit(lambda p, d, m, t, e: ja.apply(
        p, d, m, num_frames=f, timestep=t, encoder_hidden_states=e))(aparams, downs, mid, ts,
                                                                     emb)
    return dict(inputs=(lat, ts, txt, cond), emb=emb, f=f, kw=kw, cparams=cparams,
                aparams=aparams, downs=downs, mid=mid, adown=adown, amid=amid)


def test_controlnet_matches_jax_real_widths(controlnet_and_adapter):
    d = controlnet_and_adapter
    lat, ts, txt, cond = d["inputs"]
    tmod = port(ControlNetModel(), d["cparams"])
    with torch.no_grad():
        downs, mid = tmod(nhwc_to_nchw(lat), torch.from_numpy(ts), torch.from_numpy(txt),
                          nhwc_to_nchw(cond), skip_conv_in=True)
    assert len(downs) == len(d["downs"]) == 12
    for k, (got, want) in enumerate(zip(downs, d["downs"])):
        assert_close(nchw_to_nhwc(got), want, atol=2e-5, what=f"ControlNet down {k}")
    assert_close(nchw_to_nhwc(mid), d["mid"], atol=2e-5, what="ControlNet mid")


def test_controlnet_adapter_matches_jax_real_widths(controlnet_and_adapter):
    d = controlnet_and_adapter
    tmod = port(ControlNetAdapter(**d["kw"]), d["aparams"])
    with torch.no_grad():
        downs, mid = tmod([nhwc_to_nchw(x) for x in d["downs"]], nhwc_to_nchw(d["mid"]),
                          d["f"], torch.from_numpy(d["inputs"][1]),
                          torch.from_numpy(d["emb"]))
    for k, (got, want) in enumerate(zip(downs, d["adown"])):
        assert_close(nchw_to_nhwc(got), want, atol=2e-5, what=f"adapter down {k}")
    assert_close(nchw_to_nhwc(mid), d["amid"], atol=2e-5, what="adapter mid")


# --------------------------------------------------------------- thin SVD UNet
THIN_UNET = SVDUNetConfig(block_out_channels=(32, 32, 64, 64), num_attention_heads=(2, 2, 4, 4),
                          cross_attention_dim=32, addition_time_embed_dim=8,
                          projection_class_embeddings_input_dim=24)
# skip tensors of THIN_UNET at 8x8 latents: (channels, size)
THIN_SKIPS = [(32, 8)] * 3 + [(32, 4)] * 3 + [(32, 2)] + [(64, 2)] * 2 + [(64, 1)] * 3


def test_unet_svd_with_residuals_matches_jax():
    from ctrl_adapter_tpu_torch.models.unet_svd import SVDUNetConfig as TConfig

    rng = np.random.default_rng(6)
    b, f = 2, 3
    sample, emb = _np(rng, b, f, 8, 8, 8), _np(rng, b, 1, 32)
    t, tids = np.array([1.5, -0.7], np.float32), np.array([[6, 127, 0.02]] * b, np.float32)
    res = [_np(rng, b * f, s, s, c, scale=0.1) for c, s in THIN_SKIPS]
    mid = _np(rng, b * f, 1, 1, 64, scale=0.1)
    jmod = JUNet(config=THIN_UNET)
    params = fake_init(jmod, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(emb),
                       jnp.asarray(tids), seed=7, scale=0.05)
    want = jax.jit(lambda p, *a: jmod.apply(p, *a[:4], down_block_additional_residuals=a[4],
                                            mid_block_additional_residual=a[5]))(
        params, sample, t, emb, tids, res, mid)
    tmod = port(UNetSpatioTemporalConditionModel(TConfig(**THIN_UNET.__dict__)), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(sample.transpose(0, 1, 4, 2, 3))),
                   torch.from_numpy(t), torch.from_numpy(emb), torch.from_numpy(tids),
                   [nhwc_to_nchw(r) for r in res], nhwc_to_nchw(mid))
    assert_close(got.numpy().transpose(0, 1, 3, 4, 2), want, atol=2e-5, what="SVD UNet")


# ------------------------------------------------------------ temporal VAE
THIN_VAE = dict(block_out_channels=(32, 32, 32, 32), norm_num_groups=8)


@pytest.mark.parametrize("layers", [1, 2], ids=["1-layer", "2-layer-mid-attention"])
def test_temporal_vae_decode_matches_jax(layers):
    rng = np.random.default_rng(8)
    num_frames = 3
    z = _np(rng, num_frames, 8, 8, 4)
    jmod = JVAE(config=JVAEConfig(**THIN_VAE, layers_per_block=layers))
    params = fake_init(jmod, jnp.ones((1, 64, 64, 3)), seed=9, scale=0.05)
    want = jax.jit(lambda p, zz: jmod.apply(p, zz, num_frames, method="decode"))(params, z)
    tmod = port(AutoencoderKLTemporalDecoder(VAEConfig(**THIN_VAE, layers_per_block=layers)),
                params)
    with torch.no_grad():
        got = tmod.decode(nhwc_to_nchw(z), num_frames)
    assert got.shape == (num_frames, 3, 64, 64)
    assert_close(nchw_to_nhwc(got), want, atol=2e-5, what="temporal VAE decode")


# ----------------------------------------------------------------- scheduler
@pytest.mark.parametrize("svd", [True, False], ids=["svd-edm", "sdxl-default"])
def test_euler_scheduler_matches_jax(svd):
    jcfg = jsched.SVD_EULER_CONFIG if svd else jsched.EulerDiscreteConfig()
    tcfg = tsched.SVD_EULER_CONFIG if svd else tsched.EulerDiscreteConfig()
    js = jsched.EulerDiscreteScheduler(jcfg).set_timesteps(25)
    ts = tsched.EulerDiscreteScheduler(tcfg).set_timesteps(25)
    np.testing.assert_array_equal(ts.sigmas.numpy(), np.asarray(js.sigmas))
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    assert float(ts.init_noise_sigma) == float(js.init_noise_sigma)
    rng = np.random.default_rng(10)
    x, out = _np(rng, 1, 3, 4, 4, 4, scale=80.0), _np(rng, 1, 3, 4, 4, 4)
    for i in (0, 12, 24):
        want = jsched.EulerDiscreteScheduler.scale_model_input(js, jnp.asarray(x), i)
        got = tsched.EulerDiscreteScheduler.scale_model_input(ts, torch.from_numpy(x), i)
        assert_close(got.numpy(), want, atol=1e-6, rtol=1e-6, what="scale_model_input")
        want = jsched.EulerDiscreteScheduler.step(js, jnp.asarray(out), i, jnp.asarray(x))
        got = tsched.EulerDiscreteScheduler.step(ts, torch.from_numpy(out), i,
                                                 torch.from_numpy(x))
        assert_close(got.numpy(), want, atol=1e-4, rtol=1e-6, what="step")


# --------------------------------------------------------------- the bridge
def test_bridge_is_strict():
    rng = np.random.default_rng(11)
    x, temb = _np(rng, 1, 4, 4, 32), _np(rng, 1, 16)
    params = fake_init(JResnet(in_channels=32, out_channels=32, temb_channels=16),
                       jnp.asarray(x), jnp.asarray(temb))["params"]
    module = ResnetBlock2D(32, 32, 16)
    assert set(state_dict_from_jax(module, params)) == set(module.state_dict())
    missing = {k: v for k, v in params.items() if k != "conv2"}
    with pytest.raises(KeyError, match="conv2"):
        state_dict_from_jax(module, missing)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_jax(module, extra)


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ctrl_adapter_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 25, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ctrl_adapter_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
