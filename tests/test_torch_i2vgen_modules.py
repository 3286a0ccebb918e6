"""The I2VGen-XL modules of the PyTorch port against the JAX package, fp32 on the CPU.

Each test fabricates a JAX param tree (``tests/utils.py:fake_init``), loads it
into the port module through ``convert/from_jax.py`` (strict: every leaf used
once, every parameter filled) and feeds both sides the same numpy inputs, NHWC
to the JAX module and NCHW / NCFHW to the port. The thin configs are those of
``tests/test_video_pipelines.py`` and ``tests/test_golden_regression.py``.

Tolerances: 5e-5 absolute on the blocks and the UNet (fp32 summation order
only, through tens of blocks in the UNet), 1e-4 on the 2D VAE decode; the
DDIM timesteps exactly, its updates to 1e-5 relative; the router input and
weights to 1e-4 (XLA's and torch's fp32 sine of a timestep near 500 differ
by up to 3e-5, one ulp of the argument; without a timestep they agree to
1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models import router as jrouter
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLTransformerTemporalEncoder as JEncoder
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLUNet as JUNet
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLUNetConfig as JUNetConfig
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.nn import unet_3d_blocks as j3d
from ctrl_adapter_tpu.pipelines.common import classifier_free_guidance as jcfg
from ctrl_adapter_tpu.pipelines.image_latents import encode_first_frame_latent as jencode
from ctrl_adapter_tpu.schedulers import ddim as jddim
from ctrl_adapter_tpu_torch.models import router as trouter
from ctrl_adapter_tpu_torch.models.unet_i2vgen import (I2VGenXLTransformerTemporalEncoder,
                                                       I2VGenXLUNet, I2VGenXLUNetConfig)
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.nn import unet_3d_blocks as t3d
from ctrl_adapter_tpu_torch.pipelines.common import classifier_free_guidance
from ctrl_adapter_tpu_torch.pipelines.image_latents import encode_first_frame_latent
from ctrl_adapter_tpu_torch.schedulers import ddim as tddim

from .torch_port_common import assert_close, nchw_to_nhwc, nhwc_to_nchw, port
from .utils import fake_init

THIN_UNET = dict(block_out_channels=(32, 32, 64, 64), norm_num_groups=16,
                 cross_attention_dim=32, attention_head_dim=16)
# skip tensors of THIN_UNET at 8x8 latents: (channels, size)
THIN_SKIPS = [(32, 8)] * 3 + [(32, 4)] * 3 + [(32, 2)] + [(64, 2)] * 2 + [(64, 1)] * 3
THIN_VAE = dict(block_out_channels=(16, 16, 16, 16), norm_num_groups=8, layers_per_block=1)
F, HW = 4, 8


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _video(x):
    """(b, f, h, w, c) numpy -> (b, f, c, h, w) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 1, 4, 2, 3)))


# ------------------------------------------------------------------ 3D blocks
def test_temporal_conv_layer_matches_jax():
    rng = np.random.default_rng(0)
    x = _np(rng, 2 * F, 4, 4, 32)
    jmod = j3d.TemporalConvLayer(32, 32, norm_num_groups=16)
    params = fake_init(jmod, jnp.asarray(x), F, seed=1, scale=0.1)
    want = jax.jit(lambda p, a: jmod.apply(p, a, F))(params, x)
    tmod = port(t3d.TemporalConvLayer(32, 32, 16), params)
    assert {"conv1.0.weight", "conv1.2.weight", "conv4.0.bias", "conv4.3.weight"} <= set(
        tmod.state_dict())
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x), F)
    assert_close(nchw_to_nhwc(got), want, atol=5e-5, what="TemporalConvLayer")
    fresh = t3d.TemporalConvLayer(32, 32, 16)
    with torch.no_grad():  # the zero-initialised last conv: a fresh layer is the identity
        assert torch.equal(fresh(nhwc_to_nchw(x), F), nhwc_to_nchw(x))


@pytest.mark.parametrize("heads,head_dim,c", [(2, 16, 32), (8, 16, 32)],
                         ids=["inner=c", "inner!=c"])
def test_transformer_temporal_model_matches_jax(heads, head_dim, c):
    rng = np.random.default_rng(2)
    x = _np(rng, 2 * F, 4, 4, c)
    jmod = j3d.TransformerTemporalModel(heads, head_dim, c, norm_num_groups=16)
    params = fake_init(jmod, jnp.asarray(x), F, seed=3, scale=0.1)
    want = jax.jit(lambda p, a: jmod.apply(p, a, F))(params, x)
    tmod = port(t3d.TransformerTemporalModel(heads, head_dim, c, norm_num_groups=16), params)
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x), F)
    assert_close(nchw_to_nhwc(got), want, atol=5e-5, what="TransformerTemporalModel")


def _block_cases():
    """(name, JAX block, port block, input channels, whether an up block)."""
    kw = dict(resnet_groups=16)
    attn = dict(num_attention_heads=16, cross_attention_dim=32)
    return [
        ("down", j3d.DownBlock3D(32, 64, **kw), t3d.DownBlock3D(32, 64, 64, **kw), 32, False),
        ("cross-down", j3d.CrossAttnDownBlock3D(32, 64, **attn, **kw),
         t3d.CrossAttnDownBlock3D(32, 64, 64, **attn, **kw), 32, False),
        ("mid", j3d.UNetMidBlock3DCrossAttn(64, **attn, **kw),
         t3d.UNetMidBlock3DCrossAttn(64, 64, **attn, **kw), 64, False),
        ("up", j3d.UpBlock3D(32, 64, 32, **kw), t3d.UpBlock3D(32, 64, 32, 64, **kw), 64, True),
        ("cross-up", j3d.CrossAttnUpBlock3D(32, 64, 32, **attn, **kw),
         t3d.CrossAttnUpBlock3D(32, 64, 32, 64, **attn, **kw), 64, True),
    ]


@pytest.mark.parametrize("case", range(5), ids=["down", "cross-down", "mid", "up", "cross-up"])
def test_3d_blocks_match_jax(case):
    name, jmod, tmod, cin, up = _block_cases()[case]
    rng = np.random.default_rng(4 + case)
    n = 2 * F
    x, temb, ctx = _np(rng, n, 4, 4, cin), _np(rng, n, 64), _np(rng, n, 7, 32)
    # an up block's skips, last first: out 32 x2, then the block's in_channels 32
    skips = [_np(rng, n, 4, 4, 32) for _ in range(3)]
    cross = "cross" in name or name == "mid"
    if up:
        args = (x, skips, temb) + ((ctx,) if cross else ())
    else:
        args = (x, temb) + ((ctx,) if cross else ())
    jargs = tuple([jnp.asarray(s) for s in a] if isinstance(a, list) else jnp.asarray(a)
                  for a in args)
    params = fake_init(jmod, *jargs, F, seed=10 + case, scale=0.1)
    want = jax.jit(lambda p, *a: jmod.apply(p, *a, F))(params, *jargs)
    tmod = port(tmod, params)
    targs = tuple([nhwc_to_nchw(s) for s in a] if isinstance(a, list)
                  else nhwc_to_nchw(a) if a.ndim == 4 else torch.from_numpy(a) for a in args)
    with torch.no_grad():
        got = tmod(*targs, F)
    if up or name == "mid":
        assert_close(nchw_to_nhwc(got), want, atol=5e-5, what=name)
    else:
        assert_close(nchw_to_nhwc(got[0]), want[0], atol=5e-5, what=name)
        assert len(got[1]) == len(want[1])
        for k, (g, w) in enumerate(zip(got[1], want[1])):
            assert_close(nchw_to_nhwc(g), w, atol=5e-5, what=f"{name} output state {k}")


def test_image_latent_temporal_encoder_matches_jax():
    """Exact (erf) gelu in its feed-forward, also in bf16 (the JAX ``_GELUProj``
    ignores the dtype and ``CTRL_ADAPTER_EXACT_GELU``)."""
    rng = np.random.default_rng(20)
    x = _np(rng, 2 * HW * HW, F, 4)
    jmod = JEncoder(dim=4, num_attention_heads=2, attention_head_dim=4, ff_inner_dim=16)
    params = fake_init(jmod, jnp.asarray(x), seed=21, scale=0.5)
    want = jax.jit(jmod.apply)(params, x)
    tmod = port(I2VGenXLTransformerTemporalEncoder(4, 2, 4, 16), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
        proj = tmod.ff.net[0].proj
        h = torch.from_numpy(x).to(torch.bfloat16)
        bf = tmod.ff.net[0].to(torch.bfloat16)(h)
        erf = torch.nn.functional.gelu(proj(h), approximate="none")
    assert_close(got.numpy(), want, atol=5e-5, what="image-latent temporal encoder")
    assert torch.equal(bf, erf)


# ---------------------------------------------------------------------- UNet
def _unet_inputs(rng):
    b = 2
    return dict(sample=_np(rng, b, F, HW, HW, 4), t=np.array([981.0, 981.0], np.float32),
                fps=np.array([16.0, 16.0], np.float32), il=_np(rng, b, F, HW, HW, 4),
                emb=_np(rng, b, 1, 32, scale=0.5), text=_np(rng, b, 7, 32, scale=0.5))


@pytest.mark.parametrize("residuals", [False, True], ids=["plain", "with-residuals"])
def test_i2vgenxl_unet_matches_jax(residuals):
    rng = np.random.default_rng(30)
    a = _unet_inputs(rng)
    b = a["sample"].shape[0]
    res = [_np(rng, b * F, s, s, c, scale=0.1) for c, s in THIN_SKIPS] if residuals else None
    mid = _np(rng, b * F, 1, 1, 64, scale=0.1) if residuals else None
    jmod = JUNet(config=JUNetConfig(**THIN_UNET))
    args = tuple(jnp.asarray(a[k]) for k in ("sample", "t", "fps", "il", "emb", "text"))
    params = fake_init(jmod, *args, seed=31, scale=0.05)
    want = jax.jit(lambda p, *x: jmod.apply(p, *x[:6], down_block_additional_residuals=x[6],
                                            mid_block_additional_residual=x[7]))(
        params, *args, res, mid)
    tmod = port(I2VGenXLUNet(I2VGenXLUNetConfig(**THIN_UNET)), params)
    with torch.no_grad():
        got = tmod(_video(a["sample"]), torch.from_numpy(a["t"]), torch.from_numpy(a["fps"]),
                   _video(a["il"]), torch.from_numpy(a["emb"]), torch.from_numpy(a["text"]),
                   None if res is None else [nhwc_to_nchw(r) for r in res],
                   None if mid is None else nhwc_to_nchw(mid))
    assert_close(got.numpy().transpose(0, 1, 3, 4, 2), want, atol=5e-5, what="I2VGen-XL UNet")


# ------------------------------------------------------------------- 2D VAE
@pytest.mark.parametrize("layers", [1, 2], ids=["1-layer", "2-layer"])
def test_vae_decode_matches_jax(layers):
    rng = np.random.default_rng(40)
    cfg = dict(THIN_VAE, layers_per_block=layers)
    z = _np(rng, 2, 8, 8, 4)
    jmod = JVAE(config=JVAEConfig(**cfg))
    params = fake_init(jmod, jnp.ones((1, 64, 64, 3)), seed=41, scale=0.05)
    want = jax.jit(lambda p, zz: jmod.apply(p, zz, method="decode"))(params, z)
    tmod = port(AutoencoderKL(VAEConfig(**cfg)), params)
    with torch.no_grad():
        got = tmod.decode(nhwc_to_nchw(z))
    assert got.shape == (2, 3, 64, 64)
    assert_close(nchw_to_nhwc(got), want, atol=1e-4, what="AutoencoderKL.decode")


def test_encode_first_frame_latent_matches_jax():
    """The sampled latent with JAX's own noise draw passed to the port."""
    rng = np.random.default_rng(42)
    image = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jmod = JVAE(config=JVAEConfig(**THIN_VAE))
    params = fake_init(jmod, jnp.ones((1, 64, 64, 3)), seed=43, scale=0.05)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, x: jencode(jmod, p, x, key))(params, image)
    noise = np.array(jax.random.normal(key, want.shape, jnp.float32))
    tmod = port(AutoencoderKL(VAEConfig(**THIN_VAE)), params)
    with torch.no_grad():
        got = encode_first_frame_latent(tmod, torch.from_numpy(image),
                                        noise=torch.from_numpy(noise))
        drawn = encode_first_frame_latent(tmod, torch.from_numpy(image[0]),
                                          torch.Generator().manual_seed(0))
    assert_close(got.numpy(), want, atol=5e-5, what="encode_first_frame_latent")
    assert drawn.shape == (1, 8, 8, 4) and torch.isfinite(drawn).all()


def test_classifier_free_guidance_matches_jax():
    rng = np.random.default_rng(44)
    x = _np(rng, 4, 3, 5)
    assert_close(classifier_free_guidance(torch.from_numpy(x), 9.0).numpy(),
                 jcfg(jnp.asarray(x), 9.0), atol=1e-6, what="CFG")


# ---------------------------------------------------------------------- DDIM
@pytest.mark.parametrize("spacing,steps", [("leading", 50), ("leading", 4), ("trailing", 25)])
def test_ddim_timesteps_match_jax(spacing, steps):
    js = jddim.DDIMScheduler(jddim.DDIMConfig(timestep_spacing=spacing)).set_timesteps(steps)
    ts = tddim.DDIMScheduler(tddim.DDIMConfig(timestep_spacing=spacing)).set_timesteps(steps)
    assert ts.timesteps.dtype == torch.int64 and ts.timesteps.device.type == "cpu"
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddim_step_matches_jax(prediction):
    jsch = jddim.DDIMScheduler(jddim.DDIMConfig(prediction_type=prediction))
    tsch = tddim.DDIMScheduler(tddim.DDIMConfig(prediction_type=prediction))
    js, ts = jsch.set_timesteps(4), tsch.set_timesteps(4)
    rng = np.random.default_rng(50)
    x, out = _np(rng, 1, 3, 4, 4, 4), _np(rng, 1, 3, 4, 4, 4)
    for i in range(4):  # the last step reads final_alpha_cumprod
        want = jddim.DDIMScheduler.step(js, jnp.asarray(out), i, jnp.asarray(x))
        got = tddim.DDIMScheduler.step(ts, torch.from_numpy(out), i, torch.from_numpy(x))
        assert got.dtype == torch.float32
        assert_close(got.numpy(), want, atol=1e-5, rtol=1e-5, what=f"step {i}")


def test_ddim_add_noise_and_velocity_match_jax():
    jsch, tsch = jddim.DDIMScheduler(), tddim.DDIMScheduler()
    rng = np.random.default_rng(51)
    x0, noise = _np(rng, 3, 2, 4, 4, 4), _np(rng, 3, 2, 4, 4, 4)
    t = np.array([0, 500, 999], np.int64)
    for name in ("add_noise", "get_velocity"):
        want = getattr(jsch, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        got = getattr(tsch, name)(torch.from_numpy(x0), torch.from_numpy(noise),
                                  torch.from_numpy(t))
        assert_close(got.numpy(), want, atol=1e-6, rtol=1e-6, what=name)


# -------------------------------------------------------------------- router
ROUTER_DIMS = {"equal_weights": None, "simple_weights": None, "timestep_weights": 256,
               "embedding_weights": 32, "timestep_embedding_weights": 288}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "sparse-mask"])
@pytest.mark.parametrize("router_type", list(ROUTER_DIMS))
def test_router_matches_jax(router_type, masked):
    rng = np.random.default_rng(60)
    ehs = _np(rng, 2, 3, 32)  # batch 2: a conditional router averages over it
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    jmod = jrouter.ControlNetRouter(num_experts=3, router_type=router_type)
    jin = jrouter.build_router_input(router_type, jnp.asarray([481.0]), jnp.asarray(ehs))
    tin = trouter.build_router_input(router_type, torch.tensor([481.0]), torch.from_numpy(ehs))
    if jin is None:
        assert tin is None
    else:
        assert_close(tin.numpy(), jin, atol=1e-4, what="router input")
        jin = jnp.stack([jin, jin + 0.5])  # (B, D): batch-averaged inside
        tin = torch.stack([tin, tin + 0.5])
    jargs = (jin, None if mask is None else jnp.asarray(mask))
    tmod = trouter.ControlNetRouter(3, router_type, embedding_dim=ROUTER_DIMS[router_type])
    if router_type == "equal_weights":
        params = {}
        assert not list(tmod.parameters())
    else:
        params = fake_init(jmod, *jargs, seed=61, scale=0.5)
        port(tmod, params)
        names = {n for n, _ in tmod.named_parameters()}
        assert {"down_blocks_router.11.wg.weight", "mid_block_router.wg.weight"} <= names
    want = jmod.apply(params, *jargs)
    with torch.no_grad():
        got = tmod(tin, None if mask is None else torch.from_numpy(mask))
    for g, w, what in zip(got, want, ("down", "mid")):
        assert_close(g.numpy(), w, atol=1e-4 if "timestep" in router_type else 1e-6,
                     what=f"{router_type} {what} weights")
    if masked:
        assert (got[0][:, 1] == 0).all() and got[1][1] == 0


@pytest.mark.parametrize("router_type", [t for t in ROUTER_DIMS if t != "equal_weights"])
def test_router_weights_stay_on_the_embeddings_device(router_type):
    """The pipeline's router step on the ``meta`` device: a number as the
    timestep and the CLIP embedding on the device give the router's input
    and weights on that device (a copy to the host, which would stall the
    card every step, raises on ``meta``)."""
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline

    meta = torch.device("meta")
    ehs = torch.empty(1, 1, 32, device=meta)
    if router_type in trouter.CONDITIONAL_TYPES:
        x = trouter.build_router_input(router_type, 481.0, ehs)
        assert x.device == meta and x.shape == (ROUTER_DIMS[router_type],)
    pipe = object.__new__(I2VGenXLControlNetAdapterPipeline)
    pipe.router = trouter.ControlNetRouter(3, router_type, embedding_dim=ROUTER_DIMS[router_type],
                                           device=meta)
    down, mid = pipe._router_weights(481.0, ehs, torch.ones(3, device=meta),
                                     torch.arange(2, device=meta))
    assert down.device == meta and down.shape == (12, 2) and mid.shape == (2,)


@pytest.mark.parametrize("value,dtype", [(481, torch.int64), (481.0, torch.float32),
                                         (np.float64(0.5), torch.float32)])
def test_timestep_tensor_is_filled_in_on_the_device(value, dtype):
    """A Python int or float (``np.float64`` too) becomes a 0-d int64 or
    float32 tensor filled in on the device; tensors and arrays go through
    ``torch.as_tensor``."""
    from ctrl_adapter_tpu_torch.nn.embeddings import timestep_tensor

    got = timestep_tensor(value, torch.device("meta"))
    assert got.device.type == "meta" and got.shape == () and got.dtype == dtype
    assert timestep_tensor(value).item() == value
    t = torch.tensor([3.0, 4.0])
    assert timestep_tensor(t) is t
    assert timestep_tensor(np.array([1, 2])).tolist() == [1, 2]


def test_fuse_expert_residuals_matches_jax():
    rng = np.random.default_rng(62)
    downs = [[_np(rng, 2, 4, 3, 3) for _ in range(3)] for _ in range(2)]
    mids = [_np(rng, 2, 4, 1, 1) for _ in range(2)]
    dw, mw = rng.uniform(0, 1, (3, 2)).astype(np.float32), np.array([0.3, 0.7], np.float32)
    for weights in ((dw, mw), (None, None), (dw, None)):
        jw = tuple(None if w is None else jnp.asarray(w) for w in weights)
        tw = tuple(None if w is None else torch.from_numpy(w) for w in weights)
        want = jrouter.fuse_expert_residuals(
            [[jnp.asarray(r) for r in d] for d in downs], [jnp.asarray(m) for m in mids], *jw)
        got = trouter.fuse_expert_residuals(
            [[torch.from_numpy(r) for r in d] for d in downs],
            [torch.from_numpy(m) for m in mids], *tw)
        for g, w in zip(got[0], want[0]):
            assert_close(g.numpy(), w, atol=1e-6, what="fused down")
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert_close(got[1].numpy(), want[1], atol=1e-6, what="fused mid")
