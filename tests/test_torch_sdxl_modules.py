"""The SDXL modules of the PyTorch port against the JAX package, fp32 on the CPU.

Each test fabricates a JAX param tree (``tests/utils.py:fake_init``), loads it
into the port module through ``convert/from_jax.py`` (strict: every leaf used
once, every parameter filled) and feeds both sides the same seeded numpy
inputs, NHWC to the JAX module and NCHW to the port. The thin UNet is
``tests/test_unet2d_vae.py:TINY_SDXL``; the adapter is the golden SDXL test's
(``tests/test_golden_regression.py:_generate``). Tolerance: 1e-4 absolute
(fp32 summation order only); the Euler timesteps exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter
from ctrl_adapter_tpu.models.unet_2d import UNet2DConditionModel as JUNet
from ctrl_adapter_tpu.nn import attention as jattn
from ctrl_adapter_tpu.nn import embeddings as jemb
from ctrl_adapter_tpu.nn import resnet as jresnet
from ctrl_adapter_tpu.nn import unet_blocks as jblocks
from ctrl_adapter_tpu.pipelines import common as jcommon
from ctrl_adapter_tpu.schedulers.euler_discrete import EulerDiscreteConfig as JEulerConfig
from ctrl_adapter_tpu.schedulers.euler_discrete import EulerDiscreteScheduler as JEuler
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.unet_2d import UNet2DConditionModel, UNet2DConfig
from ctrl_adapter_tpu_torch.nn import attention as tattn
from ctrl_adapter_tpu_torch.nn import embeddings as temb
from ctrl_adapter_tpu_torch.nn import resnet as tresnet
from ctrl_adapter_tpu_torch.nn import unet_blocks as tblocks
from ctrl_adapter_tpu_torch.pipelines import common as tcommon
from ctrl_adapter_tpu_torch.schedulers.euler_discrete import (EulerDiscreteConfig,
                                                              EulerDiscreteScheduler)

from .test_unet2d_vae import TINY_SDXL
from .torch_port_common import assert_close, nchw_to_nhwc, nhwc_to_nchw, port, port_config
from .utils import fake_init

TOL = 1e-4


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("layers", [1, 2])
def test_transformer_2d_linear_projection_matches_jax(layers):
    rng = np.random.default_rng(10 + layers)
    x, ctx = _np(rng, 2, 4, 4, 32), _np(rng, 2, 7, 16)
    jmod = jblocks.Transformer2DModel(2, 16, 32, num_layers=layers, cross_attention_dim=16,
                                      use_linear_projection=True, norm_num_groups=16)
    params = fake_init(jmod, jnp.asarray(x), jnp.asarray(ctx), seed=layers, scale=0.1)
    want = jax.jit(jmod.apply)(params, x, ctx)
    tmod = port(tblocks.Transformer2DModel(2, 16, 32, layers, 16, 16,
                                           use_linear_projection=True), params)
    assert tmod.proj_in.weight.shape == (32, 32) and isinstance(tmod.proj_in, torch.nn.Linear)
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x), _t(ctx))
    assert_close(nchw_to_nhwc(got), want, atol=TOL, what=f"Transformer2DModel x{layers}")


@pytest.mark.parametrize("cross", [False, True], ids=["UpBlock2D", "CrossAttnUpBlock2D"])
def test_up_blocks_match_jax(cross):
    """in 32, prev 64, out 32, 3 resnets, upsampled: the skips are taken last
    first and concatenated after the hidden state along the channels."""
    rng = np.random.default_rng(20 + cross)
    x, temb_, ctx = _np(rng, 2, 4, 4, 64), _np(rng, 2, 64), _np(rng, 2, 7, 16)
    skips = [_np(rng, 2, 4, 4, 32) for _ in range(3)]
    if cross:
        jmod = jblocks.CrossAttnUpBlock2D(32, 64, 32, num_layers=3, num_attention_heads=2,
                                          cross_attention_dim=16, resnet_groups=16,
                                          use_linear_projection=True)
        args = (jnp.asarray(x), [jnp.asarray(s) for s in skips], jnp.asarray(temb_),
                jnp.asarray(ctx))
        tmod = tblocks.CrossAttnUpBlock2D(32, 64, 32, 64, 3, 1, 2, 16, resnet_groups=16,
                                          use_linear_projection=True)
    else:
        jmod = jblocks.UpBlock2D(32, 64, 32, num_layers=3, resnet_groups=16)
        args = (jnp.asarray(x), [jnp.asarray(s) for s in skips], jnp.asarray(temb_))
        tmod = tblocks.UpBlock2D(32, 64, 32, 64, 3, resnet_groups=16)
    params = fake_init(jmod, *args, seed=3, scale=0.1)
    want = jax.jit(jmod.apply)(params, *args)
    tmod = port(tmod, params)
    targs = [nhwc_to_nchw(x), [nhwc_to_nchw(s) for s in skips], _t(temb_)]
    with torch.no_grad():
        got = tmod(*targs, *([_t(ctx)] if cross else []))
    assert got.shape == (2, 32, 8, 8)
    assert_close(nchw_to_nhwc(got), want, atol=TOL, what="up block")


@pytest.mark.parametrize("output_size", [None, (7, 10)], ids=["x2", "explicit"])
def test_resnet_up_with_output_size_matches_jax(output_size):
    rng = np.random.default_rng(30)
    x, temb_ = _np(rng, 2, 4, 5, 32), _np(rng, 2, 32)
    jmod = jresnet.ResnetBlock2D(32, 32, 32, use_in_shortcut=True, up=True)
    params = fake_init(jmod, jnp.asarray(x), jnp.asarray(temb_), output_size=output_size,
                       seed=4, scale=0.1)
    want = jax.jit(lambda p, a, t: jmod.apply(p, a, t, output_size=output_size))(params, x,
                                                                                temb_)
    tmod = port(tresnet.ResnetBlock2D(32, 32, 32, use_in_shortcut=True, up=True), params)
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x), _t(temb_), output_size)
    assert got.shape[-2:] == (output_size or (8, 10))
    assert_close(nchw_to_nhwc(got), want, atol=TOL, what="ResnetBlock2D(up=True)")


# --------------------------------------------------------------- embeddings
def test_cond_proj_lcm_matches_jax():
    rng = np.random.default_rng(40)
    sample, cond = _np(rng, 3, 32), _np(rng, 3, 8)
    jmod = jemb.TimestepEmbedding(64, use_cond_proj=True)
    params = fake_init(jmod, jnp.asarray(sample), jnp.asarray(cond), seed=5, scale=0.2)
    want = jax.jit(jmod.apply)(params, sample, cond)
    tmod = port(temb.TimestepEmbedding(32, 64, cond_proj_dim=8), params)
    assert tmod.cond_proj.bias is None
    with torch.no_grad():
        got = tmod(_t(sample), _t(cond))
    assert_close(got.numpy(), want, atol=TOL, what="TimestepEmbedding cond_proj")


def test_image_projection_matches_jax():
    rng = np.random.default_rng(41)
    embeds = _np(rng, 2, 24)
    jmod = jemb.MultiIPAdapterImageProjection(cross_attention_dim=32, num_image_text_embeds=4)
    params = fake_init(jmod, jnp.asarray(embeds), seed=6, scale=0.2)
    want = jax.jit(jmod.apply)(params, embeds)
    tmod = port(temb.MultiIPAdapterImageProjection(24, 32, 4), params)
    assert {"image_projection_layers.0.image_embeds.weight",
            "image_projection_layers.0.norm.weight"} <= set(tmod.state_dict())
    with torch.no_grad():
        got = tmod(_t(embeds))
    assert got.shape == (2, 4, 32)
    assert_close(got.numpy(), want, atol=TOL, what="ImageProjection")


def test_ip_attention_branch_matches_jax():
    """The IP-Adapter branch of a cross-attention: the image tokens through
    ``processor.to_{k,v}_ip.0`` with the same queries, times ip_scale."""
    rng = np.random.default_rng(42)
    x, ctx, ip = _np(rng, 2, 64, 32), _np(rng, 2, 7, 24), _np(rng, 2, 4, 24)
    jmod = jattn.Attention(query_dim=32, heads=2, dim_head=16, cross_attention_dim=24)
    params = fake_init(jmod, jnp.asarray(x), jnp.asarray(ctx), ip_hidden_states=jnp.asarray(ip),
                       seed=7, scale=0.2)
    want = jax.jit(lambda p, a, c, i: jmod.apply(p, a, c, ip_hidden_states=i, ip_scale=0.7))(
        params, x, ctx, ip)
    without = jax.jit(jmod.apply)(params, x, ctx)
    tmod = port(tattn.Attention(32, 2, 16, 24, ip_adapter=True), params)
    assert {"processor.to_k_ip.0.weight", "processor.to_v_ip.0.weight"} <= set(
        tmod.state_dict())
    with torch.no_grad():
        got = tmod(_t(x), _t(ctx), _t(ip), 0.7)
    assert_close(got.numpy(), want, atol=TOL, what="IP attention")
    assert np.abs(np.asarray(want) - np.asarray(without)).max() > 1e-3  # the branch counts


# -------------------------------------------------------------------- UNet
def _tiny_unet_inputs(rng):
    return (_np(rng, 2, 16, 16, 4), np.asarray([500.0, 320.0], np.float32),
            _np(rng, 2, 7, 16), {"text_embeds": _np(rng, 2, 32),
                                 "time_ids": np.asarray([[1024, 1024, 0, 0, 1024, 1024]] * 2,
                                                        np.float32)})


# the 9 skips of TINY_SDXL at 16x16 (NHWC), then 3 residuals the zip ignores
TINY_SKIPS = [(16, 32)] * 3 + [(8, 32), (8, 64), (8, 64), (4, 64), (4, 64), (4, 64)]


@pytest.mark.parametrize("residuals", [False, True], ids=["plain", "12 residuals + 0-d mid"])
def test_sdxl_unet_matches_jax(residuals):
    rng = np.random.default_rng(50)
    sample, t, ehs, added = _tiny_unet_inputs(rng)
    jmod = JUNet(config=TINY_SDXL)
    jadded = {k: jnp.asarray(v) for k, v in added.items()}
    params = fake_init(jmod, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ehs), jadded,
                       seed=8, scale=0.05)
    down = mid = None
    if residuals:
        down = [_np(rng, 2, s, s, c, scale=0.5) for s, c in TINY_SKIPS]
        down += [_np(rng, 2, 2, 2, 64) for _ in range(3)]
        mid = np.zeros((), np.float32)
    want = jax.jit(lambda p, *a, d, m: jmod.apply(
        p, *a, down_block_additional_residuals=d, mid_block_additional_residual=m))(
        params, sample, t, ehs, jadded, d=down, m=mid)
    tmod = port(UNet2DConditionModel(port_config(UNet2DConfig, TINY_SDXL)), params)
    tadded = {k: _t(v) for k, v in added.items()}
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(sample), _t(t), _t(ehs), tadded,
                   down_block_additional_residuals=(None if down is None
                                                    else [nhwc_to_nchw(d) for d in down]),
                   mid_block_additional_residual=None if mid is None else _t(mid))
    assert_close(nchw_to_nhwc(got), want, atol=TOL, what="SDXL UNet")
    if residuals:  # the zip: the 3 extra residuals change nothing
        with torch.no_grad():
            first9 = tmod(nhwc_to_nchw(sample), _t(t), _t(ehs), tadded,
                          down_block_additional_residuals=[nhwc_to_nchw(d) for d in down[:9]])
        assert torch.equal(first9, got)


# ----------------------------------------------------------------- adapter
CNET_SKIPS = [(8, 32)] * 3 + [(4, 32), (4, 64), (4, 64), (2, 64), (2, 64), (2, 64),
                              (1, 64), (1, 64), (1, 64)]


def _sdxl_adapters(resnets, **extra):
    common = dict(num_blocks=1, num_adapters_per_location=3, cross_attention_dim=32,
                  adapter_locations=("A", "B", "C"), add_spatial_resnet=resnets,
                  add_temporal_resnet=False, add_temporal_transformer=False,
                  custom_down_block_channels=(32, 32, 32, 32, 64, 64, 64, 64, 64),
                  attention_head_dim=16)
    return (JAdapter(backbone_model_name="sdxl", **common, **extra),
            ControlNetAdapter(backbone_model_name="sdxl", **common, **extra))


@pytest.mark.parametrize("resnets", [True, False], ids=["resnet up", "bare resize"])
def test_sdxl_adapter_matches_jax(resnets):
    """x2 upsample in every block (in its ResNet, or a bare nearest resize
    without one); the unadapted slots 9-11 are zeros of twice their size."""
    rng = np.random.default_rng(60 + resnets)
    downs = [_np(rng, 2, s, s, c) for s, c in CNET_SKIPS]
    t, ehs = np.asarray([951.0, 951.0], np.float32), _np(rng, 2, 7, 32)
    jmod, tmod = _sdxl_adapters(resnets)
    params = fake_init(jmod, [jnp.asarray(d) for d in downs], None, 1, jnp.asarray(t),
                       jnp.asarray(ehs), seed=9, scale=0.1)
    want, _ = jax.jit(lambda p, d, tt, e: jmod.apply(p, d, None, 1, tt, e))(params, downs, t,
                                                                            ehs)
    tmod = port(tmod, params)
    with torch.no_grad():
        got, mid = tmod([nhwc_to_nchw(d) for d in downs], None, 1, _t(t), _t(ehs))
    assert mid is None and len(got) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[-1] == 2 * CNET_SKIPS[i][0]
        assert_close(nchw_to_nhwc(g), w, atol=TOL, what=f"adapter slot {i}")
    assert all(not g.any() for g in got[9:])


def test_num_repeats_aggregation_matches_jax():
    """num_repeats=2: each repeat's outputs summed through the zero_convs
    (random here, so the sum is not zero), as ``tests/test_extras.py``'s config."""
    rng = np.random.default_rng(70)
    cfg = dict(num_blocks=1, num_adapters_per_location=3, cross_attention_dim=16,
               adapter_locations=("A",), add_temporal_resnet=False,
               add_temporal_transformer=False, custom_down_block_channels=(32, 32, 32),
               attention_head_dim=16, num_repeats=2, out_channels=32)
    downs = [_np(rng, 2, 4, 4, 32) for _ in range(12)]
    t, ehs = np.asarray([3.0], np.float32), _np(rng, 1, 1, 16)
    jmod = JAdapter(backbone_model_name="i2vgenxl", **cfg)
    params = fake_init(jmod, [jnp.asarray(d) for d in downs], None, 2, jnp.asarray(t),
                       jnp.asarray(ehs), seed=11, scale=0.1)
    want, wmid = jax.jit(lambda p, d, tt, e: jmod.apply(p, d, None, 2, tt, e))(params, downs,
                                                                               t, ehs)
    tmod = port(ControlNetAdapter(**cfg), params)
    assert len(tmod.down_blocks_adapter) == 6 and len(tmod.zero_convs) == 6
    with torch.no_grad():
        got, mid = tmod([nhwc_to_nchw(d) for d in downs], None, 2, _t(t), _t(ehs))
    assert mid is None and wmid is None and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_close(nchw_to_nhwc(g), w, atol=TOL, what="aggregated repeat")
    fresh = ControlNetAdapter(**cfg)
    with torch.no_grad():  # zero-initialised, as the JAX convs: a fresh adapter adds 0
        out, _ = fresh([nhwc_to_nchw(d) for d in downs], None, 2, _t(t), _t(ehs))
    assert all(not o.any() for o in out)


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_rescaled_cfg_matches_jax(rescale):
    rng = np.random.default_rng(80)
    pred = _np(rng, 4, 4, 8, 8)
    want = jcommon.classifier_free_guidance_rescaled(jnp.asarray(pred), 7.5, rescale)
    got = tcommon.classifier_free_guidance_rescaled(_t(pred), 7.5, rescale)
    assert_close(got.numpy(), want, atol=TOL, what="rescaled CFG")


@pytest.mark.parametrize("dim", [8, 9], ids=["even", "odd"])
def test_guidance_scale_embedding_matches_jax(dim):
    w = np.asarray([0.5, 6.5, 7.0], np.float32)
    want = jcommon.guidance_scale_embedding(jnp.asarray(w), dim)
    got = tcommon.guidance_scale_embedding(_t(w), dim)
    assert got.shape == (3, dim)
    assert_close(got.numpy(), want, atol=TOL, what="guidance embedding")


def test_sdxl_add_time_ids_match_jax():
    want = jcommon.sdxl_add_time_ids((768, 1024), (16, 8), (1024, 1024), 3)
    got = tcommon.sdxl_add_time_ids((768, 1024), (16, 8), (1024, 1024), 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("steps", [50, 30, 3])
def test_stock_euler_matches_jax(steps):
    """SDXL's scheduler: leading spacing, epsilon prediction."""
    jsched, tsched = JEuler(JEulerConfig()), EulerDiscreteScheduler(EulerDiscreteConfig())
    js, ts = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ts.sigmas.numpy(), np.asarray(js.sigmas))
    assert float(ts.init_noise_sigma) == float(js.init_noise_sigma)
    rng = np.random.default_rng(90 + steps)
    x, eps = _np(rng, 1, 4, 8, 8), _np(rng, 1, 4, 8, 8)
    for i in (0, steps // 2, steps - 1):
        want = JEuler.step(js, jnp.asarray(eps), i, jnp.asarray(x))
        got = EulerDiscreteScheduler.step(ts, _t(eps), i, _t(x))
        assert_close(got.numpy(), want, atol=1e-5, what=f"Euler step {i}")
        want = JEuler.scale_model_input(js, jnp.asarray(x), i)
        got = EulerDiscreteScheduler.scale_model_input(ts, _t(x), i)
        assert_close(got.numpy(), want, atol=1e-6, what=f"Euler input scale {i}")
