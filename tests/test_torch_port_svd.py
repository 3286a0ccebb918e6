"""The SVD slice of the PyTorch port against the JAX package, fp32 on the CPU.

- One denoise step, ControlNet -> adapter -> UNet as ``__graft_entry__.py``
  builds it, at the thin configs of ``tests/test_video_pipelines.py``.
- ``generate()`` end to end at the thin SVD config of
  ``tests/test_golden_regression.py`` with the temporal-decoder VAE, two steps
  (one inside the control window, one outside) and ``latents=`` passed
  explicitly, since jax.random and torch generators draw different noise.

Weights move from the fabricated JAX trees through ``convert/from_jax.py``.
Tolerances: 5e-5 absolute on the denoise step (three towers of fp32 blocks);
1e-4 on the video, which runs two steps and the decoder.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.unet_svd import UNetSpatioTemporalConditionModel as JUNet
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JVAE
from ctrl_adapter_tpu.pipelines.svd import SVDControlNetAdapterPipeline as JPipeline
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.unet_svd import SVDUNetConfig
from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
from ctrl_adapter_tpu_torch.models.vae import VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

from .test_torch_port_modules import THIN_UNET, THIN_VAE
from .test_video_pipelines import CNET_CFG, THIN_CHANNELS, _adapter
from .torch_port_common import assert_close, nhwc_to_nchw, port
from .utils import fake_init

B, F, HW = 1, 4, 8


def _port_adapter():
    return ControlNetAdapter(
        num_blocks=1, num_adapters_per_location=3,
        cross_attention_dim=32, adapter_locations=("A", "B", "C", "D", "M"),
        add_temporal_resnet=True, add_temporal_transformer=True,
        custom_down_block_channels=THIN_CHANNELS, custom_mid_block_channels=64,
        attention_head_dim=16)


def _params(vae=None):
    """Fabricated JAX params for the thin towers (and optionally the VAE)."""
    unet, cnet, adapter = JUNet(config=THIN_UNET), JControlNet(config=CNET_CFG), _adapter()
    n = 2 * B * F
    params = {"unet": fake_init(unet, jnp.ones((2 * B, F, HW, HW, 8)), jnp.ones((2 * B,)),
                                jnp.ones((2 * B, 1, 32)), jnp.ones((2 * B, 3)))}
    cn_args = (jnp.ones((n, HW, HW, 4)), jnp.ones((n,)), jnp.ones((n, 7, 24)),
               jnp.ones((n, 64, 64, 3)))
    params["controlnet"] = fake_init(cnet, *cn_args, seed=1)
    downs_s, mid_s = jax.eval_shape(lambda: cnet.apply(params["controlnet"], *cn_args))
    params["adapter"] = fake_init(adapter, [jnp.zeros(s.shape) for s in downs_s],
                                  jnp.zeros(mid_s.shape), F, jnp.ones((n,)),
                                  jnp.ones((1, 1, 32)), seed=2)
    if vae is not None:
        params["vae"] = fake_init(vae, jnp.ones((1, 64, 64, 3)), seed=3)
    return unet, cnet, adapter, params


def _port_towers(params):
    unet = port(UNetSpatioTemporalConditionModel(SVDUNetConfig(**THIN_UNET.__dict__)),
                params["unet"])
    cnet = port(ControlNetModel(ControlNetConfig(
        block_out_channels=CNET_CFG.block_out_channels,
        num_attention_heads=CNET_CFG.num_attention_heads,
        cross_attention_dim=CNET_CFG.cross_attention_dim,
        conditioning_embedding_out_channels=CNET_CFG.conditioning_embedding_out_channels,
        norm_num_groups=CNET_CFG.norm_num_groups)), params["controlnet"])
    return unet, cnet, port(_port_adapter(), params["adapter"])


def test_denoise_step_matches_jax():
    """ControlNet (skip_conv_in) -> adapter -> UNet with residual injection."""
    unet, cnet, adapter, params = _params()
    rng = np.random.default_rng(0)
    sample8 = rng.standard_normal((B, F, HW, HW, 8)).astype(np.float32)
    emb = (rng.standard_normal((B, 1, 32)) * 0.5).astype(np.float32)
    tids = np.array([[6.0, 127.0, 0.02]], np.float32)
    cn_text = (rng.standard_normal((B * F, 7, 24)) * 0.5).astype(np.float32)
    cond = rng.uniform(0, 1, (B * F, 64, 64, 3)).astype(np.float32)
    t_unet, t_cnet = 1.5, 501.0

    def step(p, sample8, emb, tids, cn_text, cond):
        lat4 = sample8[..., :4].reshape(B * F, HW, HW, 4)
        downs, mid = cnet.apply(p["controlnet"], lat4, jnp.full((B * F,), t_cnet), cn_text,
                                cond, skip_conv_in=True)
        res, res_mid = adapter.apply(p["adapter"], downs, mid, num_frames=F,
                                     timestep=t_cnet, encoder_hidden_states=emb)
        return unet.apply(p["unet"], sample8, jnp.full((B,), t_unet), emb, tids,
                          down_block_additional_residuals=res,
                          mid_block_additional_residual=res_mid)

    want = jax.jit(step)(params, sample8, emb, tids, cn_text, cond)

    tunet, tcnet, tadapter = _port_towers(params)
    s8 = torch.from_numpy(np.ascontiguousarray(sample8.transpose(0, 1, 4, 2, 3)))
    with torch.no_grad():
        downs, mid = tcnet(s8[:, :, :4].reshape(B * F, 4, HW, HW), t_cnet,
                           torch.from_numpy(cn_text), nhwc_to_nchw(cond), skip_conv_in=True)
        res, res_mid = tadapter(downs, mid, F, t_cnet, torch.from_numpy(emb))
        got = tunet(s8, t_unet, torch.from_numpy(emb), torch.from_numpy(tids), res, res_mid)
    assert_close(got.numpy().transpose(0, 1, 3, 4, 2), want, atol=5e-5, what="denoise step")


@pytest.mark.parametrize("sparse_frames", [None, (0, 2)], ids=["dense", "sparse"])
def test_generate_matches_jax(sparse_frames):
    vae = JVAE(config=JVAEConfig(**THIN_VAE, layers_per_block=1))
    unet, cnet, adapter, params = _params(vae)
    rng = np.random.default_rng(1)
    image_emb = (rng.standard_normal((B, 1, 32)) * 0.5).astype(np.float32)
    image_latent = (rng.standard_normal((B, HW, HW, 4)) * 0.5).astype(np.float32)
    cn_prompt = (rng.standard_normal((2 * B, 7, 24)) * 0.5).astype(np.float32)
    ctrl = rng.uniform(0, 1, (B * F, 64, 64, 3)).astype(np.float32)
    latents = rng.standard_normal((B, F, HW, HW, 4)).astype(np.float32)
    kw = dict(height=HW * 8, width=HW * 8, num_frames=F, num_inference_steps=2,
              skip_conv_in=True, control_latent_size=HW, sparse_frames=sparse_frames)

    jpipe = JPipeline(unet=unet, controlnet=cnet, adapter=adapter, vae=vae)
    want = jpipe.generate(params, jax.random.PRNGKey(0), jnp.asarray(image_emb),
                          jnp.asarray(image_latent), jnp.asarray(cn_prompt), jnp.asarray(ctrl),
                          latents=jnp.asarray(latents), **kw)

    tunet, tcnet, tadapter = _port_towers(params)
    tvae = port(AutoencoderKLTemporalDecoder(VAEConfig(**THIN_VAE, layers_per_block=1)),
                params["vae"])
    tpipe = SVDControlNetAdapterPipeline(tunet, tcnet, tadapter, tvae)
    got = tpipe.generate(torch.from_numpy(image_emb), torch.from_numpy(image_latent),
                         torch.from_numpy(cn_prompt), torch.from_numpy(ctrl),
                         latents=torch.from_numpy(latents), **kw)
    assert got.shape == (B, F, HW * 8, HW * 8, 3)
    assert_close(got.numpy(), want, atol=1e-4, what="generate video")
