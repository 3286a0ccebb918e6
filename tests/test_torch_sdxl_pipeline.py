"""The SDXL pipeline of the PyTorch port against the JAX package, fp32 on the CPU.

- The golden file ``tests/golden/sdxl_tiny_v1.npz``: the port's ``generate`` at
  the exact config of ``tests/test_golden_regression.py:_generate``, read off
  that function itself (its JAX ``generate`` is swapped for one that keeps the
  towers, the fabricated params and the arguments: no JAX pipeline runs), the
  weights through ``convert/from_jax.py``, JAX's draw
  ``jax.random.normal(PRNGKey(1234), (1, 16, 16, 4))`` passed as ``latents=``
  (jax.random and torch generators draw different noise). Tolerance: the JAX
  golden test's own, atol and rtol 2e-3.
- Live against the JAX ``generate`` on seeded random inputs: CFG with
  ``guidance_rescale`` and the control window (in Tier-1: one JAX pipeline
  compile); the LCM path (no CFG, ``timestep_cond``) and the IP-Adapter path
  (zero image embeds on the negative half), each one more compile, marked
  ``slow``. 1e-4 on the latents or the image.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter
from ctrl_adapter_tpu.models.controlnet import ControlNetConfig as JCNetConfig
from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.unet_2d import UNet2DConditionModel as JUNet
from ctrl_adapter_tpu.models.unet_2d import UNet2DConfig as JUNetConfig
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.pipelines.sdxl import SDXLControlNetAdapterPipeline as JPipeline
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.unet_2d import UNet2DConditionModel, UNet2DConfig
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline

from . import test_golden_regression
from .torch_port_common import assert_close, port, port_config
from .utils import fake_init

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sdxl_tiny_v1.npz")
_ADAPTER_FIELDS = ("backbone_model_name", "num_blocks", "num_adapters_per_location",
                   "cross_attention_dim", "add_spatial_resnet", "add_temporal_resnet",
                   "add_spatial_transformer", "add_temporal_transformer", "adapter_locations",
                   "custom_down_block_channels", "custom_mid_block_channels",
                   "attention_head_dim", "num_repeats", "out_channels")


def _port_pipeline(jpipe, params, encoder_hid_dim=None):
    """The port's pipeline with the JAX pipeline's towers and weights."""
    unet_cfg = port_config(UNet2DConfig, jpipe.unet.config, encoder_hid_dim=encoder_hid_dim)
    unet = port(UNet2DConditionModel(unet_cfg), params["unet"])
    cnet = port(ControlNetModel(port_config(ControlNetConfig, jpipe.controlnet.config)),
                params["controlnet"])
    adapter = port(ControlNetAdapter(**{k: getattr(jpipe.adapter, k) for k in _ADAPTER_FIELDS}),
                   params["adapter"])
    vae = port(AutoencoderKL(port_config(VAEConfig, jpipe.vae.config)), params["vae"])
    return SDXLControlNetAdapterPipeline(unet, cnet, adapter, vae)


def _golden_setup(monkeypatch):
    """What ``_generate`` hands the JAX ``generate``: (pipeline, params, args, kwargs)."""
    seen = {}

    def keep(self, params, rng, *args, **kwargs):
        seen.update(pipe=self, params=params, args=args, kwargs=kwargs)
        return np.zeros((1,), np.float32)

    monkeypatch.setattr(JPipeline, "generate", keep)
    test_golden_regression._generate()
    return seen["pipe"], seen["params"], seen["args"], seen["kwargs"]


def test_generate_matches_the_golden_file(monkeypatch):
    jpipe, params, args, kwargs = _golden_setup(monkeypatch)
    assert kwargs["num_inference_steps"] == 3 and jpipe.adapter.backbone_model_name == "sdxl"
    tpipe = _port_pipeline(jpipe, params)
    latents = np.asarray(jax.random.normal(jax.random.PRNGKey(1234), (1, 16, 16, 4)))
    got = tpipe.generate(*(torch.from_numpy(np.array(a)) for a in args),
                         latents=torch.from_numpy(np.array(latents)), **kwargs)
    want = np.load(GOLDEN)["image"]
    assert got.shape == want.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------- live parity
B = 1
CNET_CFG = JCNetConfig(block_out_channels=(32, 32, 32, 32), num_attention_heads=(4, 4, 4, 4),
                       cross_attention_dim=24, conditioning_embedding_out_channels=(8, 8, 16, 16),
                       norm_num_groups=16)
VAE_CFG = JVAEConfig(block_out_channels=(16, 16, 16, 16), norm_num_groups=8, layers_per_block=1)
IP_DIM = 24


def _unet_config(**extra):
    """The two-level SDXL-style UNet of ``tests/test_sdxl_pipeline.py`` and
    ``tests/test_ip_adapter.py``."""
    return JUNetConfig(
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), block_out_channels=(32, 32),
        transformer_layers_per_block=(1, 2), num_attention_heads=(2, 2), cross_attention_dim=32,
        use_linear_projection=True, norm_num_groups=16, addition_embed_type="text_time",
        addition_time_embed_dim=8, projection_class_embeddings_input_dim=16 + 48, **extra)


def _jax_setup(unet_cfg, lcm=False, ip=False):
    """JAX towers (adapter at A with 3 blocks, the x2 SDXL upsample) and
    fabricated params at seeded scale 0.1 (IP-Adapter weights x5)."""
    unet = JUNet(config=unet_cfg)
    cnet = JControlNet(config=CNET_CFG)
    adapter = JAdapter(backbone_model_name="sdxl", num_blocks=1, num_adapters_per_location=3,
                       cross_attention_dim=32, adapter_locations=("A",),
                       add_temporal_resnet=False, add_temporal_transformer=False,
                       custom_down_block_channels=(32,) * 3, attention_head_dim=16)
    vae = JVAE(config=VAE_CFG)
    n = B if lcm else 2 * B
    pe, cnp = jnp.ones((n, 7, 32)), jnp.ones((n, 7, 24))
    added = {"text_embeds": jnp.ones((n, 16)), "time_ids": jnp.ones((n, 6))}
    if ip:
        added["image_embeds"] = jnp.ones((n, IP_DIM))
    kw = {"timestep_cond": jnp.zeros((n, 8))} if lcm else {}
    params = {"unet": fake_init(unet, jnp.ones((n, 16, 16, 4)), jnp.ones((n,)), pe, added,
                                seed=1, scale=0.1, **kw),
              "controlnet": fake_init(cnet, jnp.ones((n, 8, 8, 4)), jnp.ones((n,)), cnp,
                                      jnp.ones((n, 64, 64, 3)), seed=2, scale=0.1),
              "vae": fake_init(vae, jnp.ones((1, 64, 64, 3)), seed=3, scale=0.1)}
    if ip:
        params["unet"] = jax.tree_util.tree_map_with_path(
            lambda path, v: v * 5.0 if any("processor" in str(k) or "encoder_hid_proj" in str(k)
                                           for k in path) else v, params["unet"])
    downs, _ = jax.eval_shape(lambda: cnet.apply(
        params["controlnet"], jnp.ones((n, 8, 8, 4)), jnp.ones((n,)), cnp,
        jnp.ones((n, 64, 64, 3))))
    params["adapter"] = fake_init(adapter, [jnp.zeros(s.shape) for s in downs], None, 1,
                                  jnp.ones((n,)), pe, seed=4, scale=0.1)
    return JPipeline(unet=unet, controlnet=cnet, adapter=adapter, vae=vae), params


def _inputs(seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(prompt=r(2 * B, 7, 32), text=r(2 * B, 16), cn_prompt=r(2 * B, 7, 24),
                ctrl=rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
                latents=r(B, 16, 16, 4, scale=1.0), ip=r(B, IP_DIM))


def _both(jpipe, params, tpipe, x, ip=False, **kw):
    """The JAX and the port ``generate`` on the same inputs and latents."""
    args = ("prompt", "text", "cn_prompt", "ctrl")
    extra = dict(ip_adapter_image_embeds=x["ip"]) if ip else {}
    common = dict(height=128, width=128, control_latent_size=8, **kw)
    want = jpipe.generate(params, jax.random.PRNGKey(0), *(jnp.asarray(x[k]) for k in args),
                          latents=jnp.asarray(x["latents"]),
                          **{k: jnp.asarray(v) for k, v in extra.items()}, **common)
    got = tpipe.generate(*(torch.from_numpy(x[k]) for k in args),
                         latents=torch.from_numpy(x["latents"]),
                         **{k: torch.from_numpy(v) for k, v in extra.items()}, **common)
    return got, want


def test_generate_rescaled_cfg_matches_jax():
    """CFG 6.0 rescaled by 0.7, 3 Euler steps, the control window the first 2;
    the decoded image. The ControlNet and adapter run only inside the window."""
    jpipe, params = _jax_setup(_unet_config())
    tpipe = _port_pipeline(jpipe, params)
    calls = []
    tpipe.controlnet.register_forward_hook(lambda *_: calls.append(1))
    got, want = _both(jpipe, params, tpipe, _inputs(90), num_inference_steps=3,
                      guidance_scale=6.0, guidance_rescale=0.7, control_guidance_end=0.67)
    assert got.shape == (B, 128, 128, 3) and len(calls) == 2
    assert_close(got.numpy(), want, atol=1e-4, what="rescaled-CFG image")


@pytest.mark.slow
def test_generate_lcm_matches_jax():
    """A UNet with time_cond_proj_dim: one batch, no CFG, the guidance scale
    embedded as timestep_cond."""
    jpipe, params = _jax_setup(_unet_config(time_cond_proj_dim=8), lcm=True)
    tpipe = _port_pipeline(jpipe, params)
    got, want = _both(jpipe, params, tpipe, _inputs(91), num_inference_steps=3,
                      guidance_scale=4.0, control_guidance_end=1.0, output_type="latent")
    assert got.shape == (B, 16, 16, 4)
    assert_close(got.numpy(), want, atol=1e-4, what="LCM latents")


@pytest.mark.slow
def test_generate_ip_adapter_matches_jax():
    """IP-Adapter image tokens in every cross-attention, zero embeds on the
    negative half."""
    jpipe, params = _jax_setup(_unet_config(encoder_hid_dim_type="ip_image_proj"), ip=True)
    tpipe = _port_pipeline(jpipe, params, encoder_hid_dim=IP_DIM)
    got, want = _both(jpipe, params, tpipe, _inputs(92), ip=True, num_inference_steps=3,
                      guidance_scale=7.5, control_guidance_end=0.67, output_type="latent")
    assert_close(got.numpy(), want, atol=1e-4, what="IP-Adapter latents")
