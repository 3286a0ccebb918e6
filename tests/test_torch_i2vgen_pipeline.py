"""The I2VGen-XL pipeline of the PyTorch port against the JAX package, fp32 on the CPU.

- The golden file ``tests/golden/i2vgenxl_tiny_v1.npz``: the port's
  ``generate`` at the exact config of
  ``tests/test_golden_regression.py:_generate_i2vgenxl`` (two experts, a
  simple-weights router, expert 1 masked, sparse frames 0 and 2), its weights
  the same fabricated JAX trees through ``convert/from_jax.py``, JAX's draw
  ``jax.random.normal(PRNGKey(7), (1, 4, 8, 8, 4))`` passed as ``latents=``
  (jax.random and torch generators draw different noise). No JAX pipeline
  runs; the tolerance is the JAX golden test's own, atol and rtol 2e-3.
- Live against the JAX ``generate`` on seeded random inputs, the three paths
  of ``tests/test_video_pipelines.py:53,102,238``: multi-expert + router +
  sparse frames + expert mask (in Tier-1: one JAX pipeline compile); per-expert
  scales and windows, and a conditional router with its per-step trace (each
  one more compile, marked ``slow``). 1e-4 on the video or the latents.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.router import ControlNetRouter as JRouter
from ctrl_adapter_tpu.models.router import build_router_input as jrouter_input
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLUNet as JUNet
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLUNetConfig as JUNetConfig
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE
from ctrl_adapter_tpu.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline as JPipeline
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline

from .test_torch_i2vgen_modules import THIN_UNET, THIN_VAE
from .test_video_pipelines import CNET_CFG, THIN_CHANNELS, VAE_CFG, _adapter
from .torch_port_common import assert_close, port
from .utils import fake_init

B, F, HW = 1, 4, 8
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "i2vgenxl_tiny_v1.npz")


def _jax_params(unet, cnet, adapter, vae, temporal_frames=2, router=None, router_params=None):
    """The fabricated JAX trees of ``_generate_i2vgenxl`` (two experts)."""
    prompt = jnp.ones((2 * B, 7, 32)) * 0.1
    sample = jnp.ones((2 * B, F, HW, HW, 4))
    params = {
        "unet": fake_init(unet, sample, jnp.ones((2 * B,)), jnp.ones((2 * B,)), sample,
                          jnp.ones((2 * B, 1, 32)), prompt),
        "vae": fake_init(vae, jnp.ones((1, 64, 64, 3))),
    }
    if router is not None:
        params["router"] = router_params
    n = 2 * B * F
    cn_args = (jnp.ones((n, HW, HW, 4)), jnp.ones((n,)), jnp.ones((n, 7, 24)),
               jnp.ones((n, 64, 64, 3)))
    for e in range(2):
        params[f"controlnet_{e}"] = fake_init(cnet, *cn_args, seed=e)
    downs_s, mid_s = jax.eval_shape(lambda: cnet.apply(params["controlnet_0"], *cn_args))
    params["adapter"] = fake_init(adapter, [jnp.zeros(s.shape) for s in downs_s],
                                  jnp.zeros(mid_s.shape), temporal_frames, jnp.ones((n,)),
                                  jnp.ones((1, 1, 32)))
    return params


def _port_pipeline(params, temporal=True, router=None):
    unet = port(I2VGenXLUNet(I2VGenXLUNetConfig(**THIN_UNET)), params["unet"])
    cfg = ControlNetConfig(
        block_out_channels=CNET_CFG.block_out_channels,
        num_attention_heads=CNET_CFG.num_attention_heads,
        cross_attention_dim=CNET_CFG.cross_attention_dim,
        conditioning_embedding_out_channels=CNET_CFG.conditioning_embedding_out_channels,
        norm_num_groups=CNET_CFG.norm_num_groups)
    experts = MultiControlNetModel([port(ControlNetModel(cfg), params[f"controlnet_{e}"])
                                    for e in range(2)])
    adapter = port(ControlNetAdapter(
        num_blocks=1, num_adapters_per_location=3, cross_attention_dim=32,
        adapter_locations=("A", "B", "C", "D", "M"), add_temporal_resnet=temporal,
        add_temporal_transformer=temporal, custom_down_block_channels=THIN_CHANNELS,
        custom_mid_block_channels=64, attention_head_dim=16), params["adapter"])
    vae = port(AutoencoderKL(VAEConfig(**THIN_VAE)), params["vae"])
    if router is not None:
        router = port(router, params["router"])
    return I2VGenXLControlNetAdapterPipeline(unet, experts, adapter, vae, router=router)


def _jax_towers(temporal=True):
    unet = JUNet(config=JUNetConfig(**THIN_UNET))
    return unet, JControlNet(config=CNET_CFG), _adapter(temporal), JVAE(config=VAE_CFG)


def _inputs(seed):
    """Seeded random inputs: prompt (2b, 7, 32), ControlNet prompt (2b, 7, 24), CLIP
    image embedding (b, 1, 32), first-frame latent (b, 8, 8, 4), two experts'
    conditions (2, b*f, 64, 64, 3) and the initial latents."""
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(prompt=r(2 * B, 7, 32), cn_prompt=r(2 * B, 7, 24), image_emb=r(B, 1, 32),
                ff_latent=r(B, HW, HW, 4),
                ctrl=rng.uniform(0, 1, (2, B * F, 64, 64, 3)).astype(np.float32),
                latents=r(B, F, HW, HW, 4, scale=1.0))


def _both(jpipe, params, tpipe, x, **kw):
    """The JAX and the port ``generate`` on the same inputs and latents."""
    args = ("prompt", "cn_prompt", "image_emb", "ff_latent", "ctrl")
    want = jpipe.generate(params, jax.random.PRNGKey(0), *(jnp.asarray(x[k]) for k in args),
                          latents=jnp.asarray(x["latents"]), **kw)
    got = tpipe.generate(*(torch.from_numpy(x[k]) for k in args),
                         latents=torch.from_numpy(x["latents"]), **kw)
    return got, want


COMMON = dict(height=HW * 8, width=HW * 8, num_frames=F, control_latent_size=HW)


def test_generate_matches_the_golden_file():
    unet, cnet, adapter, vae = _jax_towers()
    router = JRouter(num_experts=2, router_type="simple_weights")
    params = _jax_params(unet, cnet, adapter, vae, router=router,
                         router_params=router.init(jax.random.PRNGKey(0)))
    tpipe = _port_pipeline(params, router=ControlNetRouter(2, "simple_weights"))
    latents = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (B, F, HW, HW, 4)))
    got = tpipe.generate(
        torch.ones(2 * B, 7, 32) * 0.1, torch.ones(2 * B, 7, 24) * 0.1,
        torch.ones(B, 1, 32) * 0.1, torch.ones(B, HW, HW, 4) * 0.1,
        torch.ones(2, B * F, 64, 64, 3) * 0.5, num_inference_steps=4,
        control_guidance_end=0.67, sparse_frames=[0, 2], inference_expert_masks=[True, False],
        latents=torch.from_numpy(np.array(latents)), **COMMON)
    want = np.load(GOLDEN)["video"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_generate_multi_expert_router_sparse_mask_matches_jax():
    """Two experts, a simple-weights router, expert 1 masked (never run on the
    port's side: forward hooks), sparse frames 0 and 2, the video decoded."""
    unet, cnet, adapter, vae = _jax_towers()
    router = JRouter(num_experts=2, router_type="simple_weights")
    params = _jax_params(unet, cnet, adapter, vae, router=router,
                         router_params=fake_init(router, seed=4, scale=0.5))
    jpipe = JPipeline(unet=unet, controlnet=cnet, adapter=adapter, vae=vae, router=router)
    tpipe = _port_pipeline(params, router=ControlNetRouter(2, "simple_weights"))
    calls = [0, 0]
    for e, net in enumerate(tpipe.controlnet.nets):
        net.register_forward_hook(lambda *_, e=e: calls.__setitem__(e, calls[e] + 1))
    got, want = _both(jpipe, params, tpipe, _inputs(70), num_inference_steps=3,
                      control_guidance_end=0.67, sparse_frames=[0, 2],
                      inference_expert_masks=[True, False], **COMMON)
    assert got.shape == (B, F, 64, 64, 3)
    assert calls == [2, 0]  # the control window covers 2 of 3 steps
    assert_close(got.numpy(), want, atol=1e-4, what="multi-expert video")


@pytest.mark.slow
def test_generate_per_expert_scales_and_windows_match_jax():
    """Routerless two-expert sum with a scale and a [start, end) window per
    expert: each expert is gated by keep x scale inside the union window."""
    unet, cnet, adapter, vae = _jax_towers(temporal=False)
    params = _jax_params(unet, cnet, adapter, vae, temporal_frames=F)
    jpipe = JPipeline(unet=unet, controlnet=cnet, adapter=adapter, vae=vae, router=None)
    tpipe = _port_pipeline(params, temporal=False)
    got, want = _both(jpipe, params, tpipe, _inputs(71), num_inference_steps=4,
                      controlnet_conditioning_scale=[1.0, 0.5],
                      control_guidance_start=[0.0, 0.25], control_guidance_end=[0.75, 1.0],
                      output_type="latent", **COMMON)
    assert_close(got.numpy(), want, atol=1e-4, what="per-expert latents")


@pytest.mark.slow
def test_generate_conditional_router_trace_matches_jax():
    """A timestep-conditioned router: weights per step inside the loop, and the
    returned per-step trace."""
    unet, cnet, adapter, vae = _jax_towers(temporal=False)
    router = JRouter(num_experts=2, router_type="timestep_weights")
    rin = jrouter_input("timestep_weights", jnp.zeros((1,)), None)
    params = _jax_params(unet, cnet, adapter, vae, temporal_frames=F, router=router,
                         router_params=fake_init(router, rin, seed=3, scale=0.5))
    jpipe = JPipeline(unet=unet, controlnet=cnet, adapter=adapter, vae=vae, router=router)
    tpipe = _port_pipeline(params, temporal=False,
                           router=ControlNetRouter(2, "timestep_weights", embedding_dim=256))
    (got, got_down, got_mid), (want, want_down, want_mid) = _both(
        jpipe, params, tpipe, _inputs(72), num_inference_steps=4, control_guidance_end=1.0,
        return_router_weights=True, **COMMON)
    assert_close(got.numpy(), want, atol=1e-4, what="conditional-router video")
    assert len(got_down) == len(want_down) == 4
    assert_close(np.asarray(got_down), np.asarray(want_down), atol=1e-4, what="down trace")
    assert_close(np.asarray(got_mid), np.asarray(want_mid), atol=1e-4, what="mid trace")
    assert not np.allclose(got_down[0], got_down[-1])
