"""The port's SDXL training step against the JAX trainer, fp32 on the CPU.

The thin SDXL UNet of ``tests/test_unet2d_vae.py`` (``TINY_SDXL``: three
levels 32/64/64, text_time conditioning, 9 skips), a thin ControlNet whose
first 9 residuals have the UNet's skip widths at half its size
(32/64/64/64), the adapter at A-C (3 per location) with the SDXL x2
upsample, and the thin 2D VAE; batch 1 at 128x128 (16x16 latents, the
ControlNet at 8x8 on a 64x64 control image). Both sides start from the same
fabricated weights (the adapter's through ``convert/from_jax.py`` into the
port's fp32 masters) and take the JAX step's own draws.

Tier-1 runs one step with min-SNR (gamma 5, the weights from DDIM's
``alphas_cumprod`` at the drawn timestep) and ``vae_scaling_factor`` 0.13025,
as ``configs/sdxl_train_depth.yaml`` and ``train.py`` set them; plain MSE is
marked slow. Tolerances as ``tests/test_torch_train_step.py`` states them,
with its ``noise_floor``: the adapter's first block ResNet's conv1 and
time-embedding biases feed a GroupNorm of one channel per group (32 of 32),
which cancels them exactly; their gradients are fp32 rounding noise of
~1e-9, below Adam's eps, and their first update lr * g / (|g| + eps) follows
that noise (0.24 lr apart between the frameworks), so they are held to one
update.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter
from ctrl_adapter_tpu.models.controlnet import ControlNetConfig as JCNetConfig
from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.unet_2d import UNet2DConditionModel as JUNet
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE
from ctrl_adapter_tpu.train.trainer import CtrlAdapterTrainer as JTrainer
from ctrl_adapter_tpu.train.trainer import TrainConfig as JTrainConfig
from ctrl_adapter_tpu_torch.convert.from_jax import state_dict_from_jax
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.unet_2d import UNet2DConditionModel, UNet2DConfig
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

from .test_torch_train_step import check_step, jax_draws, jax_step
from .test_unet2d_vae import TINY_SDXL
from .test_video_pipelines import VAE_CFG
from .torch_port_common import port, port_config
from .utils import fake_init

B, HW, CTRL = 1, 16, 8  # batch, UNet latent size, ControlNet latent size
CFG = dict(model_name="sdxl", n_sample_frames=1, output_fps=1, control_latent_size=CTRL,
           vae_scaling_factor=0.13025, snr_gamma=5.0, gradient_checkpointing=True)
CNET_CFG = JCNetConfig(block_out_channels=(32, 64, 64, 64), num_attention_heads=(4, 4, 4, 4),
                       cross_attention_dim=24, conditioning_embedding_out_channels=(8, 8, 16, 16),
                       norm_num_groups=16)
ADAPTER = dict(backbone_model_name="sdxl", num_blocks=1, num_adapters_per_location=3,
               cross_attention_dim=16, adapter_locations=("A", "B", "C"),
               add_temporal_resnet=False, add_temporal_transformer=False,
               custom_down_block_channels=(32, 32, 32, 32, 64, 64, 64, 64, 64),
               attention_head_dim=16)


def _setup():
    """JAX towers, their fabricated params and the batch (numpy)."""
    unet, cnet = JUNet(config=TINY_SDXL), JControlNet(config=CNET_CFG)
    adapter, vae = JAdapter(**ADAPTER), JVAE(config=VAE_CFG)
    added = {"text_embeds": jnp.ones((B, 32)), "time_ids": jnp.ones((B, 6))}
    cn_args = (jnp.ones((B, CTRL, CTRL, 4)), jnp.ones((B,)), jnp.ones((B, 7, 24)),
               jnp.ones((B, 8 * CTRL, 8 * CTRL, 3)))
    params = {"unet": fake_init(unet, jnp.ones((B, HW, HW, 4)), jnp.ones((B,)),
                                jnp.ones((B, 7, 16)), added, seed=1),
              "controlnet_0": fake_init(cnet, *cn_args, seed=2),
              "vae": fake_init(vae, jnp.ones((1, 64, 64, 3)), seed=3)}
    downs, _ = jax.eval_shape(lambda: cnet.apply(params["controlnet_0"], *cn_args))
    params["adapter"] = fake_init(adapter, [jnp.zeros(s.shape) for s in downs], None, 1,
                                  jnp.ones((B,)), jnp.ones((B, 7, 16)), seed=4)
    rng = np.random.default_rng(0)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    batch = {"frames": rng.uniform(-1, 1, (B, 1, 8 * HW, 8 * HW, 3)).astype(np.float32),
             "controlnet_cond": rng.uniform(0, 1, (1, B, 8 * CTRL, 8 * CTRL, 3)).astype(
                 np.float32),
             "controlnet_text_emb": r(B, 7, 24), "prompt_embeds": r(B, 7, 16),
             "pooled_prompt_embeds": r(B, 32),
             "additional_time_ids": np.array([[128, 128, 0, 0, 128, 128]] * B, np.float32)}
    return (unet, cnet, adapter, vae), params, batch


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _check(setup, **change):
    (unet, cnet, jadapter, vae), params, batch = setup
    cfg = dict(CFG, **change)
    jtrainer = JTrainer(JTrainConfig(**cfg), unet, cnet, jadapter, vae)
    frozen = {k: v for k, v in params.items() if k != "adapter"}
    jax_out = jax_step(jtrainer, {"adapter": params["adapter"]}, frozen, batch)
    module = ControlNetAdapter(**ADAPTER)
    trainer = CtrlAdapterTrainer(
        TrainConfig(**cfg), port(UNet2DConditionModel(port_config(UNet2DConfig, TINY_SDXL)),
                                 params["unet"]),
        port(ControlNetModel(port_config(ControlNetConfig, CNET_CFG)), params["controlnet_0"]),
        module, port(AutoencoderKL(port_config(VAEConfig, VAE_CFG)), params["vae"]),
        device="cpu")
    trainer.load_masters(state_dict_from_jax(module, params["adapter"], dtype=torch.float32))
    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 draws=jax_draws((B, 1, HW, HW), ddim=True))
    check_step(trainer, metrics, jax_out, noise_floor=True)


def test_sdxl_train_step_matches_jax(setup):
    """The SDXL branch with min-SNR: the prompt embeddings into the adapter,
    the adapted (upsampled) residuals, the pooled text and time ids and a 0-d
    zero mid residual into the UNet, the min-SNR weighted MSE."""
    _check(setup)


@pytest.mark.slow
def test_sdxl_train_step_plain_mse_matches_jax(setup):
    _check(setup, snr_gamma=None)
