"""The port's I2VGen-XL training step against the JAX trainer, fp32 on the CPU.

Thin towers as in ``tests/test_train_step.py``: the 32/32/64/64 I2VGen-XL
UNet (``THIN_UNET``), the thin ControlNet (``CNET_CFG``), the 13-block adapter
at ``THIN_CHANNELS`` and the thin 2D VAE; B 1, F 4, 64x64 frames, 8x8
latents. Both sides start from the same fabricated weights (the adapter's and
the router's through ``convert/from_jax.py`` into the port's fp32 masters) and
take the same random draws: the JAX step's own, rebuilt from its ``rng``
split, the "time" draw the DDIM branch's integer timestep.

Tier-1 runs one step (one whole-step JAX compile): one expert without a
router. ``v_prediction``, sparse frames and ``num_repeats = 2`` are marked
slow. Router training is ``tests/test_torch_train_router.py``, on these
towers.

Tolerances as ``tests/test_torch_train_step.py`` states them: loss and
grad_norm 1e-5 relative; each gradient within 1e-3 of its own norm plus 3e-5
of the global norm; the masters after one update within 0.1 lr, with its
``noise_floor``: the adapter's first block (32 channels, 32 norm groups)
has biases that a GroupNorm cancels exactly, whose fp32-noise gradients
(within the gradient check's allowance) sit below Adam's eps, so their
first update follows the noise (0.11-0.19 lr apart between the frameworks
in the v-prediction and conditional-router steps); those are held to one
update.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter
from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.router import ControlNetRouter as JRouter
from ctrl_adapter_tpu.models.router import build_router_input as jrouter_input
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLUNet as JUNet
from ctrl_adapter_tpu.models.unet_i2vgen import I2VGenXLUNetConfig as JUNetConfig
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE
from ctrl_adapter_tpu.train.trainer import CtrlAdapterTrainer as JTrainer
from ctrl_adapter_tpu.train.trainer import TrainConfig as JTrainConfig
from ctrl_adapter_tpu_torch.convert.from_jax import state_dict_from_jax
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

from .test_torch_i2vgen_modules import THIN_UNET, THIN_VAE
from .test_torch_train_step import check_step, jax_draws, jax_step
from .test_video_pipelines import CNET_CFG, THIN_CHANNELS, VAE_CFG
from .torch_port_common import port, port_config
from .utils import fake_init

B, F, HW = 1, 4, 8
N = B * F
CFG = dict(model_name="i2vgenxl", n_sample_frames=F, control_latent_size=HW,
           gradient_checkpointing=True)
# the router input's width per conditional type: the timestep sinusoid (256),
# the CLIP image embedding (32), both
ROUTER_DIMS = {"simple_weights": None, "timestep_weights": 256, "embedding_weights": 32,
               "timestep_embedding_weights": 288}
ADAPTER = dict(num_blocks=1, num_adapters_per_location=3, cross_attention_dim=32,
               adapter_locations=("A", "B", "C", "D", "M"), add_temporal_resnet=True,
               add_temporal_transformer=True, custom_down_block_channels=THIN_CHANNELS,
               custom_mid_block_channels=64, attention_head_dim=16)
# num_repeats 2 over the three location-A blocks (tests/test_train_step.py:275)
REPEATS = dict(num_blocks=1, num_adapters_per_location=3, cross_attention_dim=32,
               adapter_locations=("A",), custom_down_block_channels=(32, 32, 32),
               attention_head_dim=16, num_repeats=2, out_channels=32)


def _batch(num_experts, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    batch = {"frames": rng.uniform(-1, 1, (B, F, 64, 64, 3)).astype(np.float32),
             "controlnet_cond": rng.uniform(0, 1, (num_experts, N, 64, 64, 3)).astype(np.float32),
             "controlnet_text_emb": r(B, 7, 24), "prompt_embeds": r(B, 7, 32),
             "image_embeddings": r(B, 1, 32)}
    if num_experts > 1:  # expert 1 masked
        batch["expert_mask"] = np.array([float(e != 1) for e in range(num_experts)], np.float32)
    return batch


def _setup(num_experts=1, router_type=None, adapter=ADAPTER):
    """JAX towers, their fabricated params and the batch (numpy)."""
    unet, cnet = JUNet(config=JUNetConfig(**THIN_UNET)), JControlNet(config=CNET_CFG)
    jadapter, vae = JAdapter(backbone_model_name="i2vgenxl", **adapter), JVAE(config=VAE_CFG)
    router = None if router_type is None else JRouter(num_experts=num_experts,
                                                      router_type=router_type)
    params = {"unet": fake_init(unet, jnp.ones((B, F, HW, HW, 4)), jnp.ones((B,)),
                                jnp.ones((B,)), jnp.ones((B, F, HW, HW, 4)),
                                jnp.ones((B, 1, 32)), jnp.ones((B, 7, 32))),
              "vae": fake_init(vae, jnp.ones((1, 64, 64, 3)), seed=3)}
    cn_args = (jnp.ones((N, HW, HW, 4)), jnp.ones((N,)), jnp.ones((N, 7, 24)),
               jnp.ones((N, 64, 64, 3)))
    for e in range(num_experts):
        params[f"controlnet_{e}"] = fake_init(cnet, *cn_args, seed=100 + e)
    downs, mid = jax.eval_shape(lambda: cnet.apply(params["controlnet_0"], *cn_args))
    params["adapter"] = fake_init(jadapter, [jnp.zeros(s.shape) for s in downs],
                                  jnp.zeros(mid.shape), F, jnp.ones((N,)),
                                  jnp.ones((1, 1, 32)), seed=2)
    if router is not None:
        rin = jrouter_input(router_type, jnp.zeros((1,)), jnp.zeros((1, 1, 32)))
        # the gates' init scale, 1 / sqrt(in_features): weights far from equal
        dim = ROUTER_DIMS[router_type] or 1
        params["router"] = fake_init(router, rin, jnp.ones((num_experts,)), seed=4,
                                     scale=dim ** -0.5)
    return (unet, cnet, jadapter, vae, router), params, _batch(num_experts)


def _port_trainer(params, cfg, num_experts, router_type, adapter):
    unet = port(I2VGenXLUNet(I2VGenXLUNetConfig(**THIN_UNET)), params["unet"])
    nets = [port(ControlNetModel(port_config(ControlNetConfig, CNET_CFG)),
                 params[f"controlnet_{e}"]) for e in range(num_experts)]
    vae = port(AutoencoderKL(VAEConfig(**THIN_VAE)), params["vae"])
    module = ControlNetAdapter(backbone_model_name="i2vgenxl", **adapter)
    router = None
    if router_type is not None:
        router = ControlNetRouter(num_experts, router_type,
                                  embedding_dim=ROUTER_DIMS[router_type])
    controlnet = MultiControlNetModel(nets) if num_experts > 1 else nets[0]
    trainer = CtrlAdapterTrainer(TrainConfig(**cfg), unet, controlnet, module, vae, router=router,
                                 device="cpu")
    trainer.load_masters(
        state_dict_from_jax(module, params["adapter"], dtype=torch.float32),
        None if router is None else state_dict_from_jax(router, params["router"],
                                                        dtype=torch.float32))
    return trainer


def _check(num_experts=1, router_type=None, adapter=ADAPTER, sparse_frames=None, **change):
    """One step of the port against one of the JAX trainer; returns the port's
    trainer and metrics."""
    cfg = dict(CFG, num_experts=num_experts, train_router=router_type is not None, **change)
    (unet, cnet, jadapter, vae, router), params, batch = _setup(num_experts, router_type,
                                                                adapter)
    jtrainer = JTrainer(JTrainConfig(**cfg), unet, cnet, jadapter, vae, router=router)
    trainable = {"adapter": params["adapter"]}
    if router is not None:
        trainable["router"] = params["router"]
    frozen = {k: v for k, v in params.items() if k not in trainable}
    jax_out = jax_step(jtrainer, trainable, frozen, batch, sparse_frames=sparse_frames)
    trainer = _port_trainer(params, cfg, num_experts, router_type, adapter)
    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 sparse_frames=sparse_frames,
                                 draws=jax_draws((B, F, HW, HW), ddim=True))
    check_step(trainer, metrics, jax_out, noise_floor=True)
    return trainer, metrics


def test_i2vgenxl_train_step_matches_jax():
    """One expert, no router: DDIM noising at the JAX step's integer
    timestep, epsilon target, the CLIP image embedding into the adapter, the
    image latents into the UNet, MSE."""
    _check()


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["v_prediction", "sparse-frames", "num_repeats"])
def test_i2vgenxl_train_step_variants_match_jax(variant):
    """v-prediction's target (``get_velocity``), key frames (0, 2) through the
    adapter with the dense re-scatter, and the adapter's ``num_repeats = 2``
    with the zero padding of the other residual slots; each one more
    whole-step JAX compile."""
    if variant == "v_prediction":
        _check(prediction_type="v_prediction")
    elif variant == "sparse-frames":
        _check(sparse_frames=(0, 2))
    else:
        _check(adapter=REPEATS)
