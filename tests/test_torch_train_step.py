"""The port's SVD training step against the JAX trainer, fp32 on the CPU.

Thin towers (``THIN_UNET``, ``CNET_CFG``, the thin adapter and temporal VAE of
``tests/test_torch_port_svd.py``): B 1, F 4, 64x64 frames, 8x8 latents. Both
sides start from the same fabricated weights (the adapter's through
``convert/from_jax.py`` into the port's fp32 masters) and take the same random
draws: the JAX step's own, rebuilt from its ``rng`` split as its ``_loss``
makes them, and fed to the port's deterministic ``loss``.

The JAX reference is the body of ``CtrlAdapterTrainer.train_step``
(``ctrl_adapter_tpu/train/trainer.py:395-420``) with the gradients returned
too: ``value_and_grad`` of its ``_loss`` under ``grad_safe_blocks``, then its
optax optimizer. One whole-step compile takes about two minutes on one CPU
core, so the Tier-1 test runs one configuration (dense, gradient
checkpointing on, conditioning dropout on and drawn to fire); the sparse-frame
and no-dropout variants are marked slow, and the sparse gather and scatter are
held in Tier-1 by a cheaper check of the port against itself.

Tolerances, fp32 through three towers: loss and grad_norm 1e-5 relative; each
adapter gradient within 1e-3 of its own norm plus 3e-5 of the global norm: the
biases that feed a GroupNorm (a ResNet's conv1 and time-embedding biases) get
a gradient that the norm's invariance to a constant shift nearly cancels, so
it is fp32 rounding noise, 0.7-1.1e-5 of the global norm apart between the two
frameworks in the dense and sparse steps; the masters after
one update within 0.1 lr. The thin step's gradients sit near Adam's eps
(grad_norm ~6e-5 over ~7e5 parameters), where the first update
lr * g / (|g| + eps) turns a relative error of g into an absolute one of up to
lr, so the masters are held in units of lr.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.unet_svd import UNetSpatioTemporalConditionModel as JUNet
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JVAE
from ctrl_adapter_tpu.ops.flash_attention import grad_safe_blocks
from ctrl_adapter_tpu.train.trainer import CtrlAdapterTrainer as JTrainer
from ctrl_adapter_tpu.train.trainer import TrainConfig as JTrainConfig
from ctrl_adapter_tpu_torch.convert.from_jax import _TO_TORCH, jax_path, state_dict_from_jax
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.unet_svd import SVDUNetConfig
from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
from ctrl_adapter_tpu_torch.models.vae import VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.train import checkpoints
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

from .test_torch_port_modules import THIN_UNET, THIN_VAE
from .test_torch_port_svd import _port_adapter
from .test_video_pipelines import CNET_CFG, _adapter
from .torch_port_common import port
from .utils import fake_init

B, F, HW = 1, 4, 8
N = B * F
CFG = dict(model_name="svd", n_sample_frames=F, control_latent_size=HW, skip_conv_in=True,
           output_fps=7, conditioning_dropout_prob=0.1, gradient_checkpointing=True)
LR = 5e-5  # TrainConfig's default learning rate
# PRNGKey(0)'s dropout uniform is 0.154: the prompt (< 0.2) and the image
# latents ([0.1, 0.3)) are both dropped
KEY = 0


def _jax_setup():
    """JAX modules, their fabricated params and the batch (numpy)."""
    unet, cnet, adapter = JUNet(config=THIN_UNET), JControlNet(config=CNET_CFG), _adapter()
    vae = JVAE(config=JVAEConfig(**THIN_VAE, layers_per_block=1))
    params = {"unet": fake_init(unet, jnp.ones((B, F, HW, HW, 8)), jnp.ones((B,)),
                                jnp.ones((B, 1, 32)), jnp.ones((B, 3)))}
    cn_args = (jnp.ones((N, HW, HW, 4)), jnp.ones((N,)), jnp.ones((N, 7, 24)),
               jnp.ones((N, 64, 64, 3)))
    params["controlnet"] = fake_init(cnet, *cn_args, seed=1)
    downs_s, mid_s = jax.eval_shape(lambda: cnet.apply(params["controlnet"], *cn_args))
    params["adapter"] = fake_init(adapter, [jnp.zeros(s.shape) for s in downs_s],
                                  jnp.zeros(mid_s.shape), F, jnp.ones((N,)),
                                  jnp.ones((1, 1, 32)), seed=2)
    params["vae"] = fake_init(vae, jnp.ones((1, 64, 64, 3)), seed=3)
    rng = np.random.default_rng(0)
    batch = {"frames": rng.uniform(-1, 1, (B, F, 64, 64, 3)).astype(np.float32),
             "controlnet_cond": rng.uniform(0, 1, (1, N, 64, 64, 3)).astype(np.float32),
             "controlnet_text_emb": (rng.standard_normal((B, 7, 24)) * 0.5).astype(np.float32),
             "image_embeddings": (rng.standard_normal((B, 1, 32)) * 0.5).astype(np.float32)}
    return (unet, cnet, adapter, vae), params, batch


@pytest.fixture(scope="module")
def setup():
    return _jax_setup()


def jax_step(jtrainer, trainable, frozen, batch, key=KEY, sparse_frames=None):
    """(loss, grad_norm, grads, trainable after one update, aux) of the JAX
    trainer's step on ``trainable`` ({"adapter"[, "router"]}), as numpy
    trees: the body of its ``train_step`` with the gradients returned too."""
    opt_state = jtrainer.init_optimizer(trainable)
    idx = None if sparse_frames is None else jnp.asarray(sparse_frames, jnp.int32)

    def step(trainable, opt_state, frozen, batch, rng, idx):
        with grad_safe_blocks():
            (loss, aux), grads = jax.value_and_grad(jtrainer._loss, has_aux=True)(
                trainable, frozen, batch, rng, idx)
        updates, _ = jtrainer.optimizer.update(grads, opt_state, trainable)
        return (loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates),
                aux)

    out = jax.jit(step)(trainable, opt_state, frozen, jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(key), idx)
    return jax.tree.map(np.asarray, out)


def _jax_step(setup, cfg, sparse_frames=None):
    (unet, cnet, adapter, vae), params, batch = setup
    trainer = JTrainer(JTrainConfig(**cfg), unet, cnet, adapter, vae)
    frozen = {"unet": params["unet"], "vae": params["vae"], "controlnet_0": params["controlnet"]}
    return jax_step(trainer, {"adapter": params["adapter"]}, frozen, batch,
                    sparse_frames=sparse_frames)


def jax_draws(shape, key=KEY, ddim=False):
    """The JAX ``_loss``'s five draws for ``PRNGKey(key)`` at ``shape`` = (b,
    f, lh, lw), as the port's ``CtrlAdapterTrainer.draw`` lays them out; the
    "time" draw is the DDIM branches' integer timestep with ``ddim``."""
    b, f, lh, lw = shape
    names = ("vae", "noise", "offset", "time", "dropout")
    k = dict(zip(names, jax.random.split(jax.random.PRNGKey(key), 5)))
    draws = {"vae": jax.random.normal(k["vae"], (b * f, lh, lw, 4), jnp.float32),
             "noise": jax.random.normal(k["noise"], (b, f, lh, lw, 4), jnp.float32),
             "offset": jax.random.normal(k["offset"], (b, 1, 1, 1, 4), jnp.float32),
             "time": (jax.random.randint(k["time"], (b,), 0, 1000) if ddim
                      else jax.random.uniform(k["time"], (b,))),
             "dropout": jax.random.uniform(k["dropout"], (b,))}
    return {name: torch.from_numpy(np.array(v)) for name, v in draws.items()}


def _port_trainer(params, cfg):
    unet = port(UNetSpatioTemporalConditionModel(SVDUNetConfig(**THIN_UNET.__dict__)),
                params["unet"])
    cnet = port(ControlNetModel(ControlNetConfig(
        block_out_channels=CNET_CFG.block_out_channels,
        num_attention_heads=CNET_CFG.num_attention_heads,
        cross_attention_dim=CNET_CFG.cross_attention_dim,
        conditioning_embedding_out_channels=CNET_CFG.conditioning_embedding_out_channels,
        norm_num_groups=CNET_CFG.norm_num_groups)), params["controlnet"])
    vae = port(AutoencoderKLTemporalDecoder(VAEConfig(**THIN_VAE, layers_per_block=1)),
               params["vae"])
    adapter = _port_adapter()
    trainer = CtrlAdapterTrainer(TrainConfig(**cfg), unet, cnet, adapter, vae, device="cpu")
    trainer.load_masters(state_dict_from_jax(adapter, params["adapter"], dtype=torch.float32))
    return trainer


def _flat(tree, prefix=()):
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _torch_layout(path, arr):
    return arr.transpose(_TO_TORCH[arr.ndim]) if path[-1] == "kernel" else arr


def check_step(trainer, metrics, jax_out, lr=LR, noise_floor=False):
    """The port's step (``metrics`` of ``trainer.train_step``) against the
    JAX trainer's (``jax_step``): loss and grad_norm, every gradient and
    master of the adapter and the router, and the router's weights.

    With ``noise_floor``, a tensor whose JAX gradient lies within the
    gradient check's rounding allowance (3e-5 of the global norm) has its
    master held to one update (lr) instead of 0.1 lr: its gradient is fp32
    rounding noise that a GroupNorm's shift invariance leaves of an exact 0
    (a bias feeding a norm of one channel per group, as in the thin
    adapters' 32-channel first blocks), below Adam's eps, where the first
    update lr * g / (|g| + eps) follows the noise. The router's weights:
    1e-6, or 1e-4 for the routers that read the timestep sinusoid."""
    loss_j, norm_j, grads_j, new_j, aux_j = jax_out
    assert float(metrics["loss"]) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(float(norm_j), rel=1e-5)
    opt = trainer.optimizer
    n = len(trainer.names)
    parts = [("adapter", trainer.names, slice(0, n))]
    if trainer.router is not None:
        parts.append(("router", trainer.router_names, slice(n, None)))
    assert sum(len(names) for _, names, _ in parts) == len(opt.params)
    bad = []
    for module, names, sl in parts:
        gj_tree, nj_tree = _flat(grads_j[module]), _flat(new_j[module])
        assert len(gj_tree) == len(names)
        for name, p, master in zip(names, opt.params[sl], opt.masters[sl]):
            path = jax_path(name, p.dim())
            gj = _torch_layout(path, gj_tree[path])
            gp = np.zeros_like(gj) if p.grad is None else p.grad.numpy()
            err = np.linalg.norm(gp - gj)
            if err > 1e-3 * np.linalg.norm(gj) + 3e-5 * float(norm_j):
                bad.append(("grad", module, name, err, np.linalg.norm(gj)))
            moved = np.abs(master.numpy() - _torch_layout(path, nj_tree[path])).max() / lr
            noise = noise_floor and np.linalg.norm(gj) <= 3e-5 * float(norm_j)
            if moved > (1.0 if noise else 0.1):
                bad.append(("master", module, name, moved))
    assert not bad, bad[:10]
    assert set(aux_j) == {k for k in metrics if k.endswith("_block_weights")}
    # the timestep sinusoid differs from XLA's by up to 3e-5, hence 1e-4 for
    # the routers that read it, as tests/test_torch_i2vgen_modules.py holds them
    atol = 1e-4 if trainer.router is not None and "timestep" in trainer.router.router_type else 1e-6
    for name, want in aux_j.items():
        np.testing.assert_allclose(metrics[name].numpy(), want, rtol=0, atol=atol)


def _check_step(setup, cfg, sparse_frames=None):
    _, params, batch = setup
    jax_out = _jax_step(setup, cfg, sparse_frames)
    trainer = _port_trainer(params, cfg)
    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 sparse_frames=sparse_frames, draws=jax_draws((B, F, HW, HW)))
    check_step(trainer, metrics, jax_out)


def test_svd_train_step_matches_jax(setup):
    """Loss, grad_norm, every adapter gradient and the masters after one update
    of the port's step against the JAX trainer's (dense; dropout drawn to fire;
    gradient checkpointing on)."""
    _check_step(setup, CFG)


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["sparse-frames", "no-dropout"])
def test_svd_train_step_variants_match_jax(setup, variant):
    """The same check with key frames (0, 2) through the adapter, or without
    conditioning dropout; each is one more whole-step JAX compile."""
    if variant == "sparse-frames":
        _check_step(setup, CFG, sparse_frames=(0, 2))
    else:
        _check_step(setup, dict(CFG, conditioning_dropout_prob=0.0))


# ------------------------------------------------- the port against itself
def _thin_port_trainer(cfg=CFG, seed=0):
    """A port trainer on the thin towers with torch-random weights (no JAX)."""
    g = torch.Generator().manual_seed(seed)
    unet = UNetSpatioTemporalConditionModel(SVDUNetConfig(**THIN_UNET.__dict__))
    cnet = ControlNetModel(ControlNetConfig(
        block_out_channels=CNET_CFG.block_out_channels,
        num_attention_heads=CNET_CFG.num_attention_heads,
        cross_attention_dim=CNET_CFG.cross_attention_dim,
        conditioning_embedding_out_channels=CNET_CFG.conditioning_embedding_out_channels,
        norm_num_groups=CNET_CFG.norm_num_groups))
    vae = AutoencoderKLTemporalDecoder(VAEConfig(**THIN_VAE, layers_per_block=1))
    adapter = _port_adapter()
    with torch.no_grad():
        for module in (unet, cnet, vae, adapter):
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return CtrlAdapterTrainer(TrainConfig(**cfg), unet, cnet, adapter, vae, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    arrays = {"frames": rng.uniform(-1, 1, (B, F, 64, 64, 3)),
              "controlnet_cond": rng.uniform(0, 1, (1, N, 64, 64, 3)),
              "controlnet_text_emb": rng.standard_normal((B, 7, 24)) * 0.5,
              "image_embeddings": rng.standard_normal((B, 1, 32)) * 0.5}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}


def _grads(trainer, batch, draws, sparse_frames=None):
    for p in trainer.optimizer.params:
        p.grad = None
    loss = trainer.loss(batch, draws, sparse_frames)
    loss.backward()
    return loss.item(), [None if p.grad is None else p.grad.clone()
                         for p in trainer.optimizer.params]


def _same_step(a, b):
    """Two (loss, gradients) of one step through differently laid out but
    equal computations: equal to fp32 summation order (1e-5 relative, and
    1e-6 of the largest gradient element for the near-zero ones)."""
    assert a[0] == pytest.approx(b[0], rel=1e-6)
    scale = max(y.abs().max().item() for y in b[1] if y is not None)
    for x, y in zip(a[1], b[1]):
        assert (x is None) == (y is None)
        if x is not None:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * scale)


def test_sparse_frames_gather_and_scatter():
    """Key frames run the adapter on their residuals only and the UNet gets
    zeros at the other frames (the JAX gather/scatter, ``trainer.py:280-323``):
    with every frame as a key frame the step equals the dense one, and with
    (0, 2) the UNet's residuals are the adapter's output on frames 0 and 2 and
    zeros at frames 1 and 3. (A step of the port with key frames (0, 2)
    against the JAX trainer's is a slow test above.)"""
    trainer = _thin_port_trainer()
    batch = _batch()
    draws = trainer.draw(torch.Generator().manual_seed(1), B, F, HW, HW)
    dense = _grads(trainer, batch, draws)
    every = _grads(trainer, batch, draws, sparse_frames=range(F))
    _same_step(dense, every)

    seen = {}
    adapter_hook = trainer.adapter.register_forward_hook(
        lambda m, args, out: seen.update(adapter_in=args[0], adapter_out=out[0]))
    unet_hook = trainer.unet.register_forward_pre_hook(
        lambda m, args: seen.update(unet_res=args[4]))
    try:
        _grads(trainer, batch, draws, sparse_frames=(0, 2))
    finally:
        adapter_hook.remove()
        unet_hook.remove()
    assert seen["adapter_in"][0].shape[0] == 2
    for adapted, res in zip(seen["adapter_out"], seen["unet_res"]):
        assert res.shape[0] == N
        assert torch.equal(res[[0, 2]], adapted) and not res[[1, 3]].any()


def test_gradient_checkpointing_is_numerics_neutral():
    """Recomputing the adapter and the UNet in the backward changes the step
    by no more than fp32 summation order."""
    batch = _batch(1)
    results = []
    for remat in (True, False):
        trainer = _thin_port_trainer(dict(CFG, gradient_checkpointing=remat))
        draws = trainer.draw(torch.Generator().manual_seed(2), B, F, HW, HW)
        results.append(_grads(trainer, batch, draws))
    _same_step(*results)


def test_checkpoint_round_trip(tmp_path):
    """A checkpoint in the reference layout restores the masters and the
    optimizer state exactly: a step from the restored trainer equals a step
    from the one that saved it."""
    cfg = dict(CFG, gradient_accumulation_steps=2)
    trainer = _thin_port_trainer(cfg)
    batch = _batch(2)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):  # one update and one accumulated gradient pending
        trainer.train_step(batch, generator=gen)
    ckpt = checkpoints.save_checkpoint(str(tmp_path), 3, trainer.adapter_state(),
                                       trainer.optimizer.state_dict(), {"model_name": "svd"})
    assert sorted(os.listdir(ckpt)) == ["adapter_3", "config.json", "optimizer"]
    loaded = checkpoints.load_checkpoint(ckpt, 3)
    restored = _thin_port_trainer(cfg)  # the same frozen towers, a zeroed adapter
    restored.load_masters({k: torch.zeros_like(v) for k, v in loaded["adapter"].items()})
    restored.load_masters(loaded["adapter"])
    restored.optimizer.load_state_dict(loaded["optimizer"])
    assert loaded["config"] == {"model_name": "svd"}
    for a, b in zip(trainer.optimizer.masters, restored.optimizer.masters):
        assert torch.equal(a, b)
    draws = trainer.draw(torch.Generator().manual_seed(4), B, F, HW, HW)
    for t in (trainer, restored):
        t.train_step(batch, draws=draws)
    assert trainer.optimizer.update_count == restored.optimizer.update_count == 2
    for a, b in zip(trainer.optimizer.masters, restored.optimizer.masters):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change", [dict(snr_gamma=5.0)])
def test_trainer_refuses_what_is_not_ported(change):
    trainer = _thin_port_trainer()
    with pytest.raises(NotImplementedError):
        CtrlAdapterTrainer(TrainConfig(**dict(CFG, **change)), trainer.unet, trainer.controlnet,
                           trainer.adapter, trainer.vae, device="cpu")


def test_trainer_needs_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = _thin_port_trainer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CtrlAdapterTrainer(TrainConfig(**CFG), t.unet, t.controlnet, t.adapter, t.vae)


def test_train_step_draws_from_the_generator():
    """Without draws, the step takes them from the generator: the same seed
    gives the same step, another seed another one."""
    batch = _batch(3)
    losses = []
    for seed in (5, 5, 6):
        trainer = _thin_port_trainer()
        losses.append(float(trainer.train_step(batch, generator=torch.Generator().manual_seed(
            seed))["loss"]))
    assert losses[0] == losses[1] != losses[2]
