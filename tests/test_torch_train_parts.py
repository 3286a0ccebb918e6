"""The parts of the port's training step against the JAX package, on the CPU.

- ``sample_training_sigmas_timesteps`` on the Karras table of 1000 sigmas;
- the temporal VAE's ``encode_moments`` (thin config, fp32);
- the four losses (``mse_loss``, ``compute_snr``, ``min_snr_loss``,
  ``edm_loss``) and ``fuse_expert_residuals`` (routerless and weighted);
- the optimizer (``MasterOptimizer``): each lr schedule with warmup against
  the JAX trainer's optax schedule, and clip + AdamW under gradient
  accumulation 2 against the JAX trainer's optax chain over 5 updates, with
  gradients that do and do not trigger the clip;
- the port (package, ``chip_smoke.py`` and the two CLIs) imports no JAX,
  optax, orbax, JAX-package module or yaml;
- DDIM's ``add_noise`` and ``get_velocity`` against JAX's, indexing the alphas
  on the timesteps' device (a ``meta`` run: no copy to the host);
- on a thin I2VGen-XL trainer with random weights (no JAX): the DDIM
  branches' integer timestep draws come from the generator, and a checkpoint
  with a router (``router_{step}/``) restores the adapter's and the router's
  masters and the optimizer exactly.

Tolerances: exact for the sampler's indices; 1e-6 relative for the losses and
the schedules (fp32 against fp64/fp32 arithmetic); 2e-5 absolute for the VAE
moments (the tests/test_torch_port_modules.py bound); the optimizer's params
within 1e-7 + 1e-6 relative after 5 updates.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ctrl_adapter_tpu.models.router import fuse_expert_residuals as j_fuse
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JVAE
from ctrl_adapter_tpu.schedulers.ddim import DDIMConfig, DDIMScheduler
from ctrl_adapter_tpu.schedulers.euler_discrete import karras_sigmas as j_karras
from ctrl_adapter_tpu.schedulers.euler_discrete import sample_training_sigmas_timesteps as j_sample
from ctrl_adapter_tpu.train import losses as jl
from ctrl_adapter_tpu.train.trainer import CtrlAdapterTrainer as JTrainer
from ctrl_adapter_tpu.train.trainer import TrainConfig as JTrainConfig
from ctrl_adapter_tpu.train.trainer import _build_lr_schedule
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter, fuse_expert_residuals
from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
from ctrl_adapter_tpu_torch.schedulers.ddim import DDIMConfig as TDDIMConfig
from ctrl_adapter_tpu_torch.schedulers.ddim import DDIMScheduler as TDDIMScheduler
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.schedulers.euler_discrete import (karras_sigmas,
                                                              sample_training_sigmas_timesteps)
from ctrl_adapter_tpu_torch.train import checkpoints
from ctrl_adapter_tpu_torch.train import losses as tl
from ctrl_adapter_tpu_torch.train.trainer import (CtrlAdapterTrainer, MasterOptimizer,
                                                  TrainConfig, build_lr_schedule)

from .test_torch_i2vgen_modules import THIN_UNET as THIN_I2V_UNET
from .test_torch_i2vgen_modules import THIN_VAE as THIN_2D_VAE
from .test_torch_port_modules import THIN_VAE
from .test_torch_train_i2vgen import ADAPTER as I2V_ADAPTER
from .test_torch_train_i2vgen import _batch as i2v_batch
from .test_video_pipelines import CNET_CFG
from .torch_port_common import assert_close, nchw_to_nhwc, nhwc_to_nchw, port, port_config
from .utils import fake_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_training_sigma_sampler_matches_jax():
    rng = np.random.default_rng(30)
    uniform = np.concatenate([rng.uniform(0, 1, 64), [0.0, 0.999999]]).astype(np.float32)
    table = np.asarray(j_karras(1000))
    np.testing.assert_array_equal(karras_sigmas(1000), table)
    ju, js = j_sample(jnp.asarray(uniform), jnp.asarray(table), 25)
    tu, ts = sample_training_sigmas_timesteps(torch.from_numpy(uniform),
                                              torch.from_numpy(table), 25)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))  # the same table entries
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6)
    np.testing.assert_array_equal(np.round(tu.numpy() * 1000), np.round(np.asarray(ju) * 1000))


def test_encode_moments_matches_jax():
    rng = np.random.default_rng(31)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jmod = JVAE(config=JVAEConfig(**THIN_VAE, layers_per_block=1))
    params = fake_init(jmod, jnp.ones((1, 64, 64, 3)), seed=32, scale=0.05)
    jmean, jlogvar = jax.jit(lambda p, a: jmod.apply(p, a, method="encode_moments"))(params, x)
    tmod = port(AutoencoderKLTemporalDecoder(VAEConfig(**THIN_VAE, layers_per_block=1)), params)
    with torch.no_grad():
        mean, logvar = tmod.encode_moments(nhwc_to_nchw(x))
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(0))
        sample = tmod.encode(nhwc_to_nchw(x), noise)
    assert_close(nchw_to_nhwc(mean), jmean, atol=2e-5, what="mean")
    assert_close(nchw_to_nhwc(logvar), jlogvar, atol=2e-5, what="logvar")
    assert float(logvar.min()) >= -30.0 and float(logvar.max()) <= 20.0
    assert torch.equal(sample, mean + torch.exp(0.5 * logvar) * noise)


def test_losses_match_jax():
    rng = np.random.default_rng(33)
    pred, target, x_t = (rng.standard_normal((3, 4, 4, 8, 8)).astype(np.float32)
                         for _ in range(3))
    sigmas = rng.uniform(0.01, 50, 3).astype(np.float32)
    t = np.array([0, 500, 999])
    acp = np.array(DDIMScheduler(DDIMConfig()).alphas_cumprod)
    T = torch.from_numpy  # noqa: N806
    pairs = [
        (tl.mse_loss(T(pred), T(target)), jl.mse_loss(pred, target)),
        (tl.compute_snr(T(acp), T(t)), jl.compute_snr(jnp.asarray(acp), jnp.asarray(t))),
        (tl.min_snr_loss(T(pred), T(target), T(acp), T(t), 5.0),
         jl.min_snr_loss(pred, target, jnp.asarray(acp), jnp.asarray(t), 5.0)),
        (tl.edm_loss(T(pred), T(x_t), T(target), T(sigmas)),
         jl.edm_loss(pred, x_t, target, jnp.asarray(sigmas))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True], ids=["routerless", "weighted"])
def test_fuse_expert_residuals_matches_jax(weighted):
    rng = np.random.default_rng(34)
    e, k = 3, 4
    downs = [[rng.standard_normal((2, 5, 3, 3)).astype(np.float32) for _ in range(k)]
             for _ in range(e)]
    mids = [rng.standard_normal((2, 7, 1, 1)).astype(np.float32) for _ in range(e)]
    dw = rng.uniform(0, 1, (k, e)).astype(np.float32) if weighted else None
    mw = rng.uniform(0, 1, e).astype(np.float32) if weighted else None
    jd, jm = j_fuse(downs, mids, None if dw is None else jnp.asarray(dw),
                    None if mw is None else jnp.asarray(mw))
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731,N806
    td, tm = fuse_expert_residuals([[T(r) for r in d] for d in downs], [T(m) for m in mids],
                                   T(dw), T(mw))
    for got, want in zip(td, jd):
        assert_close(got.numpy(), want, atol=1e-6, what="down")
    assert_close(tm.numpy(), jm, atol=1e-6, what="mid")
    # weighted downs without mid weights drop the mid residual, as in JAX
    if weighted:
        assert fuse_expert_residuals([[T(r) for r in d] for d in downs], [T(m) for m in mids],
                                     T(dw), None)[1] is None


@pytest.mark.parametrize("schedule", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(schedule):
    cfg = dict(lr_scheduler=schedule, lr_warmup_steps=3, max_train_steps=12)
    want = _build_lr_schedule(JTrainConfig(**cfg))
    got = build_lr_schedule(TrainConfig(**cfg))
    for n in range(15):
        assert got(n) == pytest.approx(float(want(n)), rel=1e-6, abs=1e-12), n
    no_warm = build_lr_schedule(TrainConfig(lr_scheduler=schedule, max_train_steps=12))
    assert no_warm(0) == pytest.approx(5e-5)


@pytest.mark.parametrize("scale", [1.0, 400.0], ids=["unclipped", "clipped"])
def test_optimizer_matches_optax(scale):
    """Clip + AdamW under gradient accumulation 2 with a linear warmup over 5
    updates (10 gradients), against the JAX trainer's optax chain."""
    cfg = dict(lr_scheduler="constant_with_warmup", lr_warmup_steps=2, learning_rate=1e-2,
               gradient_accumulation_steps=2)
    rng = np.random.default_rng(35)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jtrainer = JTrainer(JTrainConfig(**cfg), None, None, None, None)
    jparams = [jnp.asarray(p) for p in params]
    state = jtrainer.optimizer.init(jparams)
    update = jax.jit(jtrainer.optimizer.update)
    module = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = MasterOptimizer(TrainConfig(**cfg), module)
    for i in range(10):
        grads = [(rng.standard_normal(s) * 0.1 * scale).astype(np.float32) for s in shapes]
        updates, state = update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert opt.step([torch.from_numpy(g) for g in grads]) == (i % 2 == 1)
        for got, want in zip(module, jparams):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-7)
    assert opt.update_count == 5


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_optax_orbax():
    """No import statement of the port's package (its ``parallel/`` package
    included), of ``chip_smoke.py``, ``inference_torch.py`` or
    ``train_torch.py`` names jax, flax, optax, orbax, the JAX package
    (``ctrl_adapter_tpu``) or yaml (the card's host has no PyYAML;
    ``config.load_yaml`` reads the configs itself)."""
    pkg = os.path.join(REPO, "ctrl_adapter_tpu_torch")
    files = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "inference_torch.py", "train_torch.py")] + [
        os.path.join(d, f) for d, _, names in os.walk(pkg) for f in names if f.endswith(".py")]
    assert len(files) > 30
    assert os.path.join(pkg, "parallel", "mesh.py") in files
    banned = ("jax", "flax", "optax", "orbax", "ctrl_adapter_tpu", "yaml")
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert not bad, bad


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddim_add_noise_and_velocity_match_jax(prediction):
    """``add_noise`` and ``get_velocity`` index the alphas on the timesteps'
    device and give JAX's values (and those of the host table's lookup, to
    the bit); on the ``meta`` device they run without a copy to the host."""
    rng = np.random.default_rng(36)
    x0, noise = (rng.standard_normal((3, 2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    t = np.array([0, 517, 999])
    jsched = DDIMScheduler(DDIMConfig(prediction_type=prediction))
    tsched = TDDIMScheduler(TDDIMConfig(prediction_type=prediction))
    T = torch.from_numpy  # noqa: N806
    for name in ("add_noise", "get_velocity"):
        got = getattr(tsched, name)(T(x0), T(noise), T(t))
        want = getattr(jsched, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        acp = tsched.alphas_cumprod[T(t)].reshape(3, 1, 1, 1, 1)
        host = (acp ** 0.5 * T(x0) + (1 - acp) ** 0.5 * T(noise) if name == "add_noise"
                else acp ** 0.5 * T(noise) - (1 - acp) ** 0.5 * T(x0))
        assert torch.equal(got, host)
        meta = getattr(tsched, name)(*(torch.empty(a.shape, device="meta") for a in (x0, noise)),
                                     torch.zeros(3, dtype=torch.int64, device="meta"))
        assert meta.device.type == "meta" and meta.shape == x0.shape
    assert tsched.alphas_cumprod_on("meta") is tsched.alphas_cumprod_on("meta")


# ------------------------------- a thin I2VGen-XL trainer, random weights
def _thin_i2v_trainer(num_experts=1, seed=0, **cfg):
    """A port I2VGen-XL trainer on the thin towers of
    ``tests/test_torch_train_i2vgen.py`` with torch-random weights (no JAX);
    with more than one expert a simple-weights router."""
    g = torch.Generator().manual_seed(seed)
    unet = I2VGenXLUNet(I2VGenXLUNetConfig(**THIN_I2V_UNET))
    nets = [ControlNetModel(port_config(ControlNetConfig, CNET_CFG)) for _ in range(num_experts)]
    vae = AutoencoderKL(VAEConfig(**THIN_2D_VAE))
    adapter = ControlNetAdapter(backbone_model_name="i2vgenxl", **I2V_ADAPTER)
    router = ControlNetRouter(num_experts, "simple_weights") if num_experts > 1 else None
    with torch.no_grad():
        for module in (unet, *nets, vae, adapter):
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    config = TrainConfig(**dict(dict(model_name="i2vgenxl", n_sample_frames=4,
                                     control_latent_size=8, num_experts=num_experts), **cfg))
    return CtrlAdapterTrainer(config, unet, MultiControlNetModel(nets) if router else nets[0],
                              adapter, vae, router=router, device="cpu")


def _torch_batch(num_experts):
    return {k: torch.from_numpy(v) for k, v in i2v_batch(num_experts, seed=1).items()}


def test_ddim_train_step_draws_from_the_generator():
    """The DDIM branches draw an integer timestep in [0, 1000) from the
    generator: the same seed gives the same step, another seed another."""
    trainer = _thin_i2v_trainer()
    draws = trainer.draw(torch.Generator().manual_seed(5), 3, 4, 8, 8)
    assert draws["time"].dtype == torch.int64 and draws["time"].shape == (3,)
    assert 0 <= int(draws["time"].min()) and int(draws["time"].max()) < 1000
    batch = _torch_batch(1)
    losses = []
    for seed in (5, 5, 6):
        trainer = _thin_i2v_trainer()
        gen = torch.Generator().manual_seed(seed)
        losses.append(float(trainer.train_step(batch, generator=gen)["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_router_checkpoint_round_trip(tmp_path):
    """With a router, a checkpoint holds ``router_{step}/`` beside
    ``adapter_{step}/`` under the router's diffusers names, and restores both
    modules' masters and the optimizer state over both exactly: a step from
    the restored trainer equals a step from the one that saved it."""
    trainer = _thin_i2v_trainer(3)
    batch = _torch_batch(3)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        metrics = trainer.train_step(batch, generator=gen)
    assert metrics["down_block_weights"].shape == (12, 3)
    router_state = trainer.router_state()
    assert set(router_state) == ({f"down_blocks_router.{i}.wg.weight" for i in range(12)}
                                 | {"mid_block_router.wg.weight"})
    ckpt = checkpoints.save_checkpoint(str(tmp_path), 2, trainer.adapter_state(),
                                       trainer.optimizer.state_dict(),
                                       {"model_name": "i2vgenxl"}, router_state=router_state)
    assert sorted(os.listdir(ckpt)) == ["adapter_2", "config.json", "optimizer", "router_2"]
    loaded = checkpoints.load_checkpoint(ckpt, 2)
    restored = _thin_i2v_trainer(3)  # the same frozen towers and a fresh router
    restored.load_masters(loaded["adapter"], loaded["router"])
    restored.optimizer.load_state_dict(loaded["optimizer"])
    for a, b in zip(trainer.optimizer.masters, restored.optimizer.masters):
        assert torch.equal(a, b)
    for name, p in restored.router.named_parameters():
        assert torch.equal(p, router_state[name])
    draws = trainer.draw(torch.Generator().manual_seed(4), 1, 4, 8, 8)
    for t in (trainer, restored):
        t.train_step(batch, draws=draws)
    for a, b in zip(trainer.optimizer.masters, restored.optimizer.masters):
        assert torch.equal(a, b)
