"""The parts of the port's training step against the JAX package, on the CPU.

- ``sample_training_sigmas_timesteps`` on the Karras table of 1000 sigmas;
- the temporal VAE's ``encode_moments`` (thin config, fp32);
- the four losses (``mse_loss``, ``compute_snr``, ``min_snr_loss``,
  ``edm_loss``) and ``fuse_expert_residuals`` (routerless and weighted);
- the optimizer (``MasterOptimizer``): each lr schedule with warmup against
  the JAX trainer's optax schedule, and clip + AdamW under gradient
  accumulation 2 against the JAX trainer's optax chain over 5 updates, with
  gradients that do and do not trigger the clip;
- the port (package and ``chip_smoke.py``) imports no JAX, optax, orbax or
  JAX-package module.

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
from ctrl_adapter_tpu_torch.models.router import fuse_expert_residuals
from ctrl_adapter_tpu_torch.models.vae import VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.schedulers.euler_discrete import (karras_sigmas,
                                                              sample_training_sigmas_timesteps)
from ctrl_adapter_tpu_torch.train import losses as tl
from ctrl_adapter_tpu_torch.train.trainer import MasterOptimizer, TrainConfig, build_lr_schedule

from .test_torch_port_modules import THIN_VAE
from .torch_port_common import assert_close, nchw_to_nhwc, nhwc_to_nchw, port
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
    """No import statement of the port's package or of ``chip_smoke.py`` names
    jax, flax, optax, orbax or the JAX package (``ctrl_adapter_tpu``)."""
    pkg = os.path.join(REPO, "ctrl_adapter_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, names in os.walk(pkg) for f in names if f.endswith(".py")]
    assert len(files) > 30
    banned = ("jax", "flax", "optax", "orbax", "ctrl_adapter_tpu")
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert not bad, bad
