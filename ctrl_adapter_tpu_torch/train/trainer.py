"""The SVD training step of Ctrl-Adapter: the adapter trains, the towers are frozen.

Counterpart of ``ctrl_adapter_tpu/train/trainer.py`` (its SVD branch) and of
the optimizer recipe it builds from optax, kept here in its own code:

- the lr schedules of ``_build_lr_schedule``, indexed by the update count
  (0 at the first update);
- ``clip_by_global_norm`` with optax's rule: g * max / ||g|| only where
  ||g|| >= max;
- AdamW (``torch.optim.AdamW``, whose decoupled decay is optax's ``adamw``);
- ``gradient_accumulation_steps`` as ``optax.MultiSteps``: the running mean of
  k gradients (Welford's update), one optimizer update every k steps;
- ``grad_norm``, the global norm of the step's gradients before clipping.

Mixed precision as flax's ``dtype=bf16, param_dtype=fp32``: the adapter module
computes in its own dtype (bf16 on the card) while the optimizer holds fp32
master weights; the module's gradients are cast to fp32, and the masters are
copied back into the module after each update.

The step is split so that a test can feed the JAX trainer's own random draws:
:meth:`CtrlAdapterTrainer.draw` draws the five tensors of the JAX ``_loss``
(VAE noise, noise, noise offset, the uniform for the sigma index, the dropout
uniform) from an explicit ``torch.Generator``, in the JAX layouts, and
:meth:`CtrlAdapterTrainer.loss` is deterministic given them. Batches are in
the JAX layouts too: frames (b, f, H, W, 3) in [-1, 1], ``controlnet_cond``
(E, b*f, H, W, 3), ``image_embeddings`` (b, 1, 1024), ``controlnet_text_emb``
(b, 77, 768).

Only the SVD branch with one ControlNet expert and no router is ported; the
I2VGen-XL and SDXL branches wait for their UNets and router training for the
router (ROADMAP Queue 1 items 9-10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..models.router import fuse_expert_residuals
from ..ops.resize import adaptive_avg_pool2d
from ..schedulers.euler_discrete import karras_sigmas, sample_training_sigmas_timesteps
from .losses import edm_loss

_NOT_PORTED = ("the port trains the SVD branch with one ControlNet expert and no router; "
               "the I2VGen-XL and SDXL branches and router training wait for ROADMAP "
               "Queue 1 items 9-10")


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` (``train/trainer.py:41-77``)."""
    model_name: str = "i2vgenxl"  # "svd" only in the port
    learning_rate: float = 5e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    noise_offset: float = 0.05
    snr_gamma: Optional[float] = None
    n_sample_frames: int = 16
    output_fps: int = 16
    num_inference_steps: int = 25  # SVD sigma-sampler alignment
    train_noise_aug: float = 0.02
    conditioning_dropout_prob: float = 0.1
    vae_scaling_factor: float = 0.18215
    control_latent_size: int = 64
    skip_conv_in: bool = False
    skip_time_emb: bool = False
    guess_mode: bool = False
    prediction_type: str = "epsilon"
    num_experts: int = 1
    train_router: bool = False
    fixed_controlnet_timestep: int = -1  # >= 0: constant ControlNet timestep
    latent_nan_checking: bool = False
    gradient_accumulation_steps: int = 1
    lr_scheduler: str = "constant"  # constant | constant_with_warmup | linear | cosine
    lr_warmup_steps: int = 0
    max_train_steps: int = 50000
    max_vae_encode: Optional[int] = None
    gradient_checkpointing: bool = True


def build_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at update count ``n`` (0 at the first update): optax's
    ``constant_schedule``, ``linear_schedule`` or ``cosine_decay_schedule`` over
    ``max_train_steps - lr_warmup_steps``, behind a linear warmup from 0 joined
    at ``lr_warmup_steps`` (``join_schedules``)."""
    base, warm = cfg.learning_rate, cfg.lr_warmup_steps
    horizon = max(1, cfg.max_train_steps - warm)
    if cfg.lr_scheduler in ("constant", "constant_with_warmup"):
        tail = lambda n: base  # noqa: E731
    elif cfg.lr_scheduler == "linear":
        tail = lambda n: _linear(base, 0.0, horizon, n)  # noqa: E731
    elif cfg.lr_scheduler == "cosine":
        tail = lambda n: base * 0.5 * (1.0 + math.cos(  # noqa: E731
            math.pi * min(max(n, 0), horizon) / horizon))
    else:
        raise ValueError(f"unknown lr_scheduler: {cfg.lr_scheduler}")
    if not warm:
        return tail
    return lambda n: _linear(0.0, base, warm, n) if n < warm else tail(n - warm)


def _linear(init: float, end: float, steps: int, n: int) -> float:
    """optax.linear_schedule(init, end, steps) at count n."""
    return (init - end) * (1.0 - min(max(n, 0), steps) / steps) + end


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class MasterOptimizer:
    """The JAX trainer's optimizer on fp32 master copies of ``params``:
    ``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, ...))``,
    under ``optax.MultiSteps`` when ``gradient_accumulation_steps`` > 1. After
    each update the masters are copied into ``params`` (in their dtype)."""

    def __init__(self, config: TrainConfig, params: Sequence[torch.Tensor]):
        self.config = config
        self.params = list(params)
        self.masters = [p.detach().float().clone() for p in self.params]
        self.adamw = torch.optim.AdamW(
            self.masters, lr=config.learning_rate, betas=(config.adam_beta1, config.adam_beta2),
            eps=config.adam_epsilon, weight_decay=config.adam_weight_decay)
        self.lr_schedule = build_lr_schedule(config)
        self.update_count = 0                  # optimizer updates so far
        self.mini_step = 0                     # gradients accumulated towards the next one
        self.acc_grads: Optional[List[torch.Tensor]] = None

    def step(self, grads: List[torch.Tensor]) -> bool:
        """Take one step's fp32 gradients (one per param); returns whether the
        masters were updated (every ``gradient_accumulation_steps`` calls)."""
        cfg = self.config
        k = cfg.gradient_accumulation_steps
        if k > 1:  # optax.MultiSteps: the running mean of k gradients
            if self.mini_step == 0:
                self.acc_grads = [g.clone() for g in grads]
            else:
                for a, g in zip(self.acc_grads, grads):
                    a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                return False
            self.mini_step = 0
            grads, self.acc_grads = self.acc_grads, None
        norm = global_norm(grads)
        if norm.item() >= cfg.max_grad_norm:  # optax.clip_by_global_norm
            grads = [g / norm * cfg.max_grad_norm for g in grads]
        for m, g in zip(self.masters, grads):
            m.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_schedule(self.update_count)
        self.adamw.step()
        self.update_count += 1
        for m in self.masters:
            m.grad = None
        self.sync()
        return True

    def sync(self) -> None:
        """Copy the masters into the params."""
        with torch.no_grad():
            for p, m in zip(self.params, self.masters):
                p.copy_(m)

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "update_count": self.update_count,
                "mini_step": self.mini_step, "acc_grads": self.acc_grads}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.update_count, self.mini_step = state["update_count"], state["mini_step"]
        acc = state["acc_grads"]
        self.acc_grads = None if acc is None else [a.to(self.masters[0].device) for a in acc]


class CtrlAdapterTrainer:
    """The frozen SVD UNet, ControlNet and temporal VAE, the trainable adapter
    with its fp32 masters and AdamW state, and the training step."""

    def __init__(self, config: TrainConfig, unet, controlnet, adapter, vae, router=None,
                 device="cuda"):
        if config.model_name != "svd" or config.num_experts != 1 or router is not None:
            raise NotImplementedError(f"model_name={config.model_name!r}, num_experts="
                                      f"{config.num_experts}, router={router}: {_NOT_PORTED}")
        if config.snr_gamma:
            # the JAX SVD branch indexes the DDIM alphas with its continuous EDM
            # timesteps (0.25 log sigma), which JAX refuses: no reference to port
            raise NotImplementedError("snr_gamma with model_name='svd': the JAX trainer's "
                                      "min-SNR loss takes integer DDIM timesteps, which the "
                                      "SVD branch does not have")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CtrlAdapterTrainer: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        self.config = config
        self.unet, self.controlnet, self.adapter, self.vae = unet, controlnet, adapter, vae
        for tower in (unet, controlnet, vae):
            tower.requires_grad_(False).eval()
        self.adapter.train()
        self.names = [name for name, _ in adapter.named_parameters()]
        self.optimizer = MasterOptimizer(config, adapter.parameters())
        self.sigmas_table = torch.from_numpy(karras_sigmas(1000)).to(self.device)
        self.latent_factor = 2 ** (len(vae.config.block_out_channels) - 1)

    # ------------------------------------------------------------- weights
    def load_masters(self, state: Dict[str, torch.Tensor]) -> None:
        """Set the fp32 masters (and the module's weights) from a state dict
        keyed by the adapter's parameter names."""
        with torch.no_grad():
            for name, m in zip(self.names, self.optimizer.masters):
                m.copy_(state[name])
        self.optimizer.sync()

    def adapter_state(self) -> Dict[str, torch.Tensor]:
        """The fp32 masters by diffusers parameter name."""
        return dict(zip(self.names, self.optimizer.masters))

    # --------------------------------------------------------------- draws
    def draw(self, generator: Optional[torch.Generator], b: int, f: int, lh: int,
             lw: int) -> Dict[str, torch.Tensor]:
        """The five random tensors of one step, in the JAX ``_loss``'s order
        and layouts: "vae" (b*f, lh, lw, 4) and "noise" (b, f, lh, lw, 4)
        standard normal, "offset" (b, 1, 1, 1, 4) standard normal, "time" and
        "dropout" (b,) uniform in [0, 1)."""
        kw = dict(generator=generator, device=self.device, dtype=torch.float32)
        return {"vae": torch.randn((b * f, lh, lw, 4), **kw),
                "noise": torch.randn((b, f, lh, lw, 4), **kw),
                "offset": torch.randn((b, 1, 1, 1, 4), **kw),
                "time": torch.rand((b,), **kw), "dropout": torch.rand((b,), **kw)}

    # ---------------------------------------------------------------- loss
    def loss(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
             sparse_frames: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The SVD branch of the JAX ``_loss`` given the step's draws: a scalar
        fp32 loss whose graph reaches the adapter's parameters only."""
        cfg = self.config
        dev = self.device
        frames = batch["frames"].to(dev)
        b, f, h, w, _ = frames.shape
        with torch.no_grad():
            # VAE encode, in chunks of max_vae_encode frames where they divide b*f
            flat = frames.reshape(b * f, h, w, 3).permute(0, 3, 1, 2)
            chunk = cfg.max_vae_encode
            if not (chunk and chunk < b * f and (b * f) % chunk == 0):
                chunk = b * f
            moments = [self.vae.encode_moments(c) for c in flat.split(chunk)]
            mean = torch.cat([m for m, _ in moments]).float()
            logvar = torch.cat([v for _, v in moments]).float()
            latents = mean + torch.exp(0.5 * logvar) * draws["vae"].permute(0, 3, 1, 2)
            if cfg.latent_nan_checking:
                latents = torch.where(torch.isnan(latents), torch.zeros_like(latents), latents)
            lh, lw = latents.shape[-2:]
            latents = latents.reshape(b, f, 4, lh, lw) * cfg.vae_scaling_factor

            noise = draws["noise"].permute(0, 1, 4, 2, 3)
            if cfg.noise_offset:
                noise = noise + cfg.noise_offset * draws["offset"].permute(0, 1, 4, 2, 3)

            u, sigmas = sample_training_sigmas_timesteps(draws["time"], self.sigmas_table,
                                                         cfg.num_inference_steps)
            unet_timesteps = 0.25 * torch.log(sigmas)
            cn_timesteps = torch.round(u * 1000.0)
            if cfg.fixed_controlnet_timestep >= 0:
                cn_timesteps = torch.full((b,), float(cfg.fixed_controlnet_timestep),
                                          device=dev)

            # EDM noising and conditioning dropout
            sig = sigmas.reshape(b, 1, 1, 1, 1)
            small_noise = latents + noise * cfg.train_noise_aug
            cond_latents = small_noise[:, 0] / cfg.vae_scaling_factor  # (b, 4, lh, lw)
            noisy_4ch = latents + noise * sig
            noisy = noisy_4ch / (sig ** 2 + 1.0) ** 0.5
            image_embeddings = batch["image_embeddings"].to(dev)
            if cfg.conditioning_dropout_prob:
                p = cfg.conditioning_dropout_prob
                random_p = draws["dropout"]
                prompt_mask = (random_p < 2 * p)[:, None, None]
                image_embeddings = torch.where(prompt_mask, torch.zeros_like(image_embeddings),
                                               image_embeddings)
                image_mask = 1.0 - ((random_p >= p).float() * (random_p < 3 * p).float())
                cond_latents = cond_latents * image_mask[:, None, None, None]

            # the frozen ControlNet on the pooled noisy latents
            flat_noisy = noisy.reshape(b * f, 4, lh, lw)
            s = cfg.control_latent_size
            pooled = adaptive_avg_pool2d(flat_noisy, (s, s))
            cn_text = batch["controlnet_text_emb"].to(dev).repeat_interleave(f, dim=0)
            cond = batch["controlnet_cond"][0].to(dev).permute(0, 3, 1, 2)
            downs, mid = self.controlnet(pooled, cn_timesteps.repeat_interleave(f), cn_text,
                                         cond, skip_conv_in=cfg.skip_conv_in,
                                         guess_mode=cfg.guess_mode,
                                         skip_time_emb=cfg.skip_time_emb)
            fused_down, fused_mid = fuse_expert_residuals([downs], [mid])
            if "M" not in self.adapter.adapter_locations:
                fused_mid = None

            idx = None
            adapter_frames = f
            if sparse_frames is not None:
                idx = torch.as_tensor(list(sparse_frames), device=dev)
                adapter_frames = len(sparse_frames)
                fused_down = [d[idx] for d in fused_down]
                fused_mid = None if fused_mid is None else fused_mid[idx]

        def run_adapter(downs, mid, ehs):
            return self.adapter(downs, mid, num_frames=adapter_frames, timestep=cn_timesteps,
                                encoder_hidden_states=ehs)

        adapted_down, adapted_mid = self._maybe_checkpoint(run_adapter, fused_down, fused_mid,
                                                           image_embeddings)
        if idx is not None:  # dense re-scatter: zeros at the frames the adapter skipped
            def scatter(a):
                return torch.zeros((b * f, *a.shape[1:]), dtype=a.dtype,
                                   device=dev).index_copy(0, idx, a)
            adapted_down = [scatter(a) for a in adapted_down]
            adapted_mid = None if adapted_mid is None else scatter(adapted_mid)

        unet_in = torch.cat([noisy, cond_latents[:, None].expand(b, f, *cond_latents.shape[1:])],
                            dim=2)
        added_time_ids = torch.tensor(
            [[float(cfg.output_fps - 1), 127.0, cfg.train_noise_aug]], device=dev).repeat(b, 1)
        model_pred = self._maybe_checkpoint(self.unet, unet_in, unet_timesteps,
                                            image_embeddings, added_time_ids, adapted_down,
                                            adapted_mid)
        return edm_loss(model_pred, noisy_4ch, latents, sigmas)

    def _maybe_checkpoint(self, fn, *args):
        """``fn(*args)``, its activations recomputed in the backward under
        ``gradient_checkpointing`` (the JAX ``jax.checkpoint``)."""
        if self.config.gradient_checkpointing:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ---------------------------------------------------------------- step
    def train_step(self, batch: Dict[str, torch.Tensor],
                   sparse_frames: Optional[Sequence[int]] = None,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One step: the loss and its gradients for the adapter, then the
        optimizer (every ``gradient_accumulation_steps`` calls). ``draws``
        (from :meth:`draw`) replace the generator's when given. Returns
        {"loss", "grad_norm"} as 0-d fp32 tensors."""
        if draws is None:
            b, f, h, w, _ = batch["frames"].shape
            draws = self.draw(generator, b, f, h // self.latent_factor, w // self.latent_factor)
        params = self.optimizer.params
        for p in params:
            p.grad = None
        loss = self.loss(batch, draws, sparse_frames)
        loss.backward()
        grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
                 for p, m in zip(params, self.optimizer.masters)]
        grad_norm = global_norm(grads)
        self.optimizer.step(grads)
        return {"loss": loss.detach(), "grad_norm": grad_norm}
