"""The training step of Ctrl-Adapter: the adapter (and the router) train, the towers are frozen.

Counterpart of ``ctrl_adapter_tpu/train/trainer.py`` (its SVD, I2VGen-XL and
SDXL branches) and of the optimizer recipe it builds from optax, kept here in
its own code:

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
copied back into the module after each update. A router (float32) trains in
the same optimizer: one global norm and one clip over the adapter's and the
router's gradients together, as optax does over the ``{"adapter", "router"}``
tree.

The step is split so that a test can feed the JAX trainer's own random draws:
:meth:`CtrlAdapterTrainer.draw` draws the five tensors of the JAX ``_loss``
(VAE noise, noise, noise offset, the timestep draw, the dropout uniform) from
an explicit ``torch.Generator``, in the JAX layouts, and
:meth:`CtrlAdapterTrainer.loss` is deterministic given them. Batches are in
the JAX layouts too: frames (b, f, H, W, 3) in [-1, 1] (f = 1 for SDXL),
``controlnet_cond`` (E, b*f, H, W, 3), ``controlnet_text_emb`` (b, 77, 768),
``image_embeddings`` (b, 1, 1024) for SVD and I2VGen-XL, ``prompt_embeds``
(b, 77, d) for I2VGen-XL and SDXL, ``pooled_prompt_embeds`` (b, 1280) and
``additional_time_ids`` (b, 6) for SDXL, and ``expert_mask`` (E,) with a
router.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..models.multicontrolnet import MultiControlNetModel
from ..models.router import build_router_input, fuse_expert_residuals
from ..ops.resize import adaptive_avg_pool2d
from ..parallel.mesh import all_reduce_mean_
from ..schedulers.ddim import DDIMConfig, DDIMScheduler
from ..schedulers.euler_discrete import karras_sigmas, sample_training_sigmas_timesteps
from ..utils import profiling
from .losses import edm_loss, min_snr_loss, mse_loss

MODEL_NAMES = ("svd", "i2vgenxl", "sdxl")


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` (``train/trainer.py:41-77``)."""
    model_name: str = "i2vgenxl"  # "i2vgenxl" | "svd" | "sdxl"
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
    """The frozen backbone UNet, ControlNet expert(s) and VAE, the trainable
    adapter (and router) with their fp32 masters and AdamW state, and the
    training step.

    ``unet`` is the backbone of ``config.model_name``: the SVD UNet with the
    temporal VAE, or the I2VGen-XL UNet or the SDXL UNet with the 2D VAE.
    ``controlnet`` is one ``ControlNetModel``, or ``config.num_experts`` of
    them as a ``MultiControlNetModel`` or a list; every expert runs every
    step, as in the JAX loop. With more than one expert, ``router`` (a
    ``ControlNetRouter``) weighs them and trains with the adapter; without
    it their residuals are summed. The I2VGen-XL and SDXL branches noise
    with the JAX trainer's default DDIM schedule at
    ``config.prediction_type``.

    With a ``process_group`` (data parallelism, ``parallel/mesh.py``) each
    process trains on its slice of the batch, and every step's fp32
    gradients are averaged over the group before the norm, the clip and
    AdamW (in ``MasterOptimizer``'s parameter order, one flat buffer), so
    that every process makes the same update."""

    def __init__(self, config: TrainConfig, unet, controlnet, adapter, vae, router=None,
                 device="cuda", process_group=None):
        if config.model_name not in MODEL_NAMES:
            raise ValueError(f"model_name={config.model_name!r}, not one of {MODEL_NAMES}")
        if config.snr_gamma and config.model_name == "svd":
            # the JAX SVD branch indexes the DDIM alphas with its continuous EDM
            # timesteps (0.25 log sigma), which JAX refuses: no reference to port
            raise NotImplementedError("snr_gamma with model_name='svd': the JAX trainer's "
                                      "min-SNR loss takes integer DDIM timesteps, which the "
                                      "SVD branch does not have")
        experts = (list(controlnet.nets) if isinstance(controlnet, MultiControlNetModel)
                   else list(controlnet) if isinstance(controlnet, (list, tuple))
                   else [controlnet])
        if len(experts) != config.num_experts:
            raise ValueError(f"{len(experts)} ControlNets for num_experts="
                             f"{config.num_experts}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CtrlAdapterTrainer: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        self.config = config
        self.process_group = process_group
        self.steps = 0  # train_step calls so far: the id of the step's spans
        self.unet, self.controlnet, self.adapter, self.vae = unet, controlnet, adapter, vae
        self.experts, self.router = experts, router
        for tower in (unet, vae, *experts):
            tower.requires_grad_(False).eval()
        self.adapter.train()
        self.names = [name for name, _ in adapter.named_parameters()]
        self.router_names = [] if router is None else [n for n, _ in router.named_parameters()]
        params = list(adapter.parameters())
        if router is not None:
            router.train()
            params += list(router.parameters())
        self.optimizer = MasterOptimizer(config, params)
        self.scheduler = DDIMScheduler(DDIMConfig(prediction_type=config.prediction_type))
        self.sigmas_table = torch.from_numpy(karras_sigmas(1000)).to(self.device)
        self.latent_factor = 2 ** (len(vae.config.block_out_channels) - 1)

    # ------------------------------------------------------------- weights
    def load_masters(self, state: Dict[str, torch.Tensor],
                     router_state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Set the fp32 masters (and the modules' weights) from state dicts
        keyed by the adapter's (and the router's) parameter names."""
        n = len(self.names)
        with torch.no_grad():
            for name, m in zip(self.names, self.optimizer.masters[:n]):
                m.copy_(state[name])
            if router_state is not None:
                for name, m in zip(self.router_names, self.optimizer.masters[n:]):
                    m.copy_(router_state[name])
        self.optimizer.sync()

    def adapter_state(self) -> Dict[str, torch.Tensor]:
        """The adapter's fp32 masters by diffusers parameter name."""
        return dict(zip(self.names, self.optimizer.masters[:len(self.names)]))

    def router_state(self) -> Optional[Dict[str, torch.Tensor]]:
        """The router's fp32 masters by diffusers parameter name (None
        without a router)."""
        if self.router is None:
            return None
        return dict(zip(self.router_names, self.optimizer.masters[len(self.names):]))

    # --------------------------------------------------------------- draws
    def draw(self, generator: Optional[torch.Generator], b: int, f: int, lh: int,
             lw: int) -> Dict[str, torch.Tensor]:
        """The five random tensors of one step, in the JAX ``_loss``'s order
        and layouts: "vae" (b*f, lh, lw, 4) and "noise" (b, f, lh, lw, 4)
        standard normal, "offset" (b, 1, 1, 1, 4) standard normal, "time" (b,)
        (SVD: uniform in [0, 1); I2VGen-XL and SDXL: the integer DDIM
        timestep in [0, num_train_timesteps)) and "dropout" (b,) uniform in
        [0, 1)."""
        kw = dict(generator=generator, device=self.device, dtype=torch.float32)
        draws = {"vae": torch.randn((b * f, lh, lw, 4), **kw),
                 "noise": torch.randn((b, f, lh, lw, 4), **kw),
                 "offset": torch.randn((b, 1, 1, 1, 4), **kw)}
        if self.config.model_name == "svd":
            draws["time"] = torch.rand((b,), **kw)
        else:
            draws["time"] = torch.randint(0, self.scheduler.config.num_train_timesteps, (b,),
                                          generator=generator, device=self.device)
        draws["dropout"] = torch.rand((b,), **kw)
        return draws

    # ---------------------------------------------------------------- loss
    def loss(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
             sparse_frames: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The scalar fp32 loss of the JAX ``_loss``, whose graph reaches
        only the adapter's (and the router's) parameters."""
        return self.loss_and_weights(batch, draws, sparse_frames)[0]

    def loss_and_weights(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                         sparse_frames: Optional[Sequence[int]] = None):
        """(loss, {"down_block_weights", "mid_block_weights"} of the router,
        empty without one) of the JAX ``_loss`` given the step's draws."""
        cfg = self.config
        dev = self.device
        svd = cfg.model_name == "svd"
        batch = {k: v.to(dev) for k, v in batch.items()}
        frames = batch["frames"]
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

            if svd:
                u, sigmas = sample_training_sigmas_timesteps(draws["time"], self.sigmas_table,
                                                             cfg.num_inference_steps)
                unet_timesteps = 0.25 * torch.log(sigmas)
                cn_timesteps = torch.round(u * 1000.0)
            else:
                unet_timesteps = draws["time"]
                cn_timesteps = unet_timesteps.float()
            if cfg.fixed_controlnet_timestep >= 0:
                cn_timesteps = torch.full((b,), float(cfg.fixed_controlnet_timestep),
                                          device=dev)

            image_embeddings = batch.get("image_embeddings")
            if svd:  # EDM noising and conditioning dropout
                sig = sigmas.reshape(b, 1, 1, 1, 1)
                small_noise = latents + noise * cfg.train_noise_aug
                cond_latents = small_noise[:, 0] / cfg.vae_scaling_factor  # (b, 4, lh, lw)
                noisy_4ch = latents + noise * sig
                noisy = noisy_4ch / (sig ** 2 + 1.0) ** 0.5
                if cfg.conditioning_dropout_prob:
                    p = cfg.conditioning_dropout_prob
                    random_p = draws["dropout"]
                    prompt_mask = (random_p < 2 * p)[:, None, None]
                    image_embeddings = torch.where(
                        prompt_mask, torch.zeros_like(image_embeddings), image_embeddings)
                    image_mask = 1.0 - ((random_p >= p).float() * (random_p < 3 * p).float())
                    cond_latents = cond_latents * image_mask[:, None, None, None]
            else:  # DDIM noising
                noisy = self.scheduler.add_noise(latents, noise, unet_timesteps)
                target = (noise if self.scheduler.config.prediction_type == "epsilon"
                          else self.scheduler.get_velocity(latents, noise, unet_timesteps))

            # the frozen ControlNet experts on the pooled noisy latents, all of
            # them every step as in the JAX loop
            flat_noisy = noisy.reshape(b * f, 4, lh, lw)
            s = cfg.control_latent_size
            pooled = adaptive_avg_pool2d(flat_noisy, (s, s))
            cn_text = batch["controlnet_text_emb"].repeat_interleave(f, dim=0)
            cn_t = cn_timesteps.repeat_interleave(f)
            per_down, per_mid = [], []
            for e, net in enumerate(self.experts):
                downs, mid = net(pooled, cn_t, cn_text,
                                 batch["controlnet_cond"][e].permute(0, 3, 1, 2),
                                 skip_conv_in=cfg.skip_conv_in, guess_mode=cfg.guess_mode,
                                 skip_time_emb=cfg.skip_time_emb)
                per_down.append(downs)
                per_mid.append(mid)

        # the router's weights (trainable) and the fusion of the experts
        weights = {}
        down_w = mid_w = None
        if self.router is not None and cfg.num_experts > 1:
            router_in = build_router_input(
                self.router.router_type, cn_timesteps,
                batch.get("image_embeddings", batch.get("prompt_embeds")))
            down_w, mid_w = self.router(router_in, sparse_mask=batch.get("expert_mask"))
            weights["down_block_weights"] = down_w
            if mid_w is not None:
                weights["mid_block_weights"] = mid_w
        fused_down, fused_mid = fuse_expert_residuals(per_down, per_mid, down_w, mid_w)
        if "M" not in self.adapter.adapter_locations:
            fused_mid = None

        idx = None
        adapter_frames = f
        sel_down, sel_mid = fused_down, fused_mid
        if sparse_frames is not None:
            idx = torch.as_tensor(list(sparse_frames), device=dev)
            adapter_frames = len(sparse_frames)
            sel_down = [d[idx] for d in fused_down]
            sel_mid = None if fused_mid is None else fused_mid[idx]

        if svd:
            adapter_ehs = image_embeddings
        elif cfg.model_name == "i2vgenxl":
            adapter_ehs = batch["image_embeddings"]
        else:
            adapter_ehs = batch["prompt_embeds"]

        def run_adapter(downs, mid, ehs):
            return self.adapter(downs, mid, num_frames=adapter_frames, timestep=cn_timesteps,
                                encoder_hidden_states=ehs)

        adapted_down, adapted_mid = self._maybe_checkpoint(run_adapter, sel_down, sel_mid,
                                                           adapter_ehs)
        if idx is not None:  # dense re-scatter: zeros at the frames the adapter skipped
            def scatter(a):
                return torch.zeros((b * f, *a.shape[1:]), dtype=a.dtype,
                                   device=dev).index_copy(0, idx, a)
            adapted_down = [scatter(a) for a in adapted_down]
            adapted_mid = None if adapted_mid is None else scatter(adapted_mid)
        # num_repeats > 1 returns num_repeats residuals: zeros at the other
        # slots, the JAX package's minimal divergence from the reference (whose
        # UNet would truncate its skips at the short list)
        if self.adapter.num_repeats > 1 and len(adapted_down) < len(fused_down):
            adapted_down = list(adapted_down) + [
                torch.zeros((b * f, *d.shape[1:]), dtype=adapted_down[0].dtype, device=dev)
                for d in fused_down[len(adapted_down):]]

        if svd:
            cond = cond_latents[:, None].expand(b, f, *cond_latents.shape[1:])
            unet_in = torch.cat([noisy, cond], dim=2)
            added_time_ids = torch.tensor(
                [[float(cfg.output_fps - 1), 127.0, cfg.train_noise_aug]], device=dev).repeat(b, 1)
            model_pred = self._maybe_checkpoint(self.unet, unet_in, unet_timesteps,
                                                image_embeddings, added_time_ids, adapted_down,
                                                adapted_mid)
            return edm_loss(model_pred, noisy_4ch, latents, sigmas), weights
        if cfg.model_name == "i2vgenxl":
            # frame-position-mask image latents from the clean first-frame latent
            first = latents[:, 0]
            image_latents = torch.stack(
                [first] + [torch.full_like(first, k / (f - 1)) for k in range(1, f)], dim=1)
            fps = torch.full((b,), float(cfg.output_fps), device=dev)
            model_pred = self._maybe_checkpoint(
                self.unet, noisy, unet_timesteps, fps, image_latents, batch["image_embeddings"],
                batch["prompt_embeds"], adapted_down, adapted_mid)
        else:
            def run_unet(sample, t, ehs, text_embeds, time_ids, downs, mid):
                return self.unet(sample, t, ehs, {"text_embeds": text_embeds,
                                                  "time_ids": time_ids}, downs, mid)

            model_pred = self._maybe_checkpoint(
                run_unet, noisy.reshape(b * f, 4, lh, lw), unet_timesteps,
                batch["prompt_embeds"], batch["pooled_prompt_embeds"],
                batch["additional_time_ids"], adapted_down,
                torch.zeros((), dtype=noisy.dtype, device=dev)).reshape(b, f, 4, lh, lw)
        if cfg.snr_gamma:
            loss = min_snr_loss(model_pred, target, self.scheduler.alphas_cumprod_on(dev),
                                unet_timesteps, cfg.snr_gamma)
        else:
            loss = mse_loss(model_pred, target)
        return loss, weights

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
        """One step: the loss and its gradients for the adapter (and the
        router), then the optimizer (every ``gradient_accumulation_steps``
        calls). ``draws`` (from :meth:`draw`) replace the generator's when
        given. Returns {"loss", "grad_norm"} as 0-d fp32 tensors, and with a
        router its "down_block_weights" (num_routers, E) and
        "mid_block_weights" (E,): the loss and the weights of this process's
        slice, the norm of the gradient averaged over the group."""
        if draws is None:
            b, f, h, w, _ = batch["frames"].shape
            draws = self.draw(generator, b, f, h // self.latent_factor, w // self.latent_factor)
        step, self.steps = self.steps, self.steps + 1
        with profiling.span("trainer.step", step=step):
            params = self.optimizer.params
            for p in params:
                p.grad = None
            with profiling.span("trainer.forward", step=step):
                loss, weights = self.loss_and_weights(batch, draws, sparse_frames)
            with profiling.span("trainer.backward", step=step):
                loss.backward()
            with profiling.span("trainer.grads", step=step):
                grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
                         for p, m in zip(params, self.optimizer.masters)]
            if self.process_group is not None:
                with profiling.span("trainer.allreduce", step=step):
                    flat = all_reduce_mean_(torch.cat([g.reshape(-1) for g in grads]),
                                            self.process_group)
                    grads = [g.view_as(m) for g, m in
                             zip(flat.split([m.numel() for m in self.optimizer.masters]),
                                 self.optimizer.masters)]
            with profiling.span("trainer.optimizer", step=step):
                grad_norm = global_norm(grads)
                self.optimizer.step(grads)
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                **{k: v.detach() for k, v in weights.items()}}
