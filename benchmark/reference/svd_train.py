"""The SVD Ctrl-Adapter training step, plain float32: the published algorithm
(the Ctrl-Adapter reference's SVD branch) on the reference towers.

- the temporal VAE's encoder gives each frame's latent distribution, sampled
  with the step's noise and scaled;
- EDM noising at a sigma drawn from the Karras table aligned with the
  sampler's 25 steps; the UNet reads 0.25 log sigma, the ControlNet
  round(u * 1000);
- conditioning dropout: the CLIP image embedding dropped below 2p, the
  first-frame condition latent dropped in [p, 3p);
- the frozen ControlNet on the noisy latents pooled to the control latent
  size; the adapter on its residuals (it alone trains); the UNet on the noisy
  latents beside the condition latents; the EDM-weighted denoising loss;
- the optimizer: the gradients clipped to a global norm, then AdamW with
  decoupled weight decay at a constant learning rate on float32 masters, which
  the towers read in the configuration's type.

The towers run under activation checkpointing where the step's memory asks
for it (the UNet and the adapter), which changes no number.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .euler_discrete import karras_sigmas, sample_training_sigmas_timesteps
from .ops import avg_pool, maybe_checkpoint


def edm_loss(pred, noisy_4ch, target, sigmas):
    s = sigmas.reshape(-1, 1, 1, 1, 1).float()
    denoised = pred.float() * (-s / (s ** 2 + 1.0) ** 0.5) + noisy_4ch / (s ** 2 + 1.0)
    per = (1.0 + s ** 2) * s ** -2.0 * (denoised - target) ** 2
    return per.reshape(per.shape[0], -1).mean(dim=1).mean()


def loss(towers, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
         tc: dict) -> torch.Tensor:
    """The step's loss; its graph reaches the adapter's parameters only."""
    frames = batch["frames"].float()
    b, f, h, w, _ = frames.shape
    dev = frames.device
    with torch.no_grad():
        mean, logvar = towers.vae.encode_moments(frames.reshape(b * f, h, w, 3).permute(0, 3, 1, 2))
        latents = mean + torch.exp(0.5 * logvar) * draws["vae"].permute(0, 3, 1, 2)
        lh, lw = latents.shape[-2:]
        latents = latents.reshape(b, f, 4, lh, lw) * tc["vae_scaling_factor"]
        noise = draws["noise"].permute(0, 1, 4, 2, 3) + tc["noise_offset"] * draws[
            "offset"].permute(0, 1, 4, 2, 3)
        table = torch.from_numpy(karras_sigmas(1000)).to(dev)
        u, sigmas = sample_training_sigmas_timesteps(draws["time"], table,
                                                     tc["num_inference_steps"])
        unet_t = 0.25 * torch.log(sigmas)
        cn_t = torch.round(u * 1000.0)
        sig = sigmas.reshape(b, 1, 1, 1, 1)
        cond_latents = (latents + noise * tc["train_noise_aug"])[:, 0] / tc["vae_scaling_factor"]
        noisy_4ch = latents + noise * sig
        noisy = noisy_4ch / (sig ** 2 + 1.0) ** 0.5
        emb = batch["image_embeddings"].float()
        p = tc["conditioning_dropout_prob"]
        if p:
            r = draws["dropout"]
            emb = torch.where((r < 2 * p)[:, None, None], torch.zeros_like(emb), emb)
            keep = 1.0 - ((r >= p).float() * (r < 3 * p).float())
            cond_latents = cond_latents * keep[:, None, None, None]
        s = tc["control_latent_size"]
        pooled = avg_pool(noisy.reshape(b * f, 4, lh, lw), (s, s))
        downs, mid = towers.controlnet(
            pooled, cn_t.repeat_interleave(f), batch["controlnet_text_emb"].float()
            .repeat_interleave(f, dim=0), batch["controlnet_cond"][0].float().permute(0, 3, 1, 2),
            skip_conv_in=tc["skip_conv_in"])

    def adapter(downs, mid, emb):
        return towers.adapter(downs, mid, num_frames=f, timestep=cn_t,
                              encoder_hidden_states=emb)

    down, mid = maybe_checkpoint(adapter, downs, mid, emb)
    cond = cond_latents[:, None].expand(b, f, *cond_latents.shape[1:])
    ids = torch.tensor([[float(tc["output_fps"] - 1), 127.0, tc["train_noise_aug"]]],
                       device=dev).repeat(b, 1)
    pred = maybe_checkpoint(towers.unet, torch.cat([noisy, cond], dim=2), unet_t, emb, ids,
                            list(down), mid)
    return edm_loss(pred, noisy_4ch, latents, sigmas)


class Trainer:
    """The reference's adapter: float32 masters with clipping and AdamW. The
    towers read the masters in the configuration's type (``served``), as its
    towers store them: bf16 weights over fp32 masters, each step's new masters
    rounded to bf16 for the next forward. In float32 the masters are the
    towers' parameters themselves."""

    def __init__(self, towers, tc: dict, served: torch.dtype = torch.float32):
        self.towers, self.tc, self.served = towers, tc, served
        for name in ("unet", "controlnet", "vae"):
            getattr(towers, name).requires_grad_(False).eval()
        towers.adapter.train()
        self.params: List[torch.Tensor] = list(towers.adapter.parameters())
        self.masters = (self.params if served == torch.float32 else
                        [torch.nn.Parameter(p.detach().clone()) for p in self.params])
        self.opt = torch.optim.AdamW(self.masters, lr=tc["learning_rate"],
                                     betas=(tc["adam_beta1"], tc["adam_beta2"]),
                                     eps=tc["adam_epsilon"], weight_decay=tc["adam_weight_decay"])

    def step(self, batch, draws) -> (float, List[torch.Tensor], float):
        """One step: (its loss, the gradients the optimizer got, clipped, their
        norm before the clip)."""
        for p in self.params:
            p.grad = None
        value = loss(self.towers, batch, draws, self.tc)
        value.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if norm.item() >= self.tc["max_grad_norm"]:
            grads = [g / norm * self.tc["max_grad_norm"] for g in grads]
        for m, g in zip(self.masters, grads):
            m.grad = g
        self.opt.step()
        if self.masters is not self.params:
            with torch.no_grad():
                for p, m in zip(self.params, self.masters):
                    p.copy_(m.to(self.served))
                    m.grad = None
        return value.item(), [g.detach().clone() for g in grads], norm.item()
