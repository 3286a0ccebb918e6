"""Diffusion training losses: plain MSE, min-SNR-weighted MSE, EDM-denoised.

Counterpart of ``ctrl_adapter_tpu/train/losses.py``; every loss is computed in
float32 whatever the inputs' dtype.
"""

from __future__ import annotations

import torch


def mse_loss(model_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((model_pred.float() - target.float()) ** 2)


def compute_snr(alphas_cumprod: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """SNR(t) = alpha_bar / (1 - alpha_bar)."""
    acp = alphas_cumprod.to(timesteps.device)[timesteps.long()].float()
    return acp / (1.0 - acp)


def min_snr_loss(model_pred: torch.Tensor, target: torch.Tensor, alphas_cumprod: torch.Tensor,
                 timesteps: torch.Tensor, snr_gamma: float) -> torch.Tensor:
    """Per-sample MSE re-weighted by min(SNR, gamma) / SNR; timesteps (b,)."""
    snr = compute_snr(alphas_cumprod, timesteps)
    weights = torch.clamp(snr, max=snr_gamma) / snr
    per_elem = (model_pred.float() - target.float()) ** 2
    return torch.mean(per_elem.reshape(per_elem.shape[0], -1).mean(dim=1) * weights)


def edm_loss(model_pred: torch.Tensor, noisy_latents_4ch: torch.Tensor, target: torch.Tensor,
             sigmas: torch.Tensor) -> torch.Tensor:
    """EDM weighted denoising loss of a v-prediction: denoised = c_out * pred +
    c_skip * x_t with c_out = -sigma / sqrt(sigma^2 + 1), c_skip = 1 / (sigma^2
    + 1); loss = mean_b mean((1 + sigma^2) / sigma^2 * (denoised - x0)^2).
    ``sigmas`` (b,); the other tensors (b, ...) in one layout."""
    s = sigmas.reshape(sigmas.shape[0], *([1] * (model_pred.dim() - 1))).float()
    c_out = -s / (s ** 2 + 1.0) ** 0.5
    c_skip = 1.0 / (s ** 2 + 1.0)
    denoised = model_pred.float() * c_out + c_skip * noisy_latents_4ch.float()
    weighing = (1.0 + s ** 2) * s ** -2.0
    per = weighing * (denoised - target.float()) ** 2
    return per.reshape(per.shape[0], -1).mean(dim=1).mean()
