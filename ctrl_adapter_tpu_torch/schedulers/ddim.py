"""DDIM scheduler (eta = 0), as the I2VGen-XL and SDXL pipelines use it.

Counterpart of ``ctrl_adapter_tpu/schedulers/ddim.py``: "leading" (or
"trailing") timestep spacing with ``steps_offset``, the deterministic step for
epsilon and v prediction, and the training-side ``add_noise`` and
``get_velocity``. The schedule is computed in numpy; timesteps stay int64 on
the host, the alphas are float32 tensors and every update runs in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    timestep_spacing: str = "leading"
    clip_sample: bool = False
    thresholding: bool = False
    rescale_betas_zero_snr: bool = False


def _make_alphas_cumprod(cfg: DDIMConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n, dtype=np.float64) ** 2
    else:
        raise ValueError(cfg.beta_schedule)
    return np.cumprod(1.0 - betas).astype(np.float32)


@dataclass(frozen=True)
class DDIMState:
    timesteps: torch.Tensor  # (S,) int64 on the host, descending
    alphas_cumprod: torch.Tensor  # (T,) float32
    final_alpha_cumprod: torch.Tensor  # 0-d float32
    num_inference_steps: int
    prediction_type: str = "epsilon"
    num_train_timesteps: int = 1000


def _per_sample(acp: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) values broadcast over the trailing axes of an ``ndim``-D sample."""
    return acp.reshape(acp.shape + (1,) * (ndim - acp.dim()))


class DDIMScheduler:
    def __init__(self, config: DDIMConfig = DDIMConfig()):
        self.config = config
        self.alphas_cumprod = torch.from_numpy(_make_alphas_cumprod(config))
        self._alphas_on = {torch.device("cpu"): self.alphas_cumprod}

    def alphas_cumprod_on(self, device) -> torch.Tensor:
        """The alphas table on ``device``, moved there at the first call: the
        training-side lookups index it where their timesteps live, so a step
        copies nothing from the card to the host."""
        device = torch.device(device)
        if device not in self._alphas_on:
            self._alphas_on[device] = self.alphas_cumprod.to(device)
        return self._alphas_on[device]

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        cfg = self.config
        if cfg.timestep_spacing == "leading":
            step_ratio = cfg.num_train_timesteps // num_inference_steps
            timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1].copy()
            timesteps += cfg.steps_offset
        elif cfg.timestep_spacing == "trailing":
            step_ratio = cfg.num_train_timesteps / num_inference_steps
            timesteps = np.round(np.arange(cfg.num_train_timesteps, 0, -step_ratio)) - 1
        else:
            raise ValueError(cfg.timestep_spacing)
        final = (torch.tensor(1.0) if cfg.set_alpha_to_one else self.alphas_cumprod[0].clone())
        return DDIMState(timesteps=torch.from_numpy(timesteps.astype(np.int64)),
                         alphas_cumprod=self.alphas_cumprod, final_alpha_cumprod=final,
                         num_inference_steps=num_inference_steps,
                         prediction_type=cfg.prediction_type,
                         num_train_timesteps=cfg.num_train_timesteps)

    @staticmethod
    def scale_model_input(state: DDIMState, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        return sample  # DDIM does not scale

    @staticmethod
    def step(state: DDIMState, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, eta: float = 0.0) -> torch.Tensor:
        """One deterministic x_t -> x_{t-1} update, in float32, returned in the
        sample's dtype."""
        if eta != 0.0:
            raise ValueError("stochastic DDIM (eta > 0) is not used by the pipelines")
        t = int(state.timesteps[step_index])
        prev_t = t - state.num_train_timesteps // state.num_inference_steps
        acp = state.alphas_cumprod
        alpha_t = acp[t]
        alpha_prev = acp[prev_t] if prev_t >= 0 else state.final_alpha_cumprod
        beta_t = 1.0 - alpha_t
        # float32 coefficients from the host's table, passed on as Python
        # numbers: a step copies nothing to the device
        a_t, b_t, a_prev, b_prev = (float(v ** 0.5) for v in
                                    (alpha_t, beta_t, alpha_prev, 1.0 - alpha_prev))
        x = sample.float()
        out = model_output.float()
        if state.prediction_type == "epsilon":
            pred_x0 = (x - b_t * out) / a_t
            pred_eps = out
        elif state.prediction_type == "v_prediction":
            pred_x0 = a_t * x - b_t * out
            pred_eps = a_t * out + b_t * x
        else:
            raise ValueError(state.prediction_type)
        prev = a_prev * pred_x0 + b_prev * pred_eps
        return prev.to(sample.dtype)

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """sqrt(acp_t) x0 + sqrt(1 - acp_t) noise, per sample of ``timesteps`` (B,)."""
        acp = self.alphas_cumprod_on(timesteps.device)[timesteps.long()].to(
            original_samples.device)
        acp = _per_sample(acp, original_samples.dim())
        return acp ** 0.5 * original_samples + (1.0 - acp) ** 0.5 * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """The v-prediction target sqrt(acp_t) noise - sqrt(1 - acp_t) x0."""
        acp = self.alphas_cumprod_on(timesteps.device)[timesteps.long()].to(sample.device)
        acp = _per_sample(acp, sample.dim())
        return acp ** 0.5 * noise - (1.0 - acp) ** 0.5 * sample
