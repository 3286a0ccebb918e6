"""EulerDiscrete scheduler (SVD / EDM variant and the SDXL default).

Plain float32 reference of the program's: Karras sigmas
in [0.002, 700] with rho 7, continuous ``0.25 * log sigma`` timesteps,
v-prediction with the EDM c_skip / c_out; or beta-derived sigmas with discrete
"leading" timesteps and epsilon prediction. The schedule is computed in numpy
and held as float32 tensors; updates run in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def karras_sigmas(num_intervals: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) noise schedule, descending."""
    ramp = np.linspace(0, 1, num_intervals)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho).astype(np.float32)


def sample_training_sigmas_timesteps(uniform: torch.Tensor, sigmas_table: torch.Tensor,
                                     num_inference_steps: int = 25):
    """The SVD training sampler aligned with the inference discretisation
    : from (batch,)
    uniform [0, 1) draws and the descending Karras table of N sigmas, idx =
    floor(uniform * N), u = idx / (N - 1) * (1 - 1/steps) + 0.001 and the
    table's sigma at idx; the ControlNet timestep is round(u * 1000). Returns
    (u, sigma), float32."""
    n = sigmas_table.shape[0]
    idx = (uniform.float() * n).to(torch.int64)
    u = idx.float() / (n - 1) * (1.0 - 1.0 / num_inference_steps) + 0.001
    return u, sigmas_table.to(uniform.device)[idx]


@dataclass(frozen=True)
class EulerDiscreteConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction"
    timestep_spacing: str = "leading"
    timestep_type: str = "discrete"  # "discrete" | "continuous" (0.25 log sigma)
    steps_offset: int = 1
    use_karras_sigmas: bool = False
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0


SVD_EULER_CONFIG = EulerDiscreteConfig(prediction_type="v_prediction",
                                       timestep_type="continuous", use_karras_sigmas=True)


@dataclass(frozen=True)
class EulerDiscreteState:
    sigmas: torch.Tensor  # (S+1,) float32, descending, last entry 0
    timesteps: torch.Tensor  # (S,) float32
    num_inference_steps: int
    init_noise_sigma: torch.Tensor  # 0-d float32
    prediction_type: str = "epsilon"


class EulerDiscreteScheduler:
    def __init__(self, config: EulerDiscreteConfig = EulerDiscreteConfig()):
        self.config = config
        n = config.num_train_timesteps
        if config.beta_schedule == "scaled_linear":
            betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5, n,
                                dtype=np.float64) ** 2
        elif config.beta_schedule == "linear":
            betas = np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
        else:
            raise ValueError(config.beta_schedule)
        acp = np.cumprod(1.0 - betas)
        self._train_sigmas = (((1.0 - acp) / acp) ** 0.5).astype(np.float32)

    def set_timesteps(self, num_inference_steps: int) -> EulerDiscreteState:
        cfg = self.config
        if cfg.use_karras_sigmas:
            sigmas = karras_sigmas(num_inference_steps, cfg.sigma_min, cfg.sigma_max, cfg.rho)
            init_noise_sigma = (sigmas[0] ** 2 + 1.0) ** 0.5
        else:
            if cfg.timestep_spacing == "leading":
                step_ratio = cfg.num_train_timesteps // num_inference_steps
                t_disc = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(
                    np.float64)
                t_disc += cfg.steps_offset
            elif cfg.timestep_spacing == "trailing":
                step_ratio = cfg.num_train_timesteps / num_inference_steps
                t_disc = np.round(np.arange(cfg.num_train_timesteps, 0, -step_ratio)) - 1
            elif cfg.timestep_spacing == "linspace":
                t_disc = np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps,
                                     dtype=np.float64)[::-1].copy()
            else:
                raise ValueError(cfg.timestep_spacing)
            sigmas = np.interp(t_disc, np.arange(cfg.num_train_timesteps),
                               self._train_sigmas).astype(np.float32)
            init_noise_sigma = (sigmas.max() if cfg.timestep_spacing in ("linspace", "trailing")
                                else (sigmas.max() ** 2 + 1.0) ** 0.5)
        if cfg.timestep_type == "continuous":
            timesteps = 0.25 * np.log(sigmas)
        elif cfg.use_karras_sigmas:
            raise NotImplementedError("karras + discrete timesteps not used by the reference")
        else:
            timesteps = t_disc
        return EulerDiscreteState(
            sigmas=torch.from_numpy(np.concatenate([sigmas, [0.0]]).astype(np.float32)),
            timesteps=torch.from_numpy(np.asarray(timesteps, np.float32)),
            num_inference_steps=num_inference_steps,
            init_noise_sigma=torch.tensor(init_noise_sigma, dtype=torch.float32),
            prediction_type=cfg.prediction_type)

    @staticmethod
    def scale_model_input(state: EulerDiscreteState, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        sigma = state.sigmas[step_index]
        return (sample.float() / (sigma ** 2 + 1.0) ** 0.5).to(sample.dtype)

    @staticmethod
    def step(state: EulerDiscreteState, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One Euler step on the un-scaled noisy latent x_t = x0 + sigma * eps."""
        sigma = state.sigmas[step_index]
        sigma_next = state.sigmas[step_index + 1]
        x = sample.float()
        out = model_output.float()
        if state.prediction_type == "epsilon":
            pred_x0 = x - sigma * out
        elif state.prediction_type == "v_prediction":
            c_out = -sigma / (sigma ** 2 + 1.0) ** 0.5
            c_skip = 1.0 / (sigma ** 2 + 1.0)
            pred_x0 = c_out * out + c_skip * x
        else:
            raise ValueError(state.prediction_type)
        derivative = (x - pred_x0) / sigma
        return (x + derivative * (sigma_next - sigma)).to(sample.dtype)
