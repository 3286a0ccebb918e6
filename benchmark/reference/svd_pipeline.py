"""One step and the decode of the SVD + ControlNet + Ctrl-Adapter sampler, plain
float32: the published algorithm (diffusers' SVD pipeline with the Ctrl-Adapter
reference's control path) on the reference towers.

- EDM Euler steps over Karras sigmas; the UNet reads t = 0.25 log sigma, the
  SD-v1.5 ControlNet the discrete remap ``1000 - (i+1) * (1000 // steps) + 1``;
- the ControlNet on the CFG-doubled, scaled latents pooled to the control
  latent size, with ``skip_conv_in``; the adapter on its residuals with the
  positive CLIP image embedding over both halves;
- the 8-channel UNet input (scaled latents and the image latents, zeros for the
  negative half) and a per-frame guidance scale from min to max;
- the temporal VAE decoding each video's frames in one chunk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .euler_discrete import SVD_EULER_CONFIG, EulerDiscreteScheduler
from .ops import avg_pool


def control_window(steps: int, start: float, end: float):
    on = [i for i in range(steps) if not (i / steps < start or (i + 1) / steps > end)]
    return (on[0], on[-1] + 1) if on else (0, 0)


class SVDSampler:
    """The reference's sampler state for one clip's inputs (float32 copies)."""

    def __init__(self, towers, inputs: Dict[str, torch.Tensor], settings: dict):
        self.t = towers
        self.s = settings
        self.sched = EulerDiscreteScheduler(SVD_EULER_CONFIG)
        steps = settings["num_inference_steps"]
        self.state = self.sched.set_timesteps(steps)
        interval = 1000 // steps
        self.cn_t = [float(1000 - (i + 1) * interval + 1) for i in range(steps)]
        emb = inputs["image_embeddings"].float()
        b = emb.shape[0]
        f = settings["num_frames"]
        self.b, self.f = b, f
        il = inputs["image_latent"].float().permute(0, 3, 1, 2)[:, None].expand(b, f, 4, *inputs[
            "image_latent"].shape[1:3])
        self.image_latents = torch.cat([torch.zeros_like(il), il])
        self.emb_cfg = torch.cat([torch.zeros_like(emb), emb])
        ids = [float(settings["fps"] - 1), float(settings["motion_bucket_id"]),
               float(settings["noise_aug_strength"])]
        self.time_ids = torch.tensor([ids], device=emb.device).repeat(2 * b, 1)
        cond = inputs["control_images"].float().permute(0, 3, 1, 2)
        self.control = torch.cat([cond, cond])
        self.cn_prompt = inputs["controlnet_prompt_embeds"].float().repeat_interleave(f, dim=0)
        self.guidance = torch.from_numpy(np.linspace(
            settings["min_guidance_scale"], settings["max_guidance_scale"], f).astype(
                np.float32)).to(emb.device)[None, :, None, None, None]
        self.window = control_window(steps, settings["control_guidance_start"],
                                     settings["control_guidance_end"])

    def start(self, latents: torch.Tensor) -> torch.Tensor:
        """The sampler's first state from the drawn (b, f, h, w, 4) noise."""
        return latents.float().permute(0, 1, 4, 2, 3) * self.state.init_noise_sigma.to(
            latents.device)

    def residuals(self, x: torch.Tensor, i: int):
        b, f, c, h, w = x.shape
        lmi = self.sched.scale_model_input(self.state, torch.cat([x, x]), i)
        size = self.s["control_latent_size"]
        pooled = avg_pool(lmi.reshape(2 * b * f, c, h, w), (size, size))
        downs, mid = self.t.controlnet(pooled, self.cn_t[i], self.cn_prompt, self.control,
                                       conditioning_scale=self.s["controlnet_conditioning_scale"],
                                       skip_conv_in=self.s["skip_conv_in"])
        down, mid = self.t.adapter(downs, mid, num_frames=f, timestep=self.cn_t[i],
                                   encoder_hidden_states=self.emb_cfg[b:].repeat(2, 1, 1))
        return list(down), mid

    def step(self, x: torch.Tensor, i: int) -> dict:
        """Step ``i`` from the state ``x`` (b, f, 4, h, w): the adapter's outputs
        (controlled steps), the UNet's output over both CFG halves, and the next
        state."""
        lo, hi = self.window
        out = {}
        down = mid = None
        if lo <= i < hi:
            down, mid = self.residuals(x, i)
            out["adapter"] = down + ([] if mid is None else [mid])
        lmi = self.sched.scale_model_input(self.state, torch.cat([x, x]), i)
        lmi = torch.cat([lmi, self.image_latents], dim=2)
        t = self.state.timesteps[i].to(x.device).expand(2 * self.b)
        noise = self.t.unet(lmi, t, self.emb_cfg, self.time_ids,
                            down_block_additional_residuals=down,
                            mid_block_additional_residual=mid).float()
        out["unet"] = noise
        out["next"] = self.update(x, noise, i)
        return out

    def update(self, x: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """The guidance over the UNet's two halves, then the Euler step."""
        uncond, cond = noise.float().chunk(2)
        return self.sched.step(self.state, uncond + self.guidance * (cond - uncond), i, x)

    def decode_raw(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, f, h, w, 4) latents -> the decoder's (b*f, 3, H, W) output, each
        video's frames decoded together."""
        f = latents.shape[1]
        z = latents.float().permute(0, 1, 4, 2, 3) / self.s["vae_scaling_factor"]
        return torch.cat([self.t.vae.decode(zc, f) for zc in z])

    def finish(self, raw: torch.Tensor, b: int) -> torch.Tensor:
        """The decoder's (b*f, 3, H, W) output -> the (b, f, H, W, 3) video in [0, 1]."""
        video = raw.reshape(b, -1, *raw.shape[1:])
        return torch.clamp(video / 2 + 0.5, 0.0, 1.0).permute(0, 1, 3, 4, 2)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.finish(self.decode_raw(latents), latents.shape[0])
