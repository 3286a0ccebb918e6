"""One step and the decode of the I2VGen-XL + ControlNet + Ctrl-Adapter sampler,
plain float32: the published algorithm (diffusers' I2VGen-XL pipeline with the
Ctrl-Adapter reference's control path) on the reference towers.

- DDIM (eta 0, "leading" spacing) over the CFG-doubled latents with one
  guidance scale; the ControlNet reads the same integer timestep as the UNet;
- the ControlNet on the latents pooled to the control latent size, the adapter
  on its residuals with the positive CLIP image embedding over both halves;
- the image latents: the scaled first-frame latent at frame 0, the constant
  i / (f - 1) at frame i;
- the 2D VAE decoding frame by frame.
"""

from __future__ import annotations

from typing import Dict

import torch

from .ddim import DDIMConfig, DDIMScheduler
from .ops import avg_pool
from .svd_pipeline import control_window


class I2VGenXLSampler:
    def __init__(self, towers, inputs: Dict[str, torch.Tensor], settings: dict):
        self.t = towers
        self.s = settings
        self.sched = DDIMScheduler(DDIMConfig())
        steps = settings["num_inference_steps"]
        self.state = self.sched.set_timesteps(steps)
        emb = inputs["image_embeddings"].float()
        b = emb.shape[0]
        f = settings["num_frames"]
        self.b, self.f = b, f
        il = inputs["first_frame_latent"].float().permute(0, 3, 1, 2) * settings[
            "vae_scaling_factor"]
        frames = torch.stack([il] + [torch.full_like(il, k / (f - 1)) for k in range(1, f)],
                             dim=1)
        self.image_latents = torch.cat([frames, frames])
        self.emb_cfg = torch.cat([torch.zeros_like(emb), emb])
        self.prompt = inputs["prompt_embeds"].float()
        self.cn_prompt = inputs["controlnet_prompt_embeds"].float().repeat_interleave(f, dim=0)
        cond = inputs["control_images"].float().permute(0, 3, 1, 2)
        self.control = torch.cat([cond, cond])
        self.fps = torch.full((2 * b,), float(settings["target_fps"]), device=emb.device)
        self.window = control_window(steps, settings["control_guidance_start"],
                                     settings["control_guidance_end"])

    def start(self, latents: torch.Tensor) -> torch.Tensor:
        return latents.float().permute(0, 1, 4, 2, 3)

    def step(self, x: torch.Tensor, i: int) -> dict:
        b, f, c, h, w = x.shape
        t = float(self.state.timesteps[i])
        lo, hi = self.window
        out = {}
        down = mid = None
        if lo <= i < hi:
            size = self.s["control_latent_size"]
            pooled = avg_pool(torch.cat([x, x]).reshape(2 * b * f, c, h, w), (size, size))
            downs, mid = self.t.controlnet(
                pooled, t, self.cn_prompt, self.control,
                conditioning_scale=self.s["controlnet_conditioning_scale"],
                skip_conv_in=self.s["skip_conv_in"])
            down, mid = self.t.adapter(downs, mid, num_frames=f, timestep=t,
                                       encoder_hidden_states=self.emb_cfg[b:].repeat(2, 1, 1))
            down = list(down)
            out["adapter"] = down + ([] if mid is None else [mid])
        noise = self.t.unet(torch.cat([x, x]), t, self.fps, self.image_latents, self.emb_cfg,
                            self.prompt, down_block_additional_residuals=down,
                            mid_block_additional_residual=mid).float()
        out["unet"] = noise
        out["next"] = self.update(x, noise, i)
        return out

    def update(self, x: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """The guidance over the UNet's two halves, then the DDIM step."""
        uncond, cond = noise.float().chunk(2)
        return self.sched.step(self.state, uncond + self.s["guidance_scale"] * (cond - uncond),
                               i, x)

    def decode_raw(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, f, h, w, 4) latents -> the decoder's (b*f, 3, H, W) output, frame
        by frame."""
        b, f, h, w, c = latents.shape
        flat = latents.float().reshape(b * f, h, w, c).permute(0, 3, 1, 2)
        return torch.cat([self.t.vae.decode(z[None]) for z in flat / self.s["vae_scaling_factor"]])

    def finish(self, raw: torch.Tensor, b: int) -> torch.Tensor:
        """The decoder's (b*f, 3, H, W) output -> the (b, f, H, W, 3) video in [0, 1]."""
        video = torch.clamp(raw / 2 + 0.5, 0.0, 1.0)
        return video.permute(0, 2, 3, 1).reshape(b, -1, *video.shape[2:], video.shape[1])

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.finish(self.decode_raw(latents), latents.shape[0])
