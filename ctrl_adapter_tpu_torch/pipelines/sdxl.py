"""SDXL + Ctrl-Adapter image pipeline.

Counterpart of ``ctrl_adapter_tpu/pipelines/sdxl.py``:

- a CFG-doubled batch [negative; positive], the stock SDXL EulerDiscrete
  scheduler (leading spacing, epsilon prediction) and CFG with optional std
  rescaling (``guidance_rescale``);
- the ControlNet and the adapter run only inside the control window
  [start, end): the SD-v1.5 ControlNet on the scaled, CFG-doubled latents
  pooled to ``control_latent_size`` (64 at 1024x1024) with the 512x512 control
  image, both at the discrete remap ``1000 - (i+1)*(1000//steps) + 1``; the
  adapter (``num_frames=1``, SDXL x2 upsample, the UNet's text embeddings as
  context) feeds its 12 residuals to the UNet's 9 skips with a zero mid
  residual; outside the window the UNet runs without residuals;
- a UNet with ``time_cond_proj_dim`` (LCM) runs the positive half alone with
  the guidance-scale embedding as ``timestep_cond``, without CFG;
- IP-Adapter image embeddings, zeros on the negative half;
- SDXL's 6 time ids in the prompt embeddings' dtype; the whole batch decoded at
  once by the 2D VAE (scaling factor 0.13025), then ``clip(x / 2 + 0.5)``.

The JAX ``lax.scan`` over steps is a Python loop here and the control window a
plain ``if``. :meth:`generate` takes and returns the JAX package's layouts:
latents (b, h, w, 4), control image (b, H, W, 3), image (b, H, W, 3). Inside,
tensors are NCHW. Everything runs on the device of the UNet's weights, and the
denoise loop makes no copy between the host and the device.

``generate(..., mesh=...)`` is the JAX ``mesh=`` argument: the image batch
splits over the processes of a ``parallel.mesh.Mesh`` (``timestep_cond`` and
the IP-Adapter embeddings with it), and the output equals the one-process run
over the whole batch (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.adapter import ControlNetAdapter
from ..models.controlnet import ControlNetModel
from ..models.unet_2d import UNet2DConditionModel
from ..models.vae import AutoencoderKL
from ..ops.resize import adaptive_avg_pool2d
from ..parallel import mesh as meshes
from ..schedulers.euler_discrete import EulerDiscreteConfig, EulerDiscreteScheduler
from .common import (classifier_free_guidance_rescaled, control_window,
                     guidance_scale_embedding, normalize_control_latent_size, sdxl_add_time_ids)
from .svd import controlnet_timestep_remap


class SDXLControlNetAdapterPipeline:
    def __init__(self, unet: UNet2DConditionModel, controlnet: ControlNetModel,
                 adapter: ControlNetAdapter, vae: AutoencoderKL,
                 scheduler: Optional[EulerDiscreteScheduler] = None):
        self.unet, self.controlnet, self.adapter, self.vae = unet, controlnet, adapter, vae
        self.scheduler = scheduler or EulerDiscreteScheduler(EulerDiscreteConfig())

    def _residuals(self, lmi: torch.Tensor, cn_t: float, ctx) -> list:
        """ControlNet on the pooled model input, then the adapter: the adapted
        down residuals."""
        pooled = adaptive_avg_pool2d(lmi, normalize_control_latent_size(
            ctx["control_latent_size"]))
        downs, _ = self.controlnet(pooled, cn_t, ctx["cn_prompt"], ctx["control_image"],
                                   conditioning_scale=ctx["conditioning_scale"],
                                   skip_conv_in=ctx["skip_conv_in"],
                                   guess_mode=ctx["guess_mode"],
                                   skip_time_emb=ctx["skip_time_emb"])
        adapted, _ = self.adapter(downs, None, num_frames=1, timestep=cn_t,
                                  encoder_hidden_states=ctx["prompt_embeds"])
        return list(adapted)

    @torch.no_grad()
    def _sample(self, latents: torch.Tensor, num_inference_steps: int, ctx) -> torch.Tensor:
        """Denoise loop over (b, 4, h, w) float32 latents, already scaled by
        the initial noise sigma."""
        sched = self.scheduler
        state = sched.set_timesteps(num_inference_steps)
        cn_timesteps = controlnet_timestep_remap(num_inference_steps)
        lo, hi = ctx["window"]
        zero_mid = torch.zeros((), dtype=latents.dtype, device=latents.device)
        for i in range(num_inference_steps):
            lmi = torch.cat([latents, latents]) if ctx["do_cfg"] else latents
            lmi = sched.scale_model_input(state, lmi, i)
            down = mid = None
            if lo <= i < hi:
                down, mid = self._residuals(lmi, float(cn_timesteps[i]), ctx), zero_mid
            noise_pred = self.unet(lmi, float(state.timesteps[i]), ctx["prompt_embeds"],
                                   ctx["added"], down_block_additional_residuals=down,
                                   mid_block_additional_residual=mid,
                                   timestep_cond=ctx["timestep_cond"]).float()
            if ctx["do_cfg"]:
                noise_pred = classifier_free_guidance_rescaled(
                    noise_pred, ctx["guidance_scale"], ctx["guidance_rescale"])
            latents = sched.step(state, noise_pred, i, latents)
        return latents

    @torch.no_grad()
    def _decode(self, latents: torch.Tensor, scaling_factor: float) -> torch.Tensor:
        """(b, h, w, 4) latents -> the (b, H, W, 3) image in [0, 1]."""
        image = self.vae.decode(latents.permute(0, 3, 1, 2) / scaling_factor)
        return torch.clamp(image / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    @torch.no_grad()
    def generate(self, prompt_embeds: torch.Tensor, add_text_embeds: torch.Tensor,
                 controlnet_prompt_embeds: torch.Tensor, control_image: torch.Tensor,
                 height: int = 1024, width: int = 1024, num_inference_steps: int = 50,
                 guidance_scale: float = 7.5, guidance_rescale: float = 0.0,
                 controlnet_conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0, control_guidance_end: float = 0.6,
                 skip_conv_in: bool = False, skip_time_emb: bool = False,
                 guess_mode: bool = False, original_size: Optional[Tuple[int, int]] = None,
                 vae_scaling_factor: float = 0.13025, latents: Optional[torch.Tensor] = None,
                 control_latent_size=64, output_type: str = "np",
                 ip_adapter_image_embeds: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[meshes.Mesh] = None) -> torch.Tensor:
        """prompt_embeds (2b, 77, 2048) [negative; positive]; add_text_embeds
        (2b, 1280) pooled; controlnet_prompt_embeds (2b, 77, 768); control_image
        (b or 2b, 512, 512, 3) in [0, 1]; latents (b, h/8, w/8, 4) or None (drawn
        from ``generator``); ip_adapter_image_embeds (b, d) CLIP image
        embeddings. Returns the (b, H, W, 3) image, or the (b, h/8, w/8, 4)
        latents for output_type="latent". With ``mesh``, every rank passes the
        whole batch and gets the whole result; it runs its own slice of the
        images (b must divide over the ranks), with the noise of the
        one-process draw."""
        device = self.unet.conv_in.weight.device
        batch = prompt_embeds.shape[0] // 2
        rows = meshes.batch_rows(mesh, batch) if mesh is not None else slice(0, batch)
        time_cond_dim = self.unet.config.time_cond_proj_dim
        do_cfg = guidance_scale > 1.0 and time_cond_dim is None
        prompt_embeds = prompt_embeds.to(device)
        add_text_embeds = add_text_embeds.to(device)
        cn_prompt = controlnet_prompt_embeds.to(device)
        control_image = control_image.to(device)
        if control_image.shape[0] != 2 * batch:  # [negative; positive] rows as the prompts'
            control_image = torch.cat([control_image[:batch]] * 2)
        state = self.scheduler.set_timesteps(num_inference_steps)
        if latents is None:  # the whole batch's draw on every rank, then its slice
            latents = torch.randn((batch, height // 8, width // 8, 4), generator=generator,
                                  device=device, dtype=torch.float32)
        latents = latents[rows].to(device, torch.float32).permute(0, 3, 1, 2)
        latents = latents * float(state.init_noise_sigma)
        if ip_adapter_image_embeds is not None:
            ip_adapter_image_embeds = ip_adapter_image_embeds[:batch][rows]
        if mesh is not None:
            prompt_embeds, add_text_embeds, cn_prompt, control_image = (
                meshes.take_cfg(mesh, x, batch)
                for x in (prompt_embeds, add_text_embeds, cn_prompt, control_image))
            batch = rows.stop - rows.start
        timestep_cond = None
        if time_cond_dim is not None:  # LCM: the guidance scale is an input, not CFG
            timestep_cond = guidance_scale_embedding(
                torch.full((batch,), guidance_scale - 1.0, device=device), time_cond_dim)
        if not do_cfg:
            prompt_embeds, add_text_embeds = prompt_embeds[batch:], add_text_embeds[batch:]
            # the first control rows, as JAX takes control_image[:batch]
            cn_prompt, control_image = cn_prompt[batch:], control_image[:batch]
        model_batch = 2 * batch if do_cfg else batch

        add_time_ids = sdxl_add_time_ids(original_size or (height, width), (0, 0),
                                         (height, width), model_batch, prompt_embeds.dtype,
                                         device)
        added = {"text_embeds": add_text_embeds, "time_ids": add_time_ids}
        if ip_adapter_image_embeds is not None:
            image_embeds = ip_adapter_image_embeds.to(device)
            if do_cfg:
                image_embeds = torch.cat([torch.zeros_like(image_embeds), image_embeds])
            added["image_embeds"] = image_embeds

        ctx = dict(prompt_embeds=prompt_embeds, added=added, cn_prompt=cn_prompt,
                   control_image=control_image.permute(0, 3, 1, 2),
                   window=control_window(num_inference_steps, control_guidance_start,
                                         control_guidance_end),
                   conditioning_scale=float(controlnet_conditioning_scale),
                   guidance_scale=float(guidance_scale),
                   guidance_rescale=float(guidance_rescale), do_cfg=do_cfg,
                   timestep_cond=timestep_cond, skip_conv_in=bool(skip_conv_in),
                   skip_time_emb=bool(skip_time_emb), guess_mode=bool(guess_mode),
                   control_latent_size=control_latent_size)
        latents = self._sample(latents, num_inference_steps, ctx).permute(0, 2, 3, 1)
        if output_type != "latent":
            latents = self._decode(latents, vae_scaling_factor)
        return latents if mesh is None else meshes.gather(mesh, latents)
