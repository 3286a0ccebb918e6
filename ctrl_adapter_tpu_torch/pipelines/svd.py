"""SVD (Stable Video Diffusion) + Ctrl-Adapter pipeline.

Counterpart of ``ctrl_adapter_tpu/pipelines/svd.py``:
- EulerDiscrete/EDM backbone; the UNet consumes t = 0.25 * log(sigma) while the
  SD-v1.5 ControlNet gets the discrete remap ``1000 - (i+1)*(1000//steps) + 1``;
- ``skip_conv_in=True`` latents skipping;
- per-frame guidance scale linspace;
- 8-channel UNet input (scaled noisy latents + image latents, zeros for the
  CFG negative half);
- sparse key frames with CFG doubling and zero re-scatter.

The JAX ``lax.scan`` over steps is a Python loop here and the control window a
plain ``if``. The public :meth:`generate` and :meth:`_decode` take and return
the JAX package's layouts: latents (b, f, h, w, 4), video (b, f, H, W, 3).
Inside, tensors are NCHW / (b, f, c, h, w).

``generate(..., mesh=...)`` is the JAX ``mesh=`` argument: the video batch
splits over the processes of a ``parallel.mesh.Mesh`` (one card each), every
rank holds the weights, and the output equals the one-process run over the
whole batch (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.adapter import ControlNetAdapter
from ..models.controlnet import ControlNetModel
from ..models.unet_svd import UNetSpatioTemporalConditionModel
from ..models.vae_temporal import AutoencoderKLTemporalDecoder
from ..ops.resize import adaptive_avg_pool2d
from ..parallel import mesh as meshes
from ..schedulers.euler_discrete import (SVD_EULER_CONFIG, EulerDiscreteScheduler,
                                         EulerDiscreteState)
from .common import control_window, normalize_control_latent_size


def controlnet_timestep_remap(num_inference_steps: int) -> np.ndarray:
    """Equal-distance discrete ControlNet timesteps: step i -> 1000 - (i+1)*(1000//steps) + 1."""
    interval = 1000 // num_inference_steps
    return np.asarray([1000 - (i + 1) * interval + 1 for i in range(num_inference_steps)],
                      dtype=np.float32)


class SVDControlNetAdapterPipeline:
    def __init__(self, unet: UNetSpatioTemporalConditionModel, controlnet: ControlNetModel,
                 adapter: ControlNetAdapter, vae: AutoencoderKLTemporalDecoder,
                 scheduler: Optional[EulerDiscreteScheduler] = None):
        self.unet, self.controlnet, self.adapter, self.vae = unet, controlnet, adapter, vae
        self.scheduler = scheduler or EulerDiscreteScheduler(SVD_EULER_CONFIG)

    def _residuals(self, state: EulerDiscreteState, lat: torch.Tensor, i: int, u: float,
                   image_embeddings: torch.Tensor, cn_prompt: torch.Tensor,
                   control_images: torch.Tensor, sparse_frames: Optional[Tuple[int, ...]],
                   control_latent_size, conditioning_scale: float, skip_conv_in: bool,
                   guess_mode: bool, rows=None
                   ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """ControlNet tower + adapter -> dense (adapted_down, adapted_mid);
        ``rows`` places the adapter's batch in the global one (``global_rows``)."""
        b, f, c, h, w = lat.shape
        lmi = self.scheduler.scale_model_input(state, torch.cat([lat, lat]), i)
        pooled = adaptive_avg_pool2d(lmi.reshape(2 * b * f, c, h, w),
                                     normalize_control_latent_size(control_latent_size))
        downs, mid = self.controlnet(pooled, u, cn_prompt, control_images,
                                     conditioning_scale=conditioning_scale,
                                     skip_conv_in=skip_conv_in, guess_mode=guess_mode)
        use_mid = "M" in self.adapter.adapter_locations
        # positive CLIP image embedding per video, tiled over both CFG halves
        adapter_ehs = image_embeddings[b:].repeat(2, 1, 1)
        idx = None
        adapter_frames = f
        if sparse_frames is not None:
            idx = torch.tensor([v * f + p for v in range(2 * b) for p in sparse_frames],
                               device=lat.device)
            adapter_frames = len(sparse_frames)
            downs = [d[idx] for d in downs]
            mid = mid[idx]
        with meshes.global_rows(rows):
            down, mid = self.adapter(downs, mid if use_mid else None,
                                     num_frames=adapter_frames, timestep=u,
                                     encoder_hidden_states=adapter_ehs)
        if idx is not None:
            def scatter(a):
                dense = torch.zeros((2 * b * f,) + tuple(a.shape[1:]), dtype=a.dtype,
                                    device=a.device)
                dense[idx] = a
                return dense
            down = [scatter(a) for a in down]
            mid = None if mid is None else scatter(mid)
        return list(down), mid

    @torch.no_grad()
    def _sample(self, latents: torch.Tensor, image_latents: torch.Tensor,
                image_embeddings: torch.Tensor, controlnet_prompt_embeds: torch.Tensor,
                added_time_ids: torch.Tensor, control_images: torch.Tensor,
                num_inference_steps: int, window: Tuple[int, int],
                sparse_frames: Optional[Tuple[int, ...]], skip_conv_in: bool,
                control_latent_size, conditioning_scale: float, guidance: torch.Tensor,
                guess_mode: bool = False, rows=(None, None)) -> torch.Tensor:
        """Denoise loop over (b, f, 4, h, w) float32 latents; ``rows`` are the
        UNet's and the adapter's places in the global batch (None: this is
        the whole batch)."""
        state = self.scheduler.set_timesteps(num_inference_steps)
        cn_timesteps = controlnet_timestep_remap(num_inference_steps)
        b, f = latents.shape[:2]
        cn_prompt = controlnet_prompt_embeds.repeat_interleave(f, dim=0)
        guidance_b = guidance[None, :, None, None, None]
        lo, hi = window
        for i in range(num_inference_steps):
            down = mid = None
            if lo <= i < hi:
                down, mid = self._residuals(
                    state, latents, i, float(cn_timesteps[i]), image_embeddings, cn_prompt,
                    control_images, sparse_frames, control_latent_size, conditioning_scale,
                    skip_conv_in, guess_mode, rows[1])
            lmi = self.scheduler.scale_model_input(state, torch.cat([latents, latents]), i)
            lmi = torch.cat([lmi, image_latents.to(lmi.dtype)], dim=2)
            t = state.timesteps[i].to(latents.device).expand(2 * b)
            with meshes.global_rows(rows[0]):
                noise_pred = self.unet(lmi, t, image_embeddings, added_time_ids,
                                       down_block_additional_residuals=down,
                                       mid_block_additional_residual=mid).float()
            uncond, cond = noise_pred.chunk(2)
            noise_pred = uncond + guidance_b * (cond - uncond)
            latents = self.scheduler.step(state, noise_pred, i, latents)
        return latents

    @torch.no_grad()
    def _decode(self, latents: torch.Tensor, scaling_factor: float,
                decode_chunk_size: Optional[int] = None) -> torch.Tensor:
        """Frame-chunked temporal-VAE decode of (b, f, h, w, 4) latents into a
        (b, f, H, W, 3) video in [0, 1]. The chunk size changes the numbers (the
        decoder's (3,1,1) convs mix only frames inside one chunk); None decodes
        one whole video per chunk, as the reference does."""
        b, f, h, w, c = latents.shape
        z = latents.permute(0, 1, 4, 2, 3) / scaling_factor
        chunk = f if decode_chunk_size is None else min(decode_chunk_size, f)
        pad = (-f) % chunk
        if pad:
            z = torch.cat([z, torch.zeros((b, pad, c, h, w), dtype=z.dtype, device=z.device)],
                          dim=1)
        chunks = z.reshape(b * (f + pad) // chunk, chunk, c, h, w)
        video = torch.stack([self.vae.decode(zc, chunk) for zc in chunks])
        video = video.reshape(b, f + pad, *video.shape[2:])[:, :f]
        return torch.clamp(video / 2 + 0.5, 0.0, 1.0).permute(0, 1, 3, 4, 2)

    @torch.no_grad()
    def generate(self, image_embeddings: torch.Tensor, image_latent: torch.Tensor,
                 controlnet_prompt_embeds: torch.Tensor, control_images: torch.Tensor,
                 height: int = 512, width: int = 512, num_frames: int = 14, fps: int = 7,
                 motion_bucket_id: int = 127, noise_aug_strength: float = 0.02,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0, controlnet_conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0, control_guidance_end: float = 0.8,
                 sparse_frames: Optional[Sequence[int]] = None, skip_conv_in: bool = True,
                 guess_mode: bool = False, vae_scaling_factor: float = 0.18215,
                 control_latent_size=64, latents: Optional[torch.Tensor] = None,
                 output_type: str = "np", decode_chunk_size: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 mesh: Optional[meshes.Mesh] = None) -> torch.Tensor:
        """image_embeddings (b, 1, 1024); image_latent (b, h/8, w/8, 4);
        controlnet_prompt_embeds (2b, 77, 768); control_images (b*f, H, W, 3)
        in [0, 1]; latents (b, f, h/8, w/8, 4) or None (drawn from ``generator``).
        Returns the (b, f, H, W, 3) video, or the latents for output_type="latent".
        With ``mesh``, every rank passes the whole batch and gets the whole
        result; it runs its own slice of the videos (b must divide over the
        ranks), with the noise of the one-process draw."""
        device = torch.device(device) if device is not None else self.unet.conv_in.weight.device
        b = image_embeddings.shape[0]
        rows = meshes.batch_rows(mesh, b) if mesh is not None else slice(0, b)
        state = self.scheduler.set_timesteps(num_inference_steps)
        if latents is None:  # the whole batch's draw on every rank, then its slice
            latents = torch.randn((b, num_frames, height // 8, width // 8, 4),
                                  generator=generator, device=device, dtype=torch.float32)
        latents = latents[rows].to(device, torch.float32).permute(0, 1, 4, 2, 3)
        latents = latents * state.init_noise_sigma.to(device)

        image_embeddings = image_embeddings.to(device)
        places = (None, None)  # the UNet's and the adapter's rows in the global batch
        if mesh is not None:
            index = meshes.cfg_index(mesh, b, device)
            places = (  # the UNet's context [zeros; embeddings], the adapter's [pos; pos]
                meshes.GlobalRows(torch.cat([torch.zeros_like(image_embeddings),
                                             image_embeddings]), index),
                meshes.GlobalRows(image_embeddings.repeat(2, 1, 1), index))
            image_latent, image_embeddings = image_latent[rows], image_embeddings[rows]
            controlnet_prompt_embeds = meshes.take_cfg(mesh, controlnet_prompt_embeds, b)
            control_images = control_images[rows.start * num_frames:rows.stop * num_frames]
            b = rows.stop - rows.start
        il = image_latent.to(device).permute(0, 3, 1, 2)[:, None]
        il = il.expand(b, num_frames, *il.shape[2:])
        image_latents = torch.cat([torch.zeros_like(il), il])
        image_embeddings_cfg = torch.cat([torch.zeros_like(image_embeddings), image_embeddings])
        added_time_ids = torch.tensor(
            [[float(fps - 1), float(motion_bucket_id), float(noise_aug_strength)]],
            dtype=torch.float32, device=device).repeat(2 * b, 1)
        control_images = control_images.to(device).permute(0, 3, 1, 2)
        control_images = torch.cat([control_images, control_images])
        guidance = torch.from_numpy(np.linspace(min_guidance_scale, max_guidance_scale,
                                                num_frames).astype(np.float32)).to(device)
        window = control_window(num_inference_steps, control_guidance_start,
                                control_guidance_end)
        latents = self._sample(
            latents, image_latents, image_embeddings_cfg, controlnet_prompt_embeds.to(device),
            added_time_ids, control_images, num_inference_steps, window,
            tuple(int(i) for i in sparse_frames) if sparse_frames is not None else None,
            skip_conv_in, control_latent_size, float(controlnet_conditioning_scale), guidance,
            bool(guess_mode), places)
        latents = latents.permute(0, 1, 3, 4, 2)
        if output_type != "latent":
            latents = self._decode(latents, vae_scaling_factor, decode_chunk_size)
        return latents if mesh is None else meshes.gather(mesh, latents)
