"""I2VGen-XL + Ctrl-Adapter video pipeline: multi-expert control, router, sparse frames.

Counterpart of ``ctrl_adapter_tpu/pipelines/i2vgenxl.py``:

- a CFG-doubled (2b, f) batch; the SD-v1.5 ControlNet experts run on the
  (2b*f) latents pooled to ``control_latent_size``, each with its own scale and
  [start, end) window; a masked expert is never run, and the loop skips the
  control towers on steps outside the union of the active experts' windows;
- the experts' residuals fused by the router's weights (equal and simple
  weights once per call, conditional types per step from the positive-half CLIP
  image embedding), or summed without a router;
- sparse key frames selected per video across the (2b, f) layout, the adapter
  run at ``len(sparse_frames)`` frames and its output scattered back
  zero-filled;
- the adapter conditioned on the positive CLIP image embedding, tiled over both
  CFG halves; DDIM over float32 (b, f) latents; the 2D VAE decode in chunks of
  2 frames (zero-padded), then ``clip(x / 2 + 0.5)``.

The JAX ``lax.scan`` over steps is a Python loop here. :meth:`generate` takes
and returns the JAX package's layouts: latents (b, f, h, w, 4), control images
(E, b*f, H, W, 3), video (b, f, H, W, 3). Inside, tensors are NCHW /
(b, f, c, h, w). Everything runs on the device of the UNet's weights, and the
denoise loop makes no copy between the host and the device.

``generate(..., mesh=...)`` is the JAX ``mesh=`` argument: the video batch
splits over the processes of a ``parallel.mesh.Mesh`` (the control images on
their axis 1), and the output equals the one-process run over the whole
batch; a conditional router reads the global batch mean of the CLIP
embeddings (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.adapter import ControlNetAdapter
from ..models.controlnet import ControlNetModel
from ..models.multicontrolnet import MultiControlNetModel
from ..models.router import ControlNetRouter, build_router_input, fuse_expert_residuals
from ..models.unet_i2vgen import I2VGenXLUNet
from ..models.vae import AutoencoderKL
from ..ops.resize import adaptive_avg_pool2d
from ..parallel import mesh as meshes
from ..schedulers.ddim import DDIMConfig, DDIMScheduler
from .common import classifier_free_guidance, control_window, normalize_control_latent_size


def _per_expert(value, num_experts: int, name: str) -> List[float]:
    """A scalar for every expert, or one value per expert."""
    vals = ([float(value)] * num_experts if np.ndim(value) == 0
            else [float(x) for x in value])
    if len(vals) != num_experts:
        raise ValueError(f"{name} has {len(vals)} entries for {num_experts} experts")
    return vals


class I2VGenXLControlNetAdapterPipeline:
    def __init__(self, unet: I2VGenXLUNet,
                 controlnet: Union[ControlNetModel, MultiControlNetModel],
                 adapter: ControlNetAdapter, vae: AutoencoderKL,
                 router: Optional[ControlNetRouter] = None,
                 scheduler: Optional[DDIMScheduler] = None):
        if isinstance(controlnet, ControlNetModel):
            controlnet = MultiControlNetModel([controlnet])
        self.unet, self.controlnet, self.adapter, self.vae = unet, controlnet, adapter, vae
        self.router = router
        self.scheduler = scheduler or DDIMScheduler(DDIMConfig())

    def _router_weights(self, t: Optional[float], clip_embeddings: Optional[torch.Tensor],
                        mask: torch.Tensor, active: torch.Tensor):
        """The router's (down, mid) weights of the ``active`` experts (indices
        on the device); conditional types read the timestep ``t`` and the
        positive CLIP image embeddings, and build their input on the
        embeddings' device."""
        router_in = None
        if self.router.conditional:
            router_in = build_router_input(self.router.router_type, t, clip_embeddings)
        down, mid = self.router(router_in, sparse_mask=mask)
        return down[:, active], (None if mid is None else mid[active])

    def _residuals(self, lat: torch.Tensor, i: int, t: float, ctx) -> Tuple[list, Any]:
        """ControlNet experts -> router fusion -> adapter -> dense (down, mid)."""
        b, f, c, h, w = lat.shape
        lmi = torch.cat([lat, lat])
        pooled = adaptive_avg_pool2d(lmi.reshape(2 * b * f, c, h, w),
                                     normalize_control_latent_size(ctx["control_latent_size"]))
        cn_t = (float(ctx["fixed_controlnet_timestep"]) if ctx["fixed_controlnet_timestep"] >= 0
                else t)
        lo, hi = ctx["window"]
        scales = []
        for e, ((elo, ehi), scale) in enumerate(zip(ctx["expert_windows"], ctx["scales"])):
            # an expert whose window is narrower than the loop's is gated inside it
            keep = 1.0 if (elo, ehi) == (lo, hi) else float(elo <= i < ehi)
            scales.append(scale * keep)
        per_down, per_mid = self.controlnet(
            pooled, cn_t, ctx["cn_prompt"], ctx["control_images"], conditioning_scale=scales,
            skip_conv_in=ctx["skip_conv_in"], expert_mask=ctx["expert_mask"],
            guess_mode=ctx["guess_mode"])
        if ctx["conditional_router"]:
            dw, mw = self._router_weights(t, ctx["clip_pos"], ctx["mask"], ctx["active_idx"])
        else:
            dw, mw = ctx["down_w"], ctx["mid_w"]
        down, mid = fuse_expert_residuals(per_down, per_mid, dw, mw)

        use_mid = "M" in self.adapter.adapter_locations
        idx = ctx["sparse_idx"]
        adapter_frames = f
        if idx is not None:
            adapter_frames = len(ctx["sparse_frames"])
            down = [d[idx] for d in down]
            mid = None if mid is None else mid[idx]
        with meshes.global_rows(ctx["adapter_rows"]):
            down, mid = self.adapter(down, mid if use_mid else None,
                                     num_frames=adapter_frames, timestep=t,
                                     encoder_hidden_states=ctx["adapter_ehs"])
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
    def _sample(self, latents: torch.Tensor, num_inference_steps: int, ctx) -> torch.Tensor:
        """Denoise loop over (b, f, 4, h, w) float32 latents."""
        state = self.scheduler.set_timesteps(num_inference_steps)
        b = latents.shape[0]
        lo, hi = ctx["window"]
        fps = torch.full((2 * b,), float(ctx["target_fps"]), dtype=torch.float32,
                         device=latents.device)
        for i in range(num_inference_steps):
            t = float(state.timesteps[i])
            down = mid = None
            if lo <= i < hi:
                down, mid = self._residuals(latents, i, t, ctx)
            noise_pred = self.unet(torch.cat([latents, latents]), t, fps, ctx["image_latents"],
                                   ctx["image_embeddings"], ctx["prompt_embeds"],
                                   down_block_additional_residuals=down,
                                   mid_block_additional_residual=mid).float()
            noise_pred = classifier_free_guidance(noise_pred, ctx["guidance_scale"])
            latents = self.scheduler.step(state, noise_pred, i, latents)
        return latents

    @torch.no_grad()
    def _decode(self, latents: torch.Tensor, scaling_factor: float,
                decode_chunk_size: int = 2) -> torch.Tensor:
        """Frame-chunked 2D VAE decode of (b, f, h, w, 4) latents into a
        (b, f, H, W, 3) video in [0, 1]."""
        b, f, h, w, c = latents.shape
        flat = latents.reshape(b * f, h, w, c).permute(0, 3, 1, 2) / scaling_factor
        n = flat.shape[0]
        chunk = min(decode_chunk_size, n)
        pad = (-n) % chunk
        if pad:
            flat = torch.cat([flat, torch.zeros((pad, c, h, w), dtype=flat.dtype,
                                                device=flat.device)])
        video = torch.cat([self.vae.decode(z) for z in flat.split(chunk)])[:n]
        video = torch.clamp(video / 2 + 0.5, 0.0, 1.0)
        return video.permute(0, 2, 3, 1).reshape(b, f, *video.shape[2:], video.shape[1])

    @torch.no_grad()
    def generate(self, prompt_embeds: torch.Tensor, controlnet_prompt_embeds: torch.Tensor,
                 image_embeddings: torch.Tensor, first_frame_latent: torch.Tensor,
                 control_images: torch.Tensor, height: int = 512, width: int = 512,
                 num_frames: int = 16, target_fps: int = 16, num_inference_steps: int = 50,
                 guidance_scale: float = 9.0, controlnet_conditioning_scale: Any = 1.0,
                 control_guidance_start: Any = 0.0, control_guidance_end: Any = 0.8,
                 sparse_frames: Optional[Sequence[int]] = None,
                 inference_expert_masks: Optional[Sequence[bool]] = None,
                 skip_conv_in: bool = False, guess_mode: bool = False,
                 fixed_controlnet_timestep: int = -1, vae_scaling_factor: float = 0.18215,
                 control_latent_size=64, latents: Optional[torch.Tensor] = None,
                 output_type: str = "np", return_router_weights: bool = False,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[meshes.Mesh] = None):
        """prompt_embeds (2b, 77, 1024) [negative; positive]; controlnet_prompt_embeds
        (2b, 77, 768); image_embeddings (b, 1, 1024), the positive CLIP image
        embedding; first_frame_latent (b, h/8, w/8, 4), the unscaled VAE sample;
        control_images (E, b*f, H, W, 3) or (b*f, H, W, 3) in [0, 1]; latents
        (b, f, h/8, w/8, 4) or None (drawn from ``generator``). Scale, start and
        end take a value per expert or one for all. Returns the (b, f, H, W, 3)
        video (the latents for output_type="latent"), and with
        ``return_router_weights`` also the router's per-step (down, mid) weights
        over the control window, as lists. With ``mesh``, every rank passes
        the whole batch and gets the whole result; it runs its own slice of
        the videos (b must divide over the ranks), with the noise of the
        one-process draw."""
        device = self.unet.conv_in.weight.device
        b = image_embeddings.shape[0]
        rows = meshes.batch_rows(mesh, b) if mesh is not None else slice(0, b)
        if latents is None:  # the whole batch's draw on every rank, then its slice
            latents = torch.randn((b, num_frames, height // 8, width // 8, 4),
                                  generator=generator, device=device, dtype=torch.float32)
        latents = latents[rows].to(device, torch.float32).permute(0, 1, 4, 2, 3)
        image_embeddings = image_embeddings.to(device)
        all_embeddings, adapter_rows = image_embeddings, None
        control_images = control_images.to(device)
        if control_images.dim() == 4:
            control_images = control_images[None]
        prompt_embeds = prompt_embeds.to(device)
        controlnet_prompt_embeds = controlnet_prompt_embeds.to(device)
        if mesh is not None:
            adapter_rows = meshes.GlobalRows(image_embeddings.repeat(2, 1, 1),
                                             meshes.cfg_index(mesh, b, device))
            prompt_embeds = meshes.take_cfg(mesh, prompt_embeds, b)
            controlnet_prompt_embeds = meshes.take_cfg(mesh, controlnet_prompt_embeds, b)
            first_frame_latent, image_embeddings = first_frame_latent[rows], image_embeddings[rows]
            control_images = control_images[:, rows.start * num_frames:rows.stop * num_frames]
            b = rows.stop - rows.start

        # frame-position-mask image latents: frame 0 the scaled latent, frame i
        # the constant i / (f - 1); duplicated for CFG
        il = first_frame_latent.to(device, torch.float32).permute(0, 3, 1, 2) * vae_scaling_factor
        frames = [il] + [torch.full_like(il, i / (num_frames - 1))
                         for i in range(1, num_frames)]
        il_frames = torch.stack(frames, dim=1)
        image_embeddings_cfg = torch.cat([torch.zeros_like(image_embeddings), image_embeddings])

        num_experts = control_images.shape[0]
        control_images = control_images.permute(0, 1, 4, 2, 3)
        control_images = torch.cat([control_images, control_images], dim=1)
        expert_mask = tuple(bool(m) for m in (inference_expert_masks or [True] * num_experts))
        active = [e for e in range(num_experts) if expert_mask[e]]

        scales = _per_expert(controlnet_conditioning_scale, num_experts,
                             "controlnet_conditioning_scale")
        starts = _per_expert(control_guidance_start, num_experts, "control_guidance_start")
        ends = _per_expert(control_guidance_end, num_experts, "control_guidance_end")
        expert_windows = [control_window(num_inference_steps, s, e)
                          for s, e in zip(starts, ends)]
        # the loop's control window: the union of the active experts' windows
        active_windows = [w_ for w_, m in zip(expert_windows, expert_mask) if m]
        if active_windows and any(hi > lo for lo, hi in active_windows):
            window = (min(lo for lo, hi in active_windows if hi > lo),
                      max(hi for _, hi in active_windows))
        else:
            window = (0, 0)

        mask = torch.tensor([1.0 if m else 0.0 for m in expert_mask], device=device)
        active_idx = torch.tensor(active, device=device)
        use_router = self.router is not None and num_experts > 1
        conditional_router = use_router and self.router.conditional
        clip_pos = image_embeddings_cfg[b:]
        if mesh is not None and conditional_router:
            # the router's batch mean over all the ranks' videos: (1, 1, D)
            clip_pos = meshes.all_reduce_mean(mesh, clip_pos.float().mean(dim=1))[None, None]
        down_w = mid_w = None  # routerless: the experts' residuals summed
        if use_router and not conditional_router:  # weights constant over the steps
            down_w, mid_w = self._router_weights(None, None, mask, active_idx)
        sparse = tuple(int(p) for p in sparse_frames) if sparse_frames is not None else None
        sparse_idx = None if sparse is None else torch.tensor(
            [v * num_frames + p for v in range(2 * b) for p in sparse], device=device)
        ctx = dict(
            prompt_embeds=prompt_embeds,
            cn_prompt=controlnet_prompt_embeds.repeat_interleave(num_frames, dim=0),
            image_embeddings=image_embeddings_cfg, clip_pos=clip_pos,
            adapter_ehs=image_embeddings_cfg[b:].repeat(2, 1, 1), adapter_rows=adapter_rows,
            image_latents=torch.cat([il_frames, il_frames]), control_images=control_images,
            target_fps=target_fps, guidance_scale=float(guidance_scale), window=window,
            expert_windows=expert_windows, scales=scales, expert_mask=expert_mask,
            active_idx=active_idx, mask=mask, conditional_router=conditional_router, down_w=down_w,
            mid_w=mid_w, sparse_frames=sparse, sparse_idx=sparse_idx,
            skip_conv_in=bool(skip_conv_in), guess_mode=bool(guess_mode),
            fixed_controlnet_timestep=int(fixed_controlnet_timestep),
            control_latent_size=control_latent_size)
        latents = self._sample(latents, num_inference_steps, ctx).permute(0, 1, 3, 4, 2)
        result = (latents if output_type == "latent"
                  else self._decode(latents, vae_scaling_factor))
        if mesh is not None:
            result = meshes.gather(mesh, result)
        if not (return_router_weights and self.router is not None):
            return result
        # one entry per step of the control window; equal and simple weights
        # are the same at every step
        state = self.scheduler.set_timesteps(num_inference_steps)
        lo, hi = window
        trace_down, trace_mid = [], []
        for i in range(lo, hi):
            router_in = None
            if self.router.conditional:
                router_in = build_router_input(self.router.router_type,
                                               float(state.timesteps[i]), all_embeddings[-1:])
            dw, mw = self.router(router_in, sparse_mask=mask)
            trace_down.append(dw.cpu().numpy().tolist())
            trace_mid.append(None if mw is None else mw.cpu().numpy().tolist())
            if not self.router.conditional:
                trace_down, trace_mid = trace_down * (hi - lo), trace_mid * (hi - lo)
                break
        return result, trace_down, trace_mid
