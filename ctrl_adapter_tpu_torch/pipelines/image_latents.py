"""VAE encoding of the I2VGen-XL conditioning image.

Counterpart of ``ctrl_adapter_tpu/pipelines/image_latents.py:encode_first_frame_latent``:
``vae.encode(image).latent_dist.sample()`` of the first frame, unscaled (the
pipeline applies ``vae_scaling_factor`` and builds the frame-position mask).
The image comes in [0, 1] and the latent goes out in the JAX package's
layout, (b, h/8, w/8, 4).
"""

from __future__ import annotations

from typing import Optional

import torch


def encode_first_frame_latent(vae, image_unit: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """image_unit (h, w, 3) or (b, h, w, 3) in [0, 1] -> the sampled latent
    mean + exp(logvar / 2) * noise, (b, h/8, w/8, 4) float32. The noise is drawn
    from ``generator`` unless given, (b, h/8, w/8, 4)."""
    x = image_unit.float()
    if x.dim() == 3:
        x = x[None]
    dev = next(vae.parameters()).device
    x = (x * 2.0 - 1.0).permute(0, 3, 1, 2).to(dev)
    mean, logvar = (m.float().permute(0, 2, 3, 1) for m in vae.encode_moments(x))
    if noise is None:
        if generator is None:
            raise ValueError("encode_first_frame_latent needs a generator or the noise")
        noise = torch.randn(mean.shape, generator=generator, device=dev)
    return mean + torch.exp(0.5 * logvar) * noise.to(dev, torch.float32)
