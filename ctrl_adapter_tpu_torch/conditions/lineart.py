"""Line art: the Informative-Drawings generator, and the estimator
``LineartDetector``.

Counterpart of ``ctrl_adapter_tpu/conditions/lineart.py``: a reflect-padded 7x7
stem to 64 channels, two stride-2 3x3 convs (128, 256), ``n`` residual
blocks at 256 (reflect padding), two ``ConvTranspose2d(k=3, s=2, p=1,
output_padding=1)`` (128, 64) and a reflect-padded 7x7 head to one channel
with a sigmoid; every norm an InstanceNorm without affine parameters (eps
1e-5, biased variance, as ``jnp.var``). The modules carry the released
``sk_model.pth`` layout (``model0`` .. ``model4``), so the checkpoint loads
as it is: the transposed convolutions take the released ``(in, out, kh,
kw)`` weights through ``F.conv_transpose2d`` (the JAX converter flips them
only for ``lax.conv_general_dilated``). fp32.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from .imgproc import as_batches, edge_pad, gray_maps


class _ResidualBlock(nn.Module):
    def __init__(self, f: int, **kw):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(f, f, 3, **kw), nn.InstanceNorm2d(f), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(f, f, 3, **kw), nn.InstanceNorm2d(f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class LineartGenerator(nn.Module):
    """(b, 3, H, W) RGB in [0, 1] -> (b, H, W) line probability; H and W
    multiples of 4."""

    def __init__(self, n_residual_blocks: int = 3, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, 64, 7, **kw),
                                    nn.InstanceNorm2d(64), nn.ReLU())
        self.model1 = nn.Sequential(
            nn.Conv2d(64, 128, 3, stride=2, padding=1, **kw), nn.InstanceNorm2d(128), nn.ReLU(),
            nn.Conv2d(128, 256, 3, stride=2, padding=1, **kw), nn.InstanceNorm2d(256), nn.ReLU())
        self.model2 = nn.Sequential(*[_ResidualBlock(256, **kw)
                                      for _ in range(n_residual_blocks)])
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 3, stride=2, padding=1, output_padding=1, **kw),
            nn.InstanceNorm2d(128), nn.ReLU(),
            nn.ConvTranspose2d(128, 64, 3, stride=2, padding=1, output_padding=1, **kw),
            nn.InstanceNorm2d(64), nn.ReLU())
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(64, 1, 7, **kw),
                                    nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model4(self.model3(self.model2(self.model1(self.model0(x)))))[:, 0]


class LineartDetector:
    """controlnet_aux ``LineartDetector`` semantics on a ``sk_model.pth`` state
    dict, fp32 on ``device``: uint8 RGB frames edge-padded to a multiple of 4,
    / 255, the generator, cropped; uint8 (truncated), inverted with
    ``invert`` (white lines on black), gray in three channels."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu"),
                 n_residual_blocks: int = 3):
        self.device = torch.device(device)
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        self.model = LineartGenerator(n_residual_blocks, device=self.device
                                      ).eval().requires_grad_(False)
        self.model.load_state_dict(sd, strict=True)

    def __call__(self, images: Sequence[np.ndarray], invert: bool = True) -> List[np.ndarray]:
        return as_batches(lambda b: self.batch(b, invert), images)

    @torch.no_grad()
    def batch(self, images: np.ndarray, invert: bool = True) -> List[np.ndarray]:
        """(n, h, w, 3) uint8 frames of one shape -> their maps."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        n, h, w = x.shape[:3]
        x = edge_pad(x.permute(0, 3, 1, 2), (-h) % 4, (-w) % 4)
        maps = gray_maps(self.model(x.to(torch.float32) / 255.0)[:, :h, :w])
        return [255 - m for m in maps] if invert else maps
