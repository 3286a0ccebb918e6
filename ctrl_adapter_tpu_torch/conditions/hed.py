"""HED soft edges and scribbles: ``ControlNetHED``, the scribble
post-processing and the estimator ``ScribbleHED``.

Counterpart of ``ctrl_adapter_tpu/conditions/hed.py``: the raw 0-255 pixels
minus the learned ``norm``, five VGG stages (64 / 128 / 256 / 512 / 512
channels, 2 / 2 / 3 / 3 / 3 convs, a 2x2 max pool before stages 2-5), a 1x1
projection of each stage to one side map, the side maps
``bilinear_resize``d to the input size and the sigmoid of their mean; fp32,
with the released ``ControlNetHED.pth`` names. ``scribble=True`` runs
``scribble_postprocess`` on the card: a directional non-maximum suppression
at 127, a gaussian blur and a binarisation at 4, on ``imgproc``'s cv2
arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize
from .imgproc import as_batches, dilate, gaussian_blur, gray_maps

# channels per VGG stage and convs per stage
STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# the four line kernels of the directional suppression
NMS_KERNELS = (((0, 0, 0), (1, 1, 1), (0, 0, 0)),
               ((0, 1, 0), (0, 1, 0), (0, 1, 0)),
               ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
               ((0, 0, 1), (0, 1, 0), (1, 0, 0)))


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, n_convs: int, **kw):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin if j == 0 else cout, cout, 3, padding=1, **kw)
                                    for j in range(n_convs)])
        self.projection = nn.Conv2d(cout, 1, 1, **kw)

    def forward(self, h: torch.Tensor, down: bool):
        if down:
            h = F.max_pool2d(h, 2, 2)
        for conv in self.convs:
            h = F.relu(conv(h))
        return h, self.projection(h)


class ControlNetHED(nn.Module):
    """(b, 3, H, W) raw RGB in [0, 255] -> (b, H, W) edge probability."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1, **kw))
        cin = 3
        for s, (ch, n) in enumerate(STAGES):
            setattr(self, f"block{s + 1}", _Block(cin, ch, n, **kw))
            cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        h = x - self.norm
        sides = []
        for s in range(len(STAGES)):
            h, side = getattr(self, f"block{s + 1}")(h, down=s > 0)
            sides.append(side if tuple(side.shape[-2:]) == hw else bilinear_resize(side, hw))
        return torch.sigmoid(torch.cat(sides, dim=1).mean(dim=1))


def directional_nms(edge: torch.Tensor, threshold: float = 127.0, sigma: float = 3.0
                    ) -> torch.Tensor:
    """(..., h, w) uint8 -> {0, 255} uint8: the float blur of ``edge``, kept
    where it is the largest along any of the four ``NMS_KERNELS`` lines,
    above ``threshold``."""
    x = gaussian_blur(edge.to(torch.float32), sigma)
    y = torch.zeros_like(x)
    for k in NMS_KERNELS:
        y = torch.where(dilate(x, k) == x, x, y)
    return torch.where(y > threshold, 255, 0).to(torch.uint8)


def scribble_postprocess(edge: torch.Tensor) -> torch.Tensor:
    """``HEDdetector(..., scribble=True)``: ``directional_nms`` at 127, the
    uint8 blur at sigma 3, then 255 where it exceeds 4, else 0."""
    m = gaussian_blur(directional_nms(edge, 127.0, 3.0), 3.0)
    return torch.where(m > 4, 255, 0).to(torch.uint8)


class ScribbleHED:
    """HED maps from a ``ControlNetHED.pth`` state dict, fp32 on ``device``:
    uint8 (truncated) edge maps, binarised to scribbles with ``scribble``;
    gray in three channels."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu")):
        self.device = torch.device(device)
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        self.model = ControlNetHED(device=self.device).eval().requires_grad_(False)
        self.model.load_state_dict(sd, strict=True)

    def __call__(self, images: Sequence[np.ndarray], scribble: bool = True) -> List[np.ndarray]:
        return as_batches(lambda b: self.batch(b, scribble), images)

    @torch.no_grad()
    def batch(self, images: np.ndarray, scribble: bool = True) -> List[np.ndarray]:
        """(n, h, w, 3) uint8 frames of one shape -> their maps."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        edge = self.model(x.permute(0, 3, 1, 2).to(torch.float32))
        if not scribble:
            return gray_maps(edge)
        u8 = scribble_postprocess((edge * 255.0).clamp(0, 255).to(torch.uint8))
        return [np.repeat(m[:, :, None], 3, axis=2) for m in u8.cpu().numpy()]
