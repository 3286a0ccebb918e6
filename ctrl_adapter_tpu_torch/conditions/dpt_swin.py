"""MiDaS ``dpt_swin2_large_384`` depth: the model, its ``.pt`` loader and the
estimator ``DepthDPTSwin``.

Counterpart of ``ctrl_adapter_tpu/conditions/dpt_swin.py``: the SwinV2
backbone (``swin2.py``) under ``pretrained.model`` and the MiDaS scratch head
under ``scratch`` (``layerN_rn`` 3x3 convs without bias to ``features``;
top-down RefineNet fusion, each block ``resConfUnit2(path +
resConfUnit1(skip))`` upsampled with ``bilinear_resize_align_corners`` to the
next level's size, then a 1x1 ``out_conv``; the head conv, x2 upsample,
conv, relu, 1x1 conv, relu), with the checkpoint's names.

``DepthDPTSwin`` preprocesses as the JAX class: a cubic resize (cv2's
``INTER_CUBIC`` in OpenCV's arithmetic on the device,
``ops/resize.py:resize_cubic``) to the model's size, ``(x / 255 - 0.5) / 0.5``;
then the prediction is resized back with the same cubic, min-max normalised
and cast to uint8 (truncated), gray in three channels. It returns uint8 (h,
w, 3) arrays; the JAX class returns PIL images.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize_align_corners, resize_cubic
from .swin2 import SWIN2_LARGE_384, SwinV2Backbone, SwinV2Config

# checkpoint entries the model does not hold: the backbone's buffers (made
# anew by swin2.py), its final norm and classifier head (MiDaS hooks the
# stages before them)
_DROPPED = ("relative_coords_table", "relative_position_index", "attn_mask",
            "pretrained.model.norm.", "pretrained.model.head.")


class _ResidualConvUnit(nn.Module):
    def __init__(self, features: int, **kw):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, **kw)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class _FusionBlock(nn.Module):
    """MiDaS ``FeatureFusionBlock_custom`` (align_corners=True);
    ``resConfUnit1`` exists in every block, refinenet4 never reads it."""

    def __init__(self, features: int, **kw):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1, **kw)
        self.resConfUnit1 = _ResidualConvUnit(features, **kw)
        self.resConfUnit2 = _ResidualConvUnit(features, **kw)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                size=None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size if size is not None else (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(bilinear_resize_align_corners(x, tuple(size)))


class _Pretrained(nn.Module):
    def __init__(self, config: SwinV2Config, **kw):
        super().__init__()
        self.model = SwinV2Backbone(config, **kw)


class _Scratch(nn.Module):
    def __init__(self, config: SwinV2Config, features: int, **kw):
        super().__init__()
        dims = [config.embed_dim * 2 ** i for i in range(len(config.depths))]
        for i, d in enumerate(dims):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(d, features, 3, padding=1, bias=False,
                                                        **kw))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", _FusionBlock(features, **kw))
        # MiDaS's indices: 1 is the x2 Interpolate, 3 and 5 relus, 6 an Identity
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1, **kw), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2d(32, 1, 1, **kw), nn.ReLU(), nn.Identity())


class DPTSwinDepthModel(nn.Module):
    """SwinV2 backbone + MiDaS scratch head: (b, 3, S, S) -> (b, S, S) inverse depth."""

    def __init__(self, config: SwinV2Config = SWIN2_LARGE_384, features: int = 256,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.pretrained = _Pretrained(config, **kw)
        self.scratch = _Scratch(config, features, **kw)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(f)
                          for i, f in enumerate(self.pretrained.model(pixels)))
        path = s.refinenet4(l4, size=l3.shape[-2:])
        path = s.refinenet3(path, l3, size=l2.shape[-2:])
        path = s.refinenet2(path, l2, size=l1.shape[-2:])
        path = s.refinenet1(path, l1)
        head = s.output_conv
        x = head[0](path)
        x = bilinear_resize_align_corners(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = F.relu(head[2](x))
        return F.relu(head[4](x))[:, 0]


def midas_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A MiDaS checkpoint's state dict (or ``{"model": state dict}``) without the
    entries ``DPTSwinDepthModel`` does not hold (``_DROPPED``); raises
    ``KeyError`` when it is not a MiDaS DPT checkpoint."""
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if not any(k.startswith("pretrained.model.") for k in sd):
        raise KeyError("not a MiDaS DPT checkpoint (no pretrained.model.* entries)")
    return {k: v for k, v in sd.items() if not any(d in k for d in _DROPPED)}


class DepthDPTSwin:
    """Depth maps from a MiDaS ``dpt_swin2_*.pt`` checkpoint, fp32 on ``device``."""

    def __init__(self, checkpoint_path: str, config: SwinV2Config = SWIN2_LARGE_384,
                 device: torch.device = torch.device("cpu")):
        sd = midas_state_dict(torch.load(checkpoint_path, map_location="cpu",
                                         weights_only=True))
        self.device = torch.device(device)
        self.model = DPTSwinDepthModel(config, device=self.device).eval().requires_grad_(False)
        self.model.load_state_dict(sd, strict=True)

    @torch.no_grad()
    def __call__(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        size = self.model.config.img_size
        pix = torch.stack([resize_cubic(torch.from_numpy(np.ascontiguousarray(im)).to(
            self.device), (size, size)) for im in images]).permute(0, 3, 1, 2)
        pred = self.model((pix.to(torch.float32) / 255.0 - 0.5) / 0.5)
        out = []
        for p, im in zip(pred, images):
            up = resize_cubic(p, im.shape[:2]).cpu().numpy()
            lo, hi = float(up.min()), float(up.max())
            norm = (up - lo) / (hi - lo) if hi > lo else np.zeros_like(up)
            gray = (255.0 * norm).astype(np.uint8)
            out.append(np.repeat(gray[:, :, None], 3, axis=2))
        return out
