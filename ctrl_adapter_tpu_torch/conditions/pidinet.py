"""PiDiNet soft edges (table 5, ``carv4`` with ``--sa --dil``): the network,
its ``table5_pidinet.pth`` loader and the estimator ``SoftEdgePidiNet``.

Counterpart of ``ctrl_adapter_tpu/conditions/pidinet.py``. The pixel-difference
convolutions (central ``cd``, angular ``ad``, radial ``rd``) are linear
reparameterisations of plain ones, so ``convert_pdc`` turns the checkpoint's
raw weights into plain kernels once, at load (``rd`` becomes 5x5), and the
forward runs only plain convolutions: the init conv (3 -> 60), four stages
of depthwise blocks (60 / 120 / 240 / 240 channels, a 2x2 max pool and a 1x1
shortcut opening stages 2-4), per stage a CDCM (1x1, then four 3x3 convs
dilated 5 / 7 / 9 / 11, summed), a CSAM gate and a 1x1 reduce to one
channel, the four side maps ``bilinear_resize``d to the input size, a 1x1
classifier over them and a sigmoid. fp32.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize
from .imgproc import as_batches, edge_pad, gray_maps

# table-5 config "carv4": [cd, ad, rd, cv] over the 16 difference convs
CARV4 = ("cd", "ad", "rd", "cv") * 4


def convert_pdc(op: str, weight: torch.Tensor) -> torch.Tensor:
    """A raw PDC weight (o, i, 3, 3) -> the plain kernel that computes it.

    cd: conv(x, w) - x sum(w): the spatial sum taken off the centre tap.
    ad: conv(x, w - w shifted clockwise).
    rd: a 5x5 kernel: the radius-2 ring holds w[1:], the radius-1 ring -w[1:].
    cv: unchanged."""
    w = weight.to(torch.float32)
    o, i = w.shape[:2]
    if op == "cv":
        return w.clone()
    if op == "cd":
        out = w.clone()
        out[:, :, 1, 1] -= w.sum(dim=(2, 3))
        return out
    flat = w.reshape(o, i, 9)
    if op == "ad":
        return (flat - flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(w.shape)
    if op == "rd":
        buf = torch.zeros(o, i, 25, dtype=w.dtype)
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, 1:]
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, 1:]
        return buf.reshape(o, i, 5, 5)
    raise ValueError(f"unknown pdc op: {op}")


class _PDCBlock(nn.Module):
    """Depthwise (converted) conv -> relu -> 1x1, plus the input; a stride-2
    block max-pools first and projects the shortcut with a 1x1."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, **kw):
        super().__init__()
        self.stride = stride
        if stride > 1:
            self.shortcut = nn.Conv2d(cin, cout, 1, **kw)
        self.conv1 = nn.Conv2d(cin, cin, kernel, padding=kernel // 2, groups=cin, bias=False,
                               **kw)
        self.conv2 = nn.Conv2d(cin, cout, 1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.stride > 1:
            x = self.shortcut(x)
        return x + y


class _CDCM(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1, **kw)
        for j, d in enumerate((5, 7, 9, 11)):
            setattr(self, f"conv2_{j + 1}",
                    nn.Conv2d(cout, cout, 3, padding=d, dilation=d, bias=False, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(F.relu(x))
        return sum(getattr(self, f"conv2_{j}")(x) for j in (1, 2, 3, 4))


class _CSAM(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, 4, 1, **kw)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class _MapReduce(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(ch, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _blocks(pdcs: Sequence[str]):
    """(stage, block, op) of the 15 block convs, in the checkpoint's order."""
    out, i = [], 1
    for s in range(4):
        for b in range(3 if s == 0 else 4):
            out.append((s, b, pdcs[i]))
            i += 1
    return out


class PiDiNet(nn.Module):
    """(b, 3, H, W) RGB in [0, 1] -> (b, H, W) edge probability, with the
    converted kernels (``load_pidinet``) and the checkpoint's names."""

    def __init__(self, inplane: int = 60, dil: int = 24, pdcs: Sequence[str] = CARV4,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pdcs = tuple(pdcs)
        k0 = 5 if pdcs[0] == "rd" else 3
        self.init_block = nn.Conv2d(3, inplane, k0, padding=k0 // 2, bias=False, **kw)
        planes = (inplane, 2 * inplane, 4 * inplane, 4 * inplane)
        for s, b, op in _blocks(pdcs):
            cin = planes[s - 1] if (s > 0 and b == 0) else planes[s]
            setattr(self, f"block{s + 1}_{b + 1}",
                    _PDCBlock(cin, planes[s], 5 if op == "rd" else 3,
                              2 if (s > 0 and b == 0) else 1, **kw))
        self.dilations = nn.ModuleList([_CDCM(p, dil, **kw) for p in planes])
        self.attentions = nn.ModuleList([_CSAM(dil, **kw) for _ in planes])
        self.conv_reduces = nn.ModuleList([_MapReduce(dil, **kw) for _ in planes])
        self.classifier = nn.Conv2d(4, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        x = self.init_block(x)
        feats = []
        for s in range(4):
            for b in range(3 if s == 0 else 4):
                x = getattr(self, f"block{s + 1}_{b + 1}")(x)
            feats.append(x)
        sides = []
        for i, f in enumerate(feats):
            e = self.conv_reduces[i](self.attentions[i](self.dilations[i](f)))
            sides.append(e if tuple(e.shape[-2:]) == hw else bilinear_resize(e, hw))
        return torch.sigmoid(self.classifier(torch.cat(sides, dim=1)))[:, 0]


def pidinet_state_dict(checkpoint: Mapping, pdcs: Sequence[str] = CARV4
                       ) -> Dict[str, torch.Tensor]:
    """A PiDiNet training checkpoint (``{"state_dict": ...}`` or the state dict,
    ``module.`` prefixes) -> ``PiDiNet``'s state dict, the difference convs
    converted. Keys are checked by ``load_state_dict(strict=True)``."""
    sd = checkpoint.get("state_dict", checkpoint)
    ops = {"init_block.weight": pdcs[0]}
    ops.update({f"block{s + 1}_{b + 1}.conv1.weight": op for s, b, op in _blocks(pdcs)})
    out = {}
    for key, v in sd.items():
        key = key.removeprefix("module.")
        v = torch.as_tensor(v).to(torch.float32)
        out[key] = convert_pdc(ops[key], v) if key in ops else v
    return out


def load_pidinet(model: PiDiNet, checkpoint: Mapping) -> PiDiNet:
    """Loads a checkpoint strictly: every key used, an unknown one raises."""
    model.load_state_dict(pidinet_state_dict(checkpoint, model.pdcs), strict=True)
    return model


class SoftEdgePidiNet:
    """controlnet_aux ``PidiNetDetector`` semantics: uint8 RGB frames,
    edge-padded to a multiple of 8 (three stride-2 stages), / 255, the
    network on ``device``, cropped; ``safe`` quantises to eighths; uint8
    (truncated) gray in three channels."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu"),
                 pdcs: Sequence[str] = CARV4, inplane: int = 60, dil: int = 24):
        self.device = torch.device(device)
        ckpt = torch.load(model_path, map_location="cpu", weights_only=True)
        self.model = PiDiNet(inplane, dil, pdcs, device=self.device).eval().requires_grad_(False)
        load_pidinet(self.model, ckpt)

    def __call__(self, images: Sequence[np.ndarray], safe: bool = False) -> List[np.ndarray]:
        return as_batches(lambda b: self.batch(b, safe), images)

    @torch.no_grad()
    def batch(self, images: np.ndarray, safe: bool = False) -> List[np.ndarray]:
        """(n, h, w, 3) uint8 frames of one shape -> their maps."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        n, h, w = x.shape[:3]
        x = edge_pad(x.permute(0, 3, 1, 2), (-h) % 8, (-w) % 8)
        edge = self.model(x.to(torch.float32) / 255.0)[:, :h, :w]
        if safe:  # controlnet_aux safe_step
            edge = torch.floor(edge * 8 + 0.5) / 8
        return gray_maps(edge)

