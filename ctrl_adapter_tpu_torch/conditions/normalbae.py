"""Surface normals: NNET (``scannet.pt``), its loader and the estimator
``NormalBaeDetector``.

Counterpart of ``ctrl_adapter_tpu/conditions/normalbae.py``: a
tf_efficientnet_b5_ap encoder (TF "SAME" padding: at stride 2 the extra row
and column go at the bottom and right, done with ``F.pad``; squeeze-excite
gates whose width comes from the block's input) tapped after stages 0, 1,
2 and 4 and after ``conv_head``; a decoder that upsamples with
``bilinear_resize_align_corners``, concatenates the skip and runs two 3x3
convs with leaky relus (``up1`` .. ``up4``); a 3x3 head at 1/8 and three
per-pixel MLPs (1x1 convs 128-128-128-4) at 1/4, 1/2 and 1/1 over the
upsampled features and the upsampled previous prediction; every prediction
``norm_normalize``d. Every BatchNorm is folded into its conv at load (eps
1e-3 in the encoder, 1e-5 in the decoder), as the JAX ``_fold_bn``. fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize_align_corners
from .imgproc import as_batches, edge_pad

# tf_efficientnet_b5: (repeats, kernel, stride, expand_ratio, out_channels)
B5_STEM = 48
B5_STAGES = ((3, 3, 1, 1, 24), (5, 3, 2, 6, 40), (5, 5, 2, 6, 64),
             (7, 3, 2, 6, 128), (7, 5, 1, 6, 176), (9, 5, 2, 6, 304),
             (3, 3, 1, 6, 512))
B5_HEAD = 2048
DECODER_DIMS = (2048, 1024, 512, 256, 128)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_TAPS = (0, 1, 2, 4)  # the encoder stages the decoder reads


def _same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` with TF "SAME" padding (the odd pixel at the bottom / right)."""
    pads = []
    for n, k, s in zip(x.shape[-2:], conv.kernel_size, conv.stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return conv(F.pad(x, (*pads[1], *pads[0])))


class _SqueezeExcite(nn.Module):
    def __init__(self, ch: int, mid: int, **kw):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, mid, 1, **kw)
        self.conv_expand = nn.Conv2d(mid, ch, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(s))


class _MBConv(nn.Module):
    """An EfficientNet block with folded BNs: ``expand == 1`` is depthwise ->
    SE -> pointwise, otherwise pointwise expand -> depthwise -> SE ->
    pointwise; the input added back at stride 1 and equal widths."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int, **kw):
        super().__init__()
        self.expand, self.residual = expand, stride == 1 and cin == cout
        mid = cin * expand
        if expand != 1:
            self.conv_pw = nn.Conv2d(cin, mid, 1, **kw)
        self.conv_dw = nn.Conv2d(mid, mid, kernel, stride=stride, groups=mid, **kw)
        self.se = _SqueezeExcite(mid, max(1, cin // 4), **kw)
        if expand == 1:
            self.conv_pw = nn.Conv2d(mid, cout, 1, **kw)
        else:
            self.conv_pwl = nn.Conv2d(mid, cout, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.expand == 1 else F.silu(self.conv_pw(x))
        h = self.se(F.silu(_same(h, self.conv_dw)))
        h = self.conv_pw(h) if self.expand == 1 else self.conv_pwl(h)
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    """tf_efficientnet_b5_ap (BNs folded): the five taps (stage 0 at 1/2,
    stage 1 at 1/4, stage 2 at 1/8, stage 4 at 1/16, ``conv_head`` at 1/32)."""

    def __init__(self, stem: int, stages: Sequence[Tuple[int, int, int, int, int]], head: int,
                 **kw):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, stem, 3, stride=2, **kw)
        blocks, cin = [], stem
        for repeats, k, stride, expand, cout in stages:
            stage = []
            for b in range(repeats):
                stage.append(_MBConv(cin, cout, k, stride if b == 0 else 1, expand, **kw))
                cin = cout
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*blocks)
        self.conv_head = nn.Conv2d(cin, head, 1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.silu(_same(x, self.conv_stem))
        taps = []
        for s, stage in enumerate(self.blocks):
            x = stage(x)
            if s in _TAPS:
                taps.append(x)
        return taps + [self.conv_head(x)]


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """(b, 4, h, w): the normal triplet L2-normalised (+1e-10), kappa ->
    elu(kappa) + 1.01."""
    n, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt((n * n).sum(dim=1, keepdim=True)) + 1e-10
    return torch.cat([n / norm, F.elu(kappa) + 1.01], dim=1)


class _UpSampleBN(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv_0 = nn.Conv2d(cin, cout, 3, padding=1, **kw)
        self.conv_1 = nn.Conv2d(cout, cout, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([bilinear_resize_align_corners(x, tuple(skip.shape[-2:])), skip], dim=1)
        x = F.leaky_relu(self.conv_0(x), 0.01)
        return F.leaky_relu(self.conv_1(x), 0.01)


class _PixelMLP(nn.Module):
    def __init__(self, cin: int, **kw):
        super().__init__()
        self.fc = nn.ModuleList([nn.Conv2d(c, o, 1, **kw) for c, o in
                                 ((cin, 128), (128, 128), (128, 128), (128, 4))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc in self.fc[:-1]:
            x = F.relu(fc(x))
        return self.fc[-1](x)


class NNET(nn.Module):
    """(b, 3, H, W) ImageNet-normalised RGB -> (b, 4, h, w) predictions at 1/8,
    1/4, 1/2 and 1/1 (normal xyz, kappa); H and W multiples of 32."""

    def __init__(self, stem: int = B5_STEM,
                 stages: Sequence[Tuple[int, int, int, int, int]] = B5_STAGES,
                 head: int = B5_HEAD, decoder_dims: Sequence[int] = DECODER_DIMS,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.encoder = EfficientNetEncoder(stem, stages, head, **kw)
        d = decoder_dims
        skips = [stages[i][4] for i in _TAPS]
        self.conv2 = nn.Conv2d(head, d[0], 1, **kw)
        self.up1 = _UpSampleBN(d[0] + skips[3], d[1], **kw)
        self.up2 = _UpSampleBN(d[1] + skips[2], d[2], **kw)
        self.up3 = _UpSampleBN(d[2] + skips[1], d[3], **kw)
        self.up4 = _UpSampleBN(d[3] + skips[0], d[4], **kw)
        self.out_conv_res8 = nn.Conv2d(d[2], 4, 3, padding=1, **kw)
        self.out_conv_res4 = _PixelMLP(d[2] + 4, **kw)
        self.out_conv_res2 = _PixelMLP(d[3] + 4, **kw)
        self.out_conv_res1 = _PixelMLP(d[4] + 4, **kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b0, b1, b2, b4, bh = self.encoder(x)
        x_d2 = self.up2(self.up1(self.conv2(bh), b4), b2)
        x_d3 = self.up3(x_d2, b1)
        x_d4 = self.up4(x_d3, b0)
        outs = [norm_normalize(self.out_conv_res8(x_d2))]
        for mlp, feat in ((self.out_conv_res4, x_d2), (self.out_conv_res2, x_d3),
                          (self.out_conv_res1, x_d4)):
            hw = (feat.shape[-2] * 2, feat.shape[-1] * 2)
            h = torch.cat([bilinear_resize_align_corners(feat, hw),
                           bilinear_resize_align_corners(outs[-1], hw)], dim=1)
            outs.append(norm_normalize(mlp(h)))
        return outs


# ------------------------------------------------------------------- loading
# released entries NNET does not read: the EfficientNet's final BN (the decoder
# taps conv_head before it), its classifier, and every BN's batch counter
_DEAD = ("encoder.original_model.bn2.", "encoder.original_model.classifier.")


def _fold(sd: Dict[str, torch.Tensor], conv: str, bn: str, eps: float, used: set
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``{conv}.weight`` (and its bias, if any) with BN ``bn`` folded in."""
    names = [f"{conv}.weight", f"{conv}.bias"] + [f"{bn}.{k}" for k in (
        "weight", "bias", "running_mean", "running_var")]
    used.update(n for n in names if n in sd)
    w, b = sd[f"{conv}.weight"], sd.get(f"{conv}.bias")
    scale = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
    bias = (b if b is not None else 0.0) * scale + (sd[f"{bn}.bias"]
                                                    - sd[f"{bn}.running_mean"] * scale)
    return w * scale.reshape(-1, *([1] * (w.ndim - 1))), bias


def nnet_state_dict(checkpoint: Mapping, stages: Sequence[Tuple[int, int, int, int, int]]
                    = B5_STAGES) -> Dict[str, torch.Tensor]:
    """``scannet.pt`` (``{"model": state dict}`` or the state dict, ``module.``
    prefixes) -> ``NNET``'s state dict, BNs folded. Every entry is read or is
    one of ``_DEAD`` or a ``num_batches_tracked``; anything else raises
    ``KeyError``."""
    sd = checkpoint.get("model", checkpoint)
    sd = {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}
    sd = {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in sd.items()}
    used = {k for k in sd if k.endswith("num_batches_tracked") or k.startswith(_DEAD)}
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, w: torch.Tensor, b: torch.Tensor) -> None:
        out[f"{name}.weight"], out[f"{name}.bias"] = w, b

    enc = "encoder.original_model"
    put("encoder.conv_stem", *_fold(sd, f"{enc}.conv_stem", f"{enc}.bn1", 1e-3, used))
    for s, (repeats, _k, _s, expand, _o) in enumerate(stages):
        for j in range(repeats):
            src, dst = f"{enc}.blocks.{s}.{j}", f"encoder.blocks.{s}.{j}"
            convs = (("conv_dw", "bn1"), ("conv_pw", "bn2")) if expand == 1 else (
                ("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
            for conv, bn in convs:
                put(f"{dst}.{conv}", *_fold(sd, f"{src}.{conv}", f"{src}.{bn}", 1e-3, used))
            for se in ("conv_reduce", "conv_expand"):
                for leaf in ("weight", "bias"):
                    out[f"{dst}.se.{se}.{leaf}"] = sd[f"{src}.se.{se}.{leaf}"]
                    used.add(f"{src}.se.{se}.{leaf}")
    out["encoder.conv_head.weight"] = sd[f"{enc}.conv_head.weight"]
    used.add(f"{enc}.conv_head.weight")
    for name in ("conv2", "out_conv_res8"):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = sd[f"decoder.{name}.{leaf}"]
            used.add(f"decoder.{name}.{leaf}")
    for up in ("up1", "up2", "up3", "up4"):
        for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
            put(f"{up}.conv_{i}", *_fold(sd, f"decoder.{up}._net.{ci}",
                                         f"decoder.{up}._net.{bi}", 1e-5, used))
    for scale in ("res4", "res2", "res1"):
        for i, ci in enumerate((0, 2, 4, 6)):
            src = f"decoder.out_conv_{scale}.{ci}"
            out[f"out_conv_{scale}.fc.{i}.weight"] = sd[f"{src}.weight"][..., None]  # Conv1d
            out[f"out_conv_{scale}.fc.{i}.bias"] = sd[f"{src}.bias"]
            used.update((f"{src}.weight", f"{src}.bias"))
    unknown = sorted(set(sd) - used)
    if unknown:
        raise KeyError(f"unexpected NNET checkpoint entries: {unknown[:8]}")
    return out


class NormalBaeDetector:
    """controlnet_aux ``NormalBaeDetector`` semantics on a ``scannet.pt``, fp32
    on ``device``: uint8 RGB frames edge-padded to a multiple of 32, ImageNet
    normalised, the finest prediction cropped, its normal ``(n + 1) / 2``
    clipped to [0, 1] as uint8 (truncated) RGB.

    The checkpoint is read with ``weights_only=True``: a ``{"model": state
    dict}`` of tensors needs no other unpickling (the JAX class allows any)."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu"),
                 stem: int = B5_STEM, stages=B5_STAGES, head: int = B5_HEAD,
                 decoder_dims: Sequence[int] = DECODER_DIMS):
        self.device = torch.device(device)
        ckpt = torch.load(model_path, map_location="cpu", weights_only=True)
        self.model = NNET(stem, stages, head, decoder_dims, device=self.device
                          ).eval().requires_grad_(False)
        self.model.load_state_dict(nnet_state_dict(ckpt, stages), strict=True)
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device).reshape(3, 1, 1)
        self.std = torch.tensor(IMAGENET_STD, device=self.device).reshape(3, 1, 1)

    def __call__(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        return as_batches(self.batch, images)

    @torch.no_grad()
    def batch(self, images: np.ndarray) -> List[np.ndarray]:
        """(n, h, w, 3) uint8 frames of one shape -> their maps."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        n, h, w = x.shape[:3]
        x = edge_pad(x.permute(0, 3, 1, 2), (-h) % 32, (-w) % 32)
        x = (x.to(torch.float32) / 255.0 - self.mean) / self.std
        normal = self.model(x)[-1][:, :3, :h, :w]
        rgb = ((normal + 1.0) * 0.5).clamp(0, 1)
        return list((rgb * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy())
