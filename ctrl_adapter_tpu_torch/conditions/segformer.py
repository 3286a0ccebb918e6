"""SegFormer semantic segmentation (``nvidia/segformer-b5-finetuned-ade-640-640``), NCHW.

Counterpart of ``ctrl_adapter_tpu/conditions/segformer.py`` (transformers'
``SegformerForSemanticSegmentation``): a 4-stage Mix Transformer encoder
(overlapping patch-embed convs, pre-LN blocks of spatial-reduction attention,
plain fp32 as ``jax.nn.dot_product_attention`` computes it there, and Mix-FFN:
dense, 3x3 depthwise conv, exact gelu, dense; a LayerNorm closing each stage)
and the all-MLP decode head (per-stage linear to ``decoder_hidden_size``,
``bilinear_resize`` to the first stage's size, concatenated deepest first, 1x1
fuse conv, eval BatchNorm, relu, 1x1 classifier) -> (b, num_labels, H/4, W/4)
logits. Parameters and buffers carry transformers' state-dict names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize
from .dpt import attention


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    num_labels: int = 150
    hidden_sizes: Tuple[int, ...] = (64, 128, 320, 512)  # b5
    depths: Tuple[int, ...] = (3, 6, 40, 3)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    decoder_hidden_size: int = 768
    layer_norm_eps: float = 1e-6
    batch_norm_eps: float = 1e-5


SEGFORMER_B5_ADE_CONFIG = SegformerConfig()

# SegformerImageProcessor's defaults, under a checkpoint's preprocessor_config.json
PROCESSOR_DEFAULTS = {"size": {"height": 512, "width": 512}, "resample": 2,
                      "image_mean": [0.485, 0.456, 0.406], "image_std": [0.229, 0.224, 0.225]}


def config_from_json(cfg: dict) -> SegformerConfig:
    """A transformers ``config.json`` -> ``SegformerConfig`` (the keys the JAX
    ``SegmentationSegformer`` reads)."""
    return SegformerConfig(
        num_labels=len(cfg.get("id2label", {})) or cfg.get("num_labels", 150),
        hidden_sizes=tuple(cfg["hidden_sizes"]), depths=tuple(cfg["depths"]),
        num_heads=tuple(cfg["num_attention_heads"]), sr_ratios=tuple(cfg["sr_ratios"]),
        patch_sizes=tuple(cfg["patch_sizes"]), strides=tuple(cfg["strides"]),
        mlp_ratios=tuple(cfg["mlp_ratios"]), decoder_hidden_size=cfg["decoder_hidden_size"],
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-6))


class _PatchEmbed(nn.Module):
    def __init__(self, c_in: int, c_out: int, patch: int, stride: int, eps: float, **kw):
        super().__init__()
        self.proj = nn.Conv2d(c_in, c_out, patch, stride, patch // 2, **kw)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps, **kw)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int, sr: int, eps: float, **kw):
        super().__init__()
        self.query = nn.Linear(hidden, hidden, **kw)
        self.key = nn.Linear(hidden, hidden, **kw)
        self.value = nn.Linear(hidden, hidden, **kw)
        if sr > 1:
            self.sr = nn.Conv2d(hidden, hidden, sr, sr, **kw)
            self.layer_norm = nn.LayerNorm(hidden, eps=eps, **kw)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, **kw):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out, **kw)


class _Attention(nn.Module):
    def __init__(self, hidden: int, sr: int, eps: float, **kw):
        super().__init__()
        self.self = _SelfAttention(hidden, sr, eps, **kw)
        self.output = _Dense(hidden, hidden, **kw)


class _DWConv(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.dwconv = nn.Conv2d(channels, channels, 3, padding=1, groups=channels, **kw)


class _MixFFN(nn.Module):
    def __init__(self, hidden: int, inner: int, **kw):
        super().__init__()
        self.dense1 = nn.Linear(hidden, inner, **kw)
        self.dwconv = _DWConv(inner, **kw)
        self.dense2 = nn.Linear(inner, hidden, **kw)


class _Block(nn.Module):
    """Pre-LN spatial-reduction attention + pre-LN Mix-FFN, both residual."""

    def __init__(self, hidden: int, heads: int, sr: int, mlp_ratio: int, eps: float, **kw):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.layer_norm_1 = nn.LayerNorm(hidden, eps=eps, **kw)
        self.attention = _Attention(hidden, sr, eps, **kw)
        self.layer_norm_2 = nn.LayerNorm(hidden, eps=eps, **kw)
        self.mlp = _MixFFN(hidden, hidden * mlp_ratio, **kw)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, t, c = x.shape
        heads = self.heads
        sa = self.attention.self
        a = self.layer_norm_1(x)
        kv = a
        if self.sr_ratio > 1:
            fmap = sa.sr(a.transpose(1, 2).reshape(b, c, h, w))
            kv = sa.layer_norm(fmap.flatten(2).transpose(1, 2))
        q = sa.query(a).reshape(b, t, heads, -1).transpose(1, 2)
        k, v = (lin(kv).reshape(b, kv.shape[1], heads, -1).transpose(1, 2)
                for lin in (sa.key, sa.value))
        att = attention(q, k, v).to(x.dtype).transpose(1, 2).reshape(b, t, c)
        x = x + self.attention.output.dense(att)
        m = self.mlp.dense1(self.layer_norm_2(x))
        m = self.mlp.dwconv.dwconv(m.transpose(1, 2).reshape(b, -1, h, w))
        return x + self.mlp.dense2(F.gelu(m.flatten(2).transpose(1, 2)))


class _Encoder(nn.Module):
    def __init__(self, cfg: SegformerConfig, **kw):
        super().__init__()
        chans = (3,) + tuple(cfg.hidden_sizes)
        eps = cfg.layer_norm_eps
        self.patch_embeddings = nn.ModuleList(
            _PatchEmbed(chans[s], chans[s + 1], cfg.patch_sizes[s], cfg.strides[s], eps, **kw)
            for s in range(len(cfg.hidden_sizes)))
        self.block = nn.ModuleList(
            nn.ModuleList(_Block(c, cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratios[s], eps,
                                 **kw) for _ in range(cfg.depths[s]))
            for s, c in enumerate(cfg.hidden_sizes))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=eps, **kw)
                                        for c in cfg.hidden_sizes)


class _Segformer(nn.Module):
    def __init__(self, cfg: SegformerConfig, **kw):
        super().__init__()
        self.encoder = _Encoder(cfg, **kw)


class _MLP(nn.Module):
    def __init__(self, n_in: int, n_out: int, **kw):
        super().__init__()
        self.proj = nn.Linear(n_in, n_out, **kw)


class _DecodeHead(nn.Module):
    def __init__(self, cfg: SegformerConfig, **kw):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList(_MLP(c, d, **kw) for c in cfg.hidden_sizes)
        self.linear_fuse = nn.Conv2d(d * len(cfg.hidden_sizes), d, 1, bias=False, **kw)
        self.batch_norm = nn.BatchNorm2d(d, eps=cfg.batch_norm_eps, **kw)
        self.classifier = nn.Conv2d(d, cfg.num_labels, 1, **kw)


class SegformerForSemanticSegmentation(nn.Module):
    """(b, 3, H, W) normalised pixels -> (b, num_labels, H/4, W/4) logits. The
    BatchNorm runs on its running statistics whatever the module's mode."""

    def __init__(self, config: SegformerConfig = SEGFORMER_B5_ADE_CONFIG, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.segformer = _Segformer(config, **kw)
        self.decode_head = _DecodeHead(config, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        enc = self.segformer.encoder
        b = pixel_values.shape[0]
        x = pixel_values
        features = []
        for s, embed in enumerate(enc.patch_embeddings):
            x = embed.proj(x)
            h, w = x.shape[-2:]
            x = embed.layer_norm(x.flatten(2).transpose(1, 2))
            for block in enc.block[s]:
                x = block(x, h, w)
            x = enc.layer_norm[s](x).transpose(1, 2).reshape(b, -1, h, w)
            features.append(x)

        head = self.decode_head
        size = tuple(features[0].shape[-2:])
        unified = []
        for s, feat in enumerate(features):
            u = head.linear_c[s].proj(feat.flatten(2).transpose(1, 2))
            u = u.transpose(1, 2).reshape(b, -1, *feat.shape[-2:])
            unified.append(u if tuple(u.shape[-2:]) == size else bilinear_resize(u, size))
        fused = head.linear_fuse(torch.cat(unified[::-1], dim=1))
        bn = head.batch_norm
        fused = F.batch_norm(fused, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps)
        return head.classifier(F.relu(fused))
