"""DPT monocular depth estimation (``Intel/dpt-large``), NCHW.

Counterpart of ``ctrl_adapter_tpu/conditions/dpt.py`` (transformers'
``DPTForDepthEstimation``, non-hybrid, readout "project"):

- ViT backbone: a patch conv, the CLS token, position embeddings resized to
  the input's grid by ``bilinear_resize`` (``jax.image.resize``'s rule, as the
  JAX module does), pre-LN layers whose attention is plain fp32 softmax(q k^T
  / sqrt(d)) v, as ``jax.nn.dot_product_attention`` computes it there (XLA, no
  Pallas kernel), and exact gelu;
- reassemble: the hidden states at ``backbone_out_indices``, the CLS readout
  projected, a 1x1 projection and a resize by (4, 2, 1, 0.5);
- neck: 3x3 convs to ``fusion_hidden_size`` and RefineNet fusion, deepest
  first, with x2 ``bilinear_resize_align_corners`` upsamples;
- head: conv, x2 upsample, conv, relu, 1x1 conv, relu -> (b, H/16*2*..., W')
  relative inverse depth.

The parameters carry transformers' state-dict names, so a released
``model.safetensors`` loads strictly through ``convert/release.py``; that
includes ``dpt.layernorm`` and fusion layer 0's ``residual_layer1``, which the
depth head never reads.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize, bilinear_resize_align_corners


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384
    layer_norm_eps: float = 1e-12
    backbone_out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256


DPT_LARGE_CONFIG = DPTConfig()

# DPTImageProcessor's defaults, under a checkpoint's preprocessor_config.json
PROCESSOR_DEFAULTS = {"size": 384, "resample": 3, "image_mean": [0.5, 0.5, 0.5],
                      "image_std": [0.5, 0.5, 0.5]}


def config_from_json(cfg: dict) -> DPTConfig:
    """A transformers ``config.json`` -> ``DPTConfig`` (the keys the JAX
    ``DepthDPT`` reads)."""
    return DPTConfig(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
        patch_size=cfg["patch_size"], image_size=cfg["image_size"],
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        backbone_out_indices=tuple(cfg["backbone_out_indices"]),
        neck_hidden_sizes=tuple(cfg["neck_hidden_sizes"]),
        reassemble_factors=tuple(cfg["reassemble_factors"]),
        fusion_hidden_size=cfg["fusion_hidden_size"])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (..., T, d) in float32: the plain form of
    ``jax.nn.dot_product_attention`` the extractors' networks use."""
    q, k, v = q.float(), k.float(), v.float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return torch.matmul(torch.softmax(logits, dim=-1), v)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, **kw):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out, **kw)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int, **kw):
        super().__init__()
        self.query = nn.Linear(hidden, hidden, **kw)
        self.key = nn.Linear(hidden, hidden, **kw)
        self.value = nn.Linear(hidden, hidden, **kw)


class _Attention(nn.Module):
    def __init__(self, hidden: int, **kw):
        super().__init__()
        self.attention = _SelfAttention(hidden, **kw)
        self.output = _Dense(hidden, hidden, **kw)


class _ViTLayer(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.attention = _Attention(h, **kw)
        self.intermediate = _Dense(h, cfg.intermediate_size, **kw)
        self.output = _Dense(cfg.intermediate_size, h, **kw)
        self.layernorm_before = nn.LayerNorm(h, eps=cfg.layer_norm_eps, **kw)
        self.layernorm_after = nn.LayerNorm(h, eps=cfg.layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        heads = self.cfg.num_heads
        h = self.layernorm_before(x)
        sa = self.attention.attention
        q, k, v = (lin(h).reshape(b, t, heads, c // heads).transpose(1, 2)
                   for lin in (sa.query, sa.key, sa.value))
        att = attention(q, k, v).to(x.dtype).transpose(1, 2).reshape(b, t, c)
        x = x + self.attention.output.dense(att)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, cfg.patch_size, **kw)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        grid = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size, **kw))
        self.position_embeddings = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.hidden_size,
                                                            **kw))
        self.patch_embeddings = _PatchEmbeddings(cfg, **kw)


class _Encoder(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        self.layer = nn.ModuleList(_ViTLayer(cfg, **kw) for _ in range(cfg.num_layers))


class _ViT(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        self.embeddings = _Embeddings(cfg, **kw)
        self.encoder = _Encoder(cfg, **kw)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)  # unread


class _ReassembleLayer(nn.Module):
    def __init__(self, hidden: int, channels: int, factor: float, **kw):
        super().__init__()
        self.projection = nn.Conv2d(hidden, channels, 1, **kw)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(channels, channels, int(factor), int(factor), **kw)
        elif factor < 1:
            self.resize = nn.Conv2d(channels, channels, 3, int(1 / factor), 1, **kw)
        else:
            self.resize = nn.Identity()


class _ReassembleStage(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        self.layers = nn.ModuleList(
            _ReassembleLayer(h, ch, f, **kw)
            for ch, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors))
        self.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * h, h, **kw), nn.GELU())
            for _ in cfg.neck_hidden_sizes)


class _PreActResidual(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.convolution1 = nn.Conv2d(channels, channels, 3, padding=1, **kw)
        self.convolution2 = nn.Conv2d(channels, channels, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convolution1(F.relu(x))
        return self.convolution2(F.relu(h)) + x


class _FusionLayer(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.projection = nn.Conv2d(channels, channels, 1, **kw)
        self.residual_layer1 = _PreActResidual(channels, **kw)
        self.residual_layer2 = _PreActResidual(channels, **kw)


class _FusionStage(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList(_FusionLayer(cfg.fusion_hidden_size, **kw)
                                    for _ in cfg.neck_hidden_sizes)


class _Neck(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        self.reassemble_stage = _ReassembleStage(cfg, **kw)
        self.convs = nn.ModuleList(
            nn.Conv2d(ch, cfg.fusion_hidden_size, 3, padding=1, bias=False, **kw)
            for ch in cfg.neck_hidden_sizes)
        self.fusion_stage = _FusionStage(cfg, **kw)


class _Head(nn.Module):
    def __init__(self, cfg: DPTConfig, **kw):
        super().__init__()
        f = cfg.fusion_hidden_size
        # the transformers Sequential's indices; 1 is the x2 upsample, 3 and 5 relus
        self.head = nn.Sequential(nn.Conv2d(f, f // 2, 3, padding=1, **kw), nn.Identity(),
                                  nn.Conv2d(f // 2, 32, 3, padding=1, **kw), nn.ReLU(),
                                  nn.Conv2d(32, 1, 1, **kw), nn.ReLU())


class DPTForDepthEstimation(nn.Module):
    """(b, 3, H, W) DPT-normalised pixels -> (b, H', W') relative inverse depth."""

    def __init__(self, config: DPTConfig = DPT_LARGE_CONFIG, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.dpt = _ViT(config, **kw)
        self.neck = _Neck(config, **kw)
        self.head = _Head(config, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, _, height, width = pixel_values.shape
        ph, pw = height // cfg.patch_size, width // cfg.patch_size
        emb = self.dpt.embeddings
        x = emb.patch_embeddings.projection(pixel_values).flatten(2).transpose(1, 2)
        grid = cfg.image_size // cfg.patch_size
        pos_tok, pos_grid = emb.position_embeddings[:, :1], emb.position_embeddings[0, 1:]
        if (ph, pw) != (grid, grid):
            pos_grid = bilinear_resize(pos_grid.reshape(grid, grid, -1).permute(2, 0, 1),
                                       (ph, pw)).permute(1, 2, 0)
        pos = torch.cat([pos_tok, pos_grid.reshape(1, ph * pw, -1)], dim=1)
        x = torch.cat([emb.cls_token.expand(b, -1, -1), x], dim=1) + pos

        collected = []
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in cfg.backbone_out_indices:
                collected.append(x)

        stage = self.neck.reassemble_stage
        feats = []
        for s, hs in enumerate(collected):
            tokens = hs[:, 1:]
            readout = hs[:, :1].expand_as(tokens)
            proj = stage.readout_projects[s](torch.cat([tokens, readout], dim=-1))
            fmap = proj.transpose(1, 2).reshape(b, -1, ph, pw)
            layer = stage.layers[s]
            fmap = layer.resize(layer.projection(fmap))
            feats.append(self.neck.convs[s](fmap))

        fused = None
        for s, feat in enumerate(feats[::-1]):
            fusion = self.neck.fusion_stage.layers[s]
            if fused is None:
                fused = feat
            else:
                if fused.shape[-2:] != feat.shape[-2:]:
                    feat = bilinear_resize(feat, tuple(fused.shape[-2:]))
                fused = fused + fusion.residual_layer1(feat)
            fused = fusion.residual_layer2(fused)
            fused = bilinear_resize_align_corners(fused, (fused.shape[-2] * 2,
                                                          fused.shape[-1] * 2))
            fused = fusion.projection(fused)

        head = self.head.head
        h = head[0](fused)
        h = bilinear_resize_align_corners(h, (h.shape[-2] * 2, h.shape[-1] * 2))
        h = F.relu(head[2](h))
        return F.relu(head[4](h))[:, 0]
