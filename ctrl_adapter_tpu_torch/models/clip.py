"""CLIP text and vision towers with the transformers parameter names.

Counterpart of ``ctrl_adapter_tpu/models/clip.py``: the SD-v1.5 CLIP-L text
tower (ControlNet prompts), the backbone text towers (CLIP-L and OpenCLIP-bigG
for SDXL, OpenCLIP-H for I2VGen-XL) and the OpenCLIP-H vision tower with its
projection (I2VGen-XL and SVD image embeddings). ``state_dict()`` keys are
those of transformers' ``CLIPTextModel(WithProjection)`` and
``CLIPVisionModelWithProjection`` (``text_model.encoder.layers.0.self_attn.q_proj.weight``,
``visual_projection.weight``, ...), so released ``text_encoder/`` and
``image_encoder/`` folders load by name. The towers run in float32 with plain
PyTorch attention (fp32 logits and softmax), as the JAX towers run XLA's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (OpenAI CLIP) | "gelu" (OpenCLIP)
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for the *WithProjection towers


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: Optional[int] = 1024


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: F.gelu(x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size, **kw)
        self.k_proj = nn.Linear(hidden_size, hidden_size, **kw)
        self.v_proj = nn.Linear(hidden_size, hidden_size, **kw)
        self.out_proj = nn.Linear(hidden_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.num_heads

        def heads(proj):
            return proj(x).reshape(b, t, self.num_heads, hd).transpose(1, 2).float()

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        logits = (q @ k.transpose(-1, -2)) * hd ** -0.5
        if causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
            logits = logits.masked_fill(mask, float("-inf"))
        out = (torch.softmax(logits, dim=-1) @ v).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, hidden_act: str,
                 device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, intermediate_size, device=device, dtype=dtype)
        self.fc2 = nn.Linear(intermediate_size, hidden_size, device=device, dtype=dtype)
        self.act = _act(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 hidden_act: str, layer_norm_eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = CLIPAttention(hidden_size, num_heads, **kw)
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps, **kw)
        self.mlp = CLIPMLP(hidden_size, intermediate_size, hidden_act, **kw)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                             cfg.hidden_act, cfg.layer_norm_eps, device=device, dtype=dtype)
            for _ in range(cfg.num_layers)])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                               **kw)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embeddings = CLIPTextEmbeddings(cfg, **kw)
        self.encoder = CLIPEncoder(cfg, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)


class CLIPTextModel(nn.Module):
    """Text tower. ``forward(input_ids, clip_skip)`` returns (last_hidden_state,
    pooled, hidden_states): ``hidden_states[0]`` is the embedding output, then
    one per layer, so ``hidden_states[-2]`` is the penultimate layer. Pooling
    takes the first ``eos_token_id`` position; a config with
    ``eos_token_id == 2`` (the official CLIP-L, SD-v1.5 and SDXL configs) takes
    transformers' legacy rule, the position of the largest token id. With
    ``clip_skip`` > 0 the first output is the final layer norm applied to the
    ``clip_skip``-th layer from the end."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(), device=None, dtype=None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, device=device, dtype=dtype)
        self.text_projection = (
            nn.Linear(config.hidden_size, config.projection_dim, bias=False, device=device,
                      dtype=dtype)
            if config.projection_dim is not None else None)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        tm = self.text_model
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)[None]
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal=True)
            hidden_states.append(x)
        x = tm.final_layer_norm(x)
        if self.config.eos_token_id == 2:
            eos_pos = input_ids.argmax(dim=-1)
        else:
            eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        if clip_skip:
            x = tm.final_layer_norm(hidden_states[-(clip_skip + 1)])
        return x, pooled, tuple(hidden_states)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size, **kw))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False, **kw)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1,
                                               cfg.hidden_size, **kw)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embeddings = CLIPVisionEmbeddings(cfg, **kw)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.encoder = CLIPEncoder(cfg, **kw)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)


class CLIPVisionModel(nn.Module):
    """Vision tower (+ projection). ``forward(pixel_values)`` takes (b, 3, H, W)
    CLIP-normalised pixels and returns (last_hidden_state, image_embeds)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(), device=None, dtype=None):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config, device=device, dtype=dtype)
        self.visual_projection = (
            nn.Linear(config.hidden_size, config.projection_dim, bias=False, device=device,
                      dtype=dtype)
            if config.projection_dim is not None else None)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixel_values.to(emb.patch_embedding.weight.dtype))
        patches = patches.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding(torch.arange(x.shape[1], device=x.device))[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, causal=False)
        pooled = vm.post_layernorm(x[:, 0])
        if self.visual_projection is not None:
            pooled = self.visual_projection(pooled)
        return x, pooled
