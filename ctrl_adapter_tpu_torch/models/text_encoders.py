"""Prompt and image encoders read from local diffusers folders.

Counterpart of ``ctrl_adapter_tpu/models/text_encoders.py``:

- the SD-v1.5 CLIP-L text tower shared by every ControlNet
  (``ControlNetTextEncoder``: the (2n, 77, 768) [negative; positive] prompt
  embedding);
- the backbone text towers (``CLIPTextEncoder``: OpenCLIP-H with ``clip_skip``
  for I2VGen-XL, CLIP-L and OpenCLIP-bigG for SDXL through
  ``encode_with_pooled``);
- the OpenCLIP-H vision tower (``CLIPImageEncoder``: projected image
  embeddings (n, 1, dim) for I2VGen-XL and SVD).

The towers are ``models/clip.py`` in float32 on ``device``, their weights read
by ``convert/release.py``; the tokenizer is ``models/tokenizer.py``. The image
preprocessing is SVD's antialiased resize (``ops/resize.py``) or a stand-in for
transformers' ``CLIPImageProcessor`` (shortest edge to 224 with antialiased
bicubic, rounded to uint8, centre crop, rescale, normalise), which resizes
through PIL: expect one uint8 step of difference before the normalisation.
Mean and std come from ``feature_extractor/preprocessor_config.json``.
Outputs are float32 tensors on ``device``: the CUDA card unless the caller
names another (no card and no name raises).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.release import read_weights
from ..ops.backend import resolve_device
from ..ops.resize import antialiased_resize
from .clip import CLIPTextConfig, CLIPTextModel, CLIPVisionConfig, CLIPVisionModel
from .tokenizer import CLIPTokenizer


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _load_tower(module: torch.nn.Module, root: str) -> torch.nn.Module:
    """Load the weights of the transformers folder ``root`` into ``module``
    (strict; the ``position_ids`` buffers older checkpoints store are dropped)."""
    state = {k: v for k, v in read_weights(root).items() if not k.endswith("position_ids")}
    module.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return module.eval().requires_grad_(False)


def _text_config(cfg: dict, with_projection: bool) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        # kept verbatim: 2 (transformers' default) selects the legacy pooling rule
        eos_token_id=cfg.get("eos_token_id", 2) or 2,
        projection_dim=cfg.get("projection_dim") if with_projection else None,
    )


def _vision_config(cfg: dict) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        projection_dim=cfg.get("projection_dim", 1024),
    )


class NativeTextTower:
    """Tokenizer + CLIP text tower from a local diffusers folder."""

    def __init__(self, model_path: str, subfolder: str = "text_encoder",
                 tokenizer_subfolder: str = "tokenizer", with_projection: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.tokenizer = CLIPTokenizer.from_pretrained(
            os.path.join(model_path, tokenizer_subfolder))
        root = os.path.join(model_path, subfolder)
        cfg = _text_config(_read_json(os.path.join(root, "config.json")), with_projection)
        self.model = _load_tower(CLIPTextModel(cfg, device=self.device), root)

    @torch.no_grad()
    def encode(self, texts: List[str], clip_skip: int = 0):
        """-> (last_hidden_state, pooled, hidden_states); with ``clip_skip`` > 0 the
        first is the final layer norm of the ``clip_skip``-th layer from the end."""
        return self.model(self.tokenizer(texts).to(self.device), clip_skip=clip_skip)


def build_controlnet_text_encoder(
    pretrained_model_path: Optional[str],
    controlnet_text_encoder_path: Optional[str] = None,
    model_name: Optional[str] = None, device=None,
) -> "ControlNetTextEncoder":
    """The SD-v1.5 CLIP-L folder for the ControlNet prompt tower. The backbone
    folder stands in only for SDXL (its text_encoder is CLIP-L 768 too);
    I2VGen-XL's is OpenCLIP-H (1024) and SVD has none, so those need the path."""
    path = controlnet_text_encoder_path
    if path is None:
        if model_name in ("i2vgenxl", "svd"):
            raise ValueError(
                f"--controlnet_text_encoder_path is required for model_name="
                f"{model_name}: the SD-v1.5 ControlNets need a CLIP-L (768-d) "
                f"prompt tower, but the {model_name} backbone dir carries "
                "OpenCLIP-H (i2vgenxl) or no text encoder (svd). Point it at a "
                "local SD-v1.5 diffusers dir (tokenizer/ + text_encoder/)."
            )
        path = pretrained_model_path
    if path is None:
        raise ValueError("no SD-v1.5 path for the ControlNet text encoder")
    return ControlNetTextEncoder(path, device=device)


class ControlNetTextEncoder:
    """SD-v1.5 CLIP-L: the (2n, 77, 768) [negative; positive] ControlNet prompt
    embedding."""

    def __init__(self, model_path: str, device=None):
        self.tower = NativeTextTower(model_path, device=device)

    def __call__(self, prompts: List[str],
                 negative_prompts: Optional[List[str]] = None) -> torch.Tensor:
        pos = self.tower.encode(prompts)[0]
        if negative_prompts is None:
            negative_prompts = [""] * len(prompts)
        neg = self.tower.encode(negative_prompts)[0]
        return torch.cat([neg, pos])


class CLIPTextEncoder:
    """Backbone text encoder (I2VGen-XL OpenCLIP-H with clip_skip; SDXL's two)."""

    def __init__(self, model_path: str, subfolder: str = "text_encoder",
                 clip_skip: int = 0, with_projection: bool = False, device=None):
        self.tower = NativeTextTower(model_path, subfolder, with_projection=with_projection,
                                     device=device)
        self.clip_skip = clip_skip

    def __call__(self, prompts: List[str]) -> torch.Tensor:
        return self.tower.encode(prompts, clip_skip=self.clip_skip)[0]

    def encode_with_pooled(self, prompts: List[str]):
        """SDXL's dual-encoder path: (penultimate hidden state, pooled/projected)."""
        _last, pooled, hiddens = self.tower.encode(prompts)
        return hiddens[-2], pooled


class CLIPImageEncoder:
    """CLIP-H vision tower -> projected image embeddings (n, 1, dim)."""

    def __init__(self, model_path: str, subfolder: str = "image_encoder", device=None):
        self.device = resolve_device(device)
        self.processor = _read_json(
            os.path.join(model_path, "feature_extractor", "preprocessor_config.json"))
        root = os.path.join(model_path, subfolder)
        cfg = _vision_config(_read_json(os.path.join(root, "config.json")))
        self.model = _load_tower(CLIPVisionModel(cfg, device=self.device), root)
        self.mean = torch.tensor(self.processor["image_mean"], dtype=torch.float32)[:, None, None]
        self.std = torch.tensor(self.processor["image_std"], dtype=torch.float32)[:, None, None]

    def _process(self, images: List[np.ndarray]) -> torch.Tensor:
        """``CLIPImageProcessor`` on uint8 (h, w, 3) images -> (n, 3, c, c)."""
        p = self.processor
        size = p.get("size", 224)
        short = size["shortest_edge"] if isinstance(size, dict) else size
        crop = p.get("crop_size", short)
        ch, cw = (crop["height"], crop["width"]) if isinstance(crop, dict) else (crop, crop)
        out = []
        for im in images:
            x = torch.from_numpy(np.ascontiguousarray(im[..., :3])).permute(2, 0, 1).float()
            h, w = x.shape[-2:]
            if p.get("do_resize", True):
                # the short side to ``short``, the long one scaled and floored
                if h <= w:
                    oh, ow = short, int(short * w / h)
                else:
                    oh, ow = int(short * h / w), short
                x = F.interpolate(x[None], size=(oh, ow), mode="bicubic", antialias=True,
                                  align_corners=False)[0]
                x = x.round().clamp(0, 255)
                h, w = oh, ow
            if p.get("do_center_crop", True):
                top, left = (h - ch) // 2, (w - cw) // 2
                x = x[:, top: top + ch, left: left + cw]
            if p.get("do_rescale", True):
                x = x * p.get("rescale_factor", 1 / 255)
            if p.get("do_normalize", True):
                x = (x - self.mean) / self.std
            out.append(x)
        return torch.stack(out)

    @torch.no_grad()
    def __call__(self, images: List[np.ndarray], antialiased: bool = False) -> torch.Tensor:
        """``antialiased=True`` is the SVD pipeline's preprocessing: the image in
        [-1, 1], gaussian-prefiltered bicubic to 224, then back to [0, 1] and
        normalised; otherwise ``CLIPImageProcessor``'s path (I2VGen-XL)."""
        if antialiased:
            arr = torch.from_numpy(np.stack([np.asarray(im, np.float32) for im in images]))
            if arr.max() > 1.5:  # uint8-range input -> [-1, 1]
                arr = arr / 127.5 - 1.0
            small = antialiased_resize(arr.permute(0, 3, 1, 2), (224, 224))
            pix = ((small + 1.0) / 2.0 - self.mean) / self.std
        else:
            pix = self._process(images)
        _, embeds = self.model(pix.to(self.device))
        return embeds[:, None, :]
