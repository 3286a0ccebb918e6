"""LoRA folded into a port state dict by diffusers names.

Counterpart of ``ctrl_adapter_tpu/convert/lora.py`` (the reference's
``pipe.load_lora_weights(path)`` before generation): each delta
``scale * (alpha / r) * up @ down`` is added once to the weight it targets,
so the forward is unchanged. Layouts:

- kohya/civitai: ``lora_unet_<module with _>.lora_down.weight`` /
  ``.lora_up.weight`` / ``.alpha`` (``lora_te1_`` / ``lora_te2_`` for SDXL's two
  text encoders);
- peft/diffusers: ``unet.<module>.lora_A.weight`` / ``.lora_B.weight``.

A module is named as the JAX package names it: the diffusers name with every
``.`` turned into ``_`` (``down_blocks.0.attentions.0.proj_in`` ->
``down_blocks_0_attentions_0_proj_in``); the targets are the weights of rank
2 or more (linear and conv weights, the JAX trees' kernels).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .release import read_safetensors

_COMPONENT_PREFIXES = {
    "unet": ("lora_unet_", "unet."),
    "te1": ("lora_te1_", "text_encoder."),
    "te2": ("lora_te2_", "text_encoder_2."),
}
_SUFFIXES = {
    "kohya": ((".lora_down.weight", "down"), (".lora_up.weight", "up"), (".alpha", "alpha")),
    "peft": ((".lora_A.weight", "down"), (".lora_B.weight", "up"), (".alpha", "alpha")),
}


def _group_lora_modules(lora_sd: Mapping[str, torch.Tensor], component: str
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module name with _ -> {down, up, alpha}} of one component's LoRA keys."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for layout, prefix in zip(("kohya", "peft"), _COMPONENT_PREFIXES[component]):
        for key, v in lora_sd.items():
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            for suffix, leaf in _SUFFIXES[layout]:
                if rest.endswith(suffix):
                    groups.setdefault(rest[: -len(suffix)].replace(".", "_"), {})[leaf] = v
                    break
    return groups


def _full_rank_delta(g: Dict[str, torch.Tensor]) -> torch.Tensor:
    """up @ down in the layout of the target weight, scaled by alpha / r."""
    down, up = g["down"].float(), g["up"].float()
    rank = down.shape[0]
    alpha = float(g["alpha"]) if "alpha" in g else float(rank)
    if down.dim() == 2:  # linear: (r, in), (out, r) -> (out, in)
        delta = up @ down
    else:  # conv: up (out, r, 1, 1), down (r, in, kh, kw)
        o, r = up.shape[:2]
        delta = (up.reshape(o, r) @ down.reshape(r, -1)).reshape((o,) + tuple(down.shape[1:]))
    return delta * (alpha / rank)


def apply_lora(state_dict: Dict[str, torch.Tensor], lora_sd: Mapping[str, torch.Tensor],
               scale: float = 1.0, component: str = "unet") -> int:
    """Fold LoRA deltas into ``state_dict`` in place (its tensors are replaced,
    in their dtypes); returns the number of modules merged. A LoRA that names a
    module the state dict lacks, or lacks a factor, raises."""
    groups = _group_lora_modules(lora_sd, component)
    targets = {name[: -len(".weight")].replace(".", "_"): name
               for name, t in state_dict.items() if name.endswith(".weight") and t.dim() >= 2}
    for mod, g in groups.items():
        if "down" not in g or "up" not in g:
            raise KeyError(f"LoRA module {mod} missing down/up factors")
        if mod not in targets:
            raise KeyError(f"LoRA targets unknown module: {mod}")
        name = targets[mod]
        weight = state_dict[name]
        delta = _full_rank_delta(g)
        if tuple(delta.shape) != tuple(weight.shape):
            raise ValueError(f"LoRA delta shape {tuple(delta.shape)} != weight "
                             f"{tuple(weight.shape)} at {mod}")
        state_dict[name] = (weight.float() + scale * delta.to(weight.device)).to(weight.dtype)
    return len(groups)


def load_lora_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a LoRA checkpoint (.safetensors, or a torch .pt/.pth/.bin)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)
