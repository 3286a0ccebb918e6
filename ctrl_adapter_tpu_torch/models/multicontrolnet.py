"""Several frozen ControlNet experts that return their residuals one list each.

Counterpart of ``ctrl_adapter_tpu/models/multicontrolnet.py:MultiControlNetModel``
(the reference's fork that keeps the experts' residuals apart, so that the
router can weigh them). The experts are held as ``nets`` (an ``nn.ModuleList``
of ``ControlNetModel``, the diffusers name); a masked expert is never run.
On disk the experts are release folders ``controlnet``, ``controlnet_1``, ...
under one root (``from_pretrained`` / ``save_pretrained``, the reference's
``multicontrolnet.py`` layout).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..convert.release import load_release, save_release
from .controlnet import ControlNetConfig, ControlNetModel


def _subfolder(idx: int) -> str:
    return "controlnet" if idx == 0 else f"controlnet_{idx}"


class MultiControlNetModel(nn.Module):
    def __init__(self, controlnets: Sequence[ControlNetModel]):
        super().__init__()
        self.nets = nn.ModuleList(controlnets)

    @classmethod
    def from_pretrained(cls, root: str, config: ControlNetConfig = ControlNetConfig(),
                        device=None, dtype=None) -> "MultiControlNetModel":
        """Load every ``controlnet``, ``controlnet_1``, ... folder under ``root``
        into a ControlNet of ``config`` (strict, by diffusers names)."""
        nets = []
        while os.path.isdir(os.path.join(root, _subfolder(len(nets)))):
            net = ControlNetModel(config, device=device, dtype=dtype)
            load_release(net, os.path.join(root, _subfolder(len(nets))))
            nets.append(net.eval())
        if not nets:
            raise FileNotFoundError(f"no controlnet subdirs under {root}")
        return cls(nets)

    def save_pretrained(self, root: str) -> List[str]:
        """Write each expert as a release folder under ``root``; returns the
        folders in expert order."""
        paths = [os.path.join(root, _subfolder(idx)) for idx in range(self.num_experts)]
        for net, path in zip(self.nets, paths):
            save_release(net.state_dict(), path, config=dataclasses.asdict(net.config))
        return paths

    @property
    def num_experts(self) -> int:
        return len(self.nets)

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                controlnet_cond: Union[torch.Tensor, Sequence[torch.Tensor]],
                conditioning_scale: Union[float, Sequence[float]] = 1.0,
                skip_conv_in: bool = False, skip_time_emb: bool = False,
                expert_mask: Optional[Sequence[bool]] = None, guess_mode: bool = False
                ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
        """``controlnet_cond`` holds one (n, 3, H, W) condition per expert; a
        scale may be given per expert. Returns the active experts' down residual
        lists and mid residuals, in expert order."""
        n = len(controlnet_cond)
        if n > self.num_experts:
            raise ValueError(f"{n} conditions for {self.num_experts} experts")
        scales = (list(conditioning_scale) if isinstance(conditioning_scale, (list, tuple))
                  else [conditioning_scale] * n)
        mask = list(expert_mask) if expert_mask is not None else [True] * n
        per_down, per_mid = [], []
        for e in range(n):
            if not mask[e]:
                continue
            downs, mid = self.nets[e](sample, timestep, encoder_hidden_states,
                                      controlnet_cond[e], conditioning_scale=scales[e],
                                      skip_conv_in=skip_conv_in, guess_mode=guess_mode,
                                      skip_time_emb=skip_time_emb)
            per_down.append(downs)
            per_mid.append(mid)
        return per_down, per_mid
