"""Several frozen ControlNet experts that return their residuals one list each.

Counterpart of ``ctrl_adapter_tpu/models/multicontrolnet.py:MultiControlNetModel``
(the reference's fork that keeps the experts' residuals apart, so that the
router can weigh them). The experts are held as ``nets`` (an ``nn.ModuleList``
of ``ControlNetModel``, the diffusers name); a masked expert is never run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from .controlnet import ControlNetModel


class MultiControlNetModel(nn.Module):
    def __init__(self, controlnets: Sequence[ControlNetModel]):
        super().__init__()
        self.nets = nn.ModuleList(controlnets)

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
