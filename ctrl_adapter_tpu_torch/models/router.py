"""Multi-condition router and expert fusion of ControlNet residuals.

Counterpart of ``ctrl_adapter_tpu/models/router.py``:

- :class:`ControlNetRouter` gives per-block expert weights: one gate for each
  of the ``num_routers`` down slots (``down_blocks_router.{i}.wg.weight``) and
  one for the mid block (``mid_block_router.wg.weight``), each a bias-free
  Linear. "equal_weights" has no gates (zero logits); "simple_weights" reads
  the gate's weight column (a Linear(1, E) on the constant 1); the
  conditional types ("timestep_weights", "embedding_weights",
  "timestep_embedding_weights") apply a Linear(D, E) to the router input,
  averaged over the batch first, so one weight set serves a call as in the
  reference. Masked experts lose ``MASK_NEG`` from their logits before the
  softmax. Logits and weights are float32.
- :func:`build_router_input` assembles a conditional router's input.
- :func:`fuse_expert_residuals` sums the per-expert residuals, each scaled by
  its weight (or unweighted without a router).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.embeddings import get_timestep_embedding, timestep_tensor

MASK_NEG = 1.0e6
CONDITIONAL_TYPES = ("timestep_weights", "embedding_weights", "timestep_embedding_weights")
ROUTER_TYPES = ("equal_weights", "simple_weights") + CONDITIONAL_TYPES


class _WeightGate(nn.Module):
    """One gate: a bias-free ``wg`` Linear(in_features, num_experts), in float32."""

    def __init__(self, num_experts: int, in_features: int = 1, device=None, dtype=None):
        super().__init__()
        self.wg = nn.Linear(in_features, num_experts, bias=False, device=device, dtype=dtype)
        nn.init.normal_(self.wg.weight, std=in_features ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.wg.weight.float())


class ControlNetRouter(nn.Module):
    def __init__(self, num_experts: int = 2, router_type: str = "simple_weights",
                 num_routers: int = 12, add_mid_block_router: bool = True,
                 embedding_dim: Optional[int] = None, device=None, dtype=None):
        """``embedding_dim``: the router input's width, needed by the conditional
        types (256 for "timestep_weights", the encoder width for
        "embedding_weights", their sum for "timestep_embedding_weights")."""
        super().__init__()
        if router_type not in ROUTER_TYPES:
            raise ValueError(f"unsupported router_type: {router_type}")
        self.num_experts = num_experts
        self.router_type = router_type
        self.num_routers = num_routers
        self.add_mid_block_router = add_mid_block_router
        self.down_blocks_router = self.mid_block_router = None
        if router_type != "equal_weights":
            if router_type in CONDITIONAL_TYPES and embedding_dim is None:
                raise ValueError(f"router_type={router_type!r} needs embedding_dim")
            in_features = 1 if router_type == "simple_weights" else embedding_dim
            gate = lambda: _WeightGate(num_experts, in_features, device, dtype)  # noqa: E731
            self.down_blocks_router = nn.ModuleList([gate() for _ in range(num_routers)])
            if add_mid_block_router:
                self.mid_block_router = gate()

    @property
    def conditional(self) -> bool:
        return self.router_type in CONDITIONAL_TYPES

    def _logits(self, gate: Optional[_WeightGate], router_input: Optional[torch.Tensor],
                device) -> torch.Tensor:
        if self.router_type == "equal_weights":
            return torch.zeros(self.num_experts, dtype=torch.float32, device=device)
        if self.router_type == "simple_weights":
            return gate(torch.ones(1, 1, device=gate.wg.weight.device))[0]
        if router_input is None:
            raise ValueError(f"router_type={self.router_type!r} needs router_input "
                             "(timestep embedding and/or pooled encoder embedding)")
        x = router_input.float().to(gate.wg.weight.device)
        if x.dim() == 2:  # (B, D): one weight set per call, batch-averaged
            x = x.mean(dim=0)
        return gate(x[None])[0]

    def forward(self, router_input: Optional[torch.Tensor] = None,
                sparse_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (down weights (num_routers, E), mid weights (E,) or None);
        ``sparse_mask`` (E,) is 1 to keep an expert, 0 to mask it."""
        device = next((t.device for t in (router_input, sparse_mask) if t is not None), None)
        gates = self.down_blocks_router or [None] * self.num_routers
        down = torch.stack([self._logits(g, router_input, device) for g in gates])
        mid = (self._logits(self.mid_block_router, router_input, device)
               if self.add_mid_block_router else None)
        if sparse_mask is not None:
            penalty = (1.0 - sparse_mask.float().to(down.device)) * MASK_NEG
            down = down - penalty[None, :]
            mid = None if mid is None else mid - penalty
        return (torch.softmax(down, dim=-1),
                None if mid is None else torch.softmax(mid, dim=-1))


def build_router_input(router_type: str, timesteps=None,
                       encoder_hidden_states: Optional[torch.Tensor] = None,
                       timestep_channels: int = 256) -> Optional[torch.Tensor]:
    """A conditional router's input: the batch-mean sinusoidal embedding of
    ``timesteps`` (a number or (B,)), the token- and batch-mean of
    ``encoder_hidden_states`` (B, T, D), or their concatenation; None for the
    other router types. Given ``encoder_hidden_states``, the input is built on
    their device."""
    device = None if encoder_hidden_states is None else encoder_hidden_states.device
    parts = []
    if router_type in ("timestep_weights", "timestep_embedding_weights"):
        if timesteps is None:
            raise ValueError(f"{router_type} needs timesteps")
        temb = get_timestep_embedding(torch.atleast_1d(timestep_tensor(timesteps, device)),
                                      timestep_channels)
        parts.append(temb.mean(dim=0))
    if router_type in ("embedding_weights", "timestep_embedding_weights"):
        if encoder_hidden_states is None:
            raise ValueError(f"{router_type} needs encoder_hidden_states")
        parts.append(encoder_hidden_states.float().mean(dim=(0, 1)))
    if not parts:
        return None
    return torch.cat(parts, dim=-1)


def fuse_expert_residuals(down_per_expert: Sequence[Sequence[torch.Tensor]],
                          mid_per_expert: Optional[Sequence[torch.Tensor]],
                          down_weights: Optional[torch.Tensor] = None,
                          mid_weights: Optional[torch.Tensor] = None
                          ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Sum of the per-expert residuals, each scaled by its router weight:
    ``down_weights`` (K, E) for the K down slots, ``mid_weights`` (E,); None
    weights are 1 (the routerless path). The mid residual is fused when its
    weights are given or the down weights are not, else None, as in the JAX
    package (``models/router.py:147``)."""
    fused_down = []
    for k in range(len(down_per_expert[0])):
        acc = 0
        for e, down in enumerate(down_per_expert):
            r = down[k]
            acc = acc + (r if down_weights is None else r * down_weights[k, e].to(r.dtype))
        fused_down.append(acc)
    fused_mid = None
    if mid_per_expert is not None and (mid_weights is not None or down_weights is None):
        acc = 0
        for e, r in enumerate(mid_per_expert):
            acc = acc + (r if mid_weights is None else r * mid_weights[e].to(r.dtype))
        fused_mid = acc
    return fused_down, fused_mid
