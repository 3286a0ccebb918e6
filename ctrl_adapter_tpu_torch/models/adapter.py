"""Ctrl-Adapter: per-location spatio-temporal adapter blocks (NCHW).

Counterpart of ``ctrl_adapter_tpu/models/adapter.py``. Bug-compatible with the
reference: the transformers run at ``inner_dim = 8 * attention_head_dim`` (512)
while their attention inner dim is ``in_channels`` (320/640/1280), so the
temporal kernel K3 runs with ia != c here. Unadapted residual slots are zeros.
Every GroupNorm of the adapter asks for kernel K1 (``kernel="prefer"``, the JAX
``use_pallas="prefer"``) and gets it where the JAX shape rule holds.

For the SDXL backbone (``backbone_model_name="sdxl"``) every block upsamples x2
in its first layer, since the SD-v1.5 ControlNet's 64x64 features meet SDXL's
128x128 latents: through the spatial ResNet's ``up`` resize, or a bare nearest
resize when the block has no ResNet; the unadapted slots are zeros of the
doubled size. ``num_repeats > 1`` (experimental) runs the blocks that many
times and sums each repeat's outputs through zero-initialised 1x1
``zero_convs``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..nn.attention import BasicTransformerBlock, TemporalBasicTransformerBlock
from ..nn.embeddings import (TimestepEmbedding, Timesteps, get_timestep_embedding,
                             timestep_tensor)
from ..nn.resnet import AlphaBlender, GroupNorm, ResnetBlock2D, TemporalResnetBlock
from ..nn.unet_st_blocks import from_5d, to_5d
from ..ops.resize import nearest_resize
from ..parallel import mesh
from ..utils import profiling

_LOCATION_ID_MAP = {
    "A": {3: [0, 1, 2], 2: [0, 2], 1: [2]},
    "B": {3: [3, 4, 5], 2: [3, 5], 1: [5]},
    "C": {3: [6, 7, 8], 2: [6, 8], 1: [8]},
    "D": {3: [9, 10, 11], 2: [9, 11], 1: [11]},
}
_LOCATION_CHANNEL_MAP = {
    "A": {3: [320, 320, 320], 2: [320, 320], 1: [320]},
    "B": {3: [320, 640, 640], 2: [320, 640], 1: [640]},
    "C": {3: [640, 1280, 1280], 2: [640, 1280], 1: [1280]},
    "D": {3: [1280, 1280, 1280], 2: [1280, 1280], 1: [1280]},
}
MID_BLOCK_CHANNELS = 1280
# The reference builds the transformers at inner_dim = 8 * attention_head_dim
# (its default num_attention_heads), whatever the block's channel count.
_INNER_HEADS = 8


def get_down_block_ids(locations: Sequence[str], num_adapters_per_location: int) -> List[int]:
    return [i for loc in "ABCD" if loc in locations
            for i in _LOCATION_ID_MAP[loc].get(num_adapters_per_location, [])]


def get_down_block_channels(locations: Sequence[str],
                            num_adapters_per_location: int) -> List[int]:
    return [c for loc in "ABCD" if loc in locations
            for c in _LOCATION_CHANNEL_MAP[loc].get(num_adapters_per_location, [])]


class AdapterSpatioTemporal(nn.Module):
    """One adapter block: {spatial ResNet, temporal ResNet, spatial transformer,
    temporal transformer} x num_layers with learned AlphaBlender time mixing."""

    def __init__(self, channels: int, num_layers: int = 1, add_spatial_resnet: bool = True,
                 add_temporal_resnet: bool = True, add_spatial_transformer: bool = True,
                 add_temporal_transformer: bool = True, cross_attention_dim: int = 1024,
                 attention_head_dim: int = 64, up_sampling_scale: float = 1.0, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_layers = num_layers
        self.up_sampling_scale = up_sampling_scale
        self.channels = channels
        self.flags = (add_spatial_resnet, add_temporal_resnet, add_spatial_transformer,
                      add_temporal_transformer)
        attn_heads = channels // attention_head_dim
        inner = _INNER_HEADS * attention_head_dim  # bug-compatible, see module doc
        layers = range(num_layers)
        if add_spatial_resnet or add_temporal_resnet:
            self.resnet_time_proj = Timesteps(channels, True, 0.0)
            self.resnet_time_embedding = TimestepEmbedding(channels, channels, **kw)
        if add_spatial_transformer or add_temporal_transformer:
            self.norm = GroupNorm(32, channels, 1e-6, kernel="prefer", **kw)
            self.proj_in = nn.Linear(channels, inner, **kw)
            self.proj_out = nn.Linear(inner, channels, **kw)
            if add_temporal_transformer:
                self.transformer_time_embedding = TimestepEmbedding(channels, inner, **kw)
        if add_spatial_resnet:
            self.spatial_resnets = nn.ModuleList([ResnetBlock2D(
                channels, channels, channels, eps=1e-6, use_in_shortcut=True,
                gn_kernel="prefer", up=i == 0 and up_sampling_scale > 1, **kw) for i in layers])
        if add_temporal_resnet:
            self.temporal_resnets = nn.ModuleList([TemporalResnetBlock(
                channels, channels, channels, eps=1e-6, gn_kernel="prefer", **kw) for _ in layers])
        if add_spatial_resnet and add_temporal_resnet:
            self.resnets_time_mixer = nn.ModuleList([AlphaBlender(**kw) for _ in layers])
        if add_spatial_transformer:
            self.spatial_attentions = nn.ModuleList([BasicTransformerBlock(
                inner, attn_heads, attention_head_dim, cross_attention_dim, **kw)
                for _ in layers])
        if add_temporal_transformer:
            self.temporal_attentions = nn.ModuleList([TemporalBasicTransformerBlock(
                inner, inner, attn_heads, attention_head_dim, cross_attention_dim, **kw)
                for _ in layers])
        if add_spatial_transformer and add_temporal_transformer:
            self.transformers_time_mixer = nn.ModuleList([AlphaBlender(**kw) for _ in layers])

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                timestep=None, encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """hidden_states (b*f, c, h, w); timestep scalar, (b,) or (b*f,);
        encoder_hidden_states (1|b|b*f, n, d)."""
        spatial_res, temporal_res, spatial_tr, temporal_tr = self.flags
        bf, c, height, width = hidden_states.shape
        b = bf // num_frames
        dtype = hidden_states.dtype
        device = hidden_states.device
        if timestep is not None:
            timestep = timestep_tensor(timestep, device).reshape(-1).float()
            if timestep.shape[0] != bf:
                timestep = timestep.repeat_interleave(bf // timestep.shape[0])
        indicator = torch.zeros((b, num_frames), dtype=torch.float32, device=device)
        ehs = encoder_hidden_states
        if ehs is not None:
            if ehs.dim() == 2:
                ehs = ehs[:, None, :]
            if ehs.shape[0] != bf:
                ehs = ehs.repeat_interleave(bf // ehs.shape[0], dim=0)
            ehs = ehs.to(dtype)

        scale = self.up_sampling_scale
        up_size = (int(height * scale), int(width * scale))
        for i in range(self.num_layers):
            if spatial_res or temporal_res:
                resnet_temb = self.resnet_time_embedding(
                    self.resnet_time_proj(timestep).to(dtype))
            if spatial_res:
                hidden_states = self.spatial_resnets[i](
                    hidden_states, resnet_temb, up_size if i == 0 and scale > 1 else None)
                height, width = hidden_states.shape[-2:]
                if temporal_res:
                    mix_5d = to_5d(hidden_states, num_frames)
            if temporal_res:
                hs_5d = self.temporal_resnets[i](
                    to_5d(hidden_states, num_frames),
                    resnet_temb.reshape(b, num_frames, -1))
                if spatial_res:
                    hs_5d = self.resnets_time_mixer[i](mix_5d, hs_5d, indicator)
                hidden_states = from_5d(hs_5d)
            if not (spatial_res or temporal_res) and i == 0 and scale > 1:
                hidden_states = nearest_resize(hidden_states, up_size)  # no ResNet to resize
                height, width = up_size

            if spatial_tr or temporal_tr:
                residual = hidden_states
                x = self.norm(hidden_states).permute(0, 2, 3, 1).reshape(bf, height * width, c)
                proj = self.proj_in(x)
                if temporal_tr:
                    frame_idx = torch.arange(num_frames, dtype=torch.float32,
                                             device=device).repeat(b)
                    frame_emb = get_timestep_embedding(frame_idx, self.channels, True, 0.0)
                    frame_emb = self.transformer_time_embedding(frame_emb.to(dtype))[:, None]
                    # first-frame context broadcast over pixels, spatial-major rows
                    time_context = mesh.time_context(ehs, b, num_frames, height * width)
                if spatial_tr:
                    proj = self.spatial_attentions[i](proj, ehs)
                    proj_mix = proj
                if temporal_tr:
                    proj = self.temporal_attentions[i](proj + frame_emb, num_frames,
                                                       time_context)
                    if spatial_tr:
                        proj = self.transformers_time_mixer[i](proj_mix, proj, indicator)
                proj = self.proj_out(proj)
                hidden_states = proj.reshape(bf, height, width, c).permute(0, 3, 1, 2) + residual
        return hidden_states


class ControlNetAdapter(nn.Module):
    """Adapters over the 12 + 1 ControlNet residual slots; zeros at unadapted
    slots (of twice the size for SDXL)."""

    def __init__(self, num_blocks: int = 2, num_adapters_per_location: int = 3,
                 cross_attention_dim: Optional[int] = None, add_spatial_resnet: bool = True,
                 add_temporal_resnet: bool = False, add_spatial_transformer: bool = True,
                 add_temporal_transformer: bool = False,
                 adapter_locations: Tuple[str, ...] = ("A", "B", "C", "D", "M"),
                 custom_down_block_channels: Optional[Tuple[int, ...]] = None,
                 custom_mid_block_channels: Optional[int] = None, attention_head_dim: int = 64,
                 backbone_model_name: str = "i2vgenxl", num_repeats: int = 1,
                 out_channels: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.adapter_locations = tuple(adapter_locations)
        # SDXL's latents are twice the SD-v1.5 ControlNet's features
        self.up_scale = 2.0 if backbone_model_name == "sdxl" else 1.0
        self.num_repeats = num_repeats
        self.down_block_ids = get_down_block_ids(adapter_locations, num_adapters_per_location)
        channels = (list(custom_down_block_channels) if custom_down_block_channels is not None
                    else get_down_block_channels(adapter_locations, num_adapters_per_location))
        channels = channels[:len(self.down_block_ids)]
        block = lambda ch: AdapterSpatioTemporal(  # noqa: E731
            ch, num_blocks, add_spatial_resnet, add_temporal_resnet, add_spatial_transformer,
            add_temporal_transformer, cross_attention_dim, attention_head_dim, self.up_scale,
            **kw)
        self.down_blocks_adapter = nn.ModuleList(
            [block(ch) for _ in range(num_repeats) for ch in channels])
        self.mid_block_adapter = (block(custom_mid_block_channels or MID_BLOCK_CHANNELS)
                                  if "M" in adapter_locations else None)
        self.zero_convs = None
        if num_repeats > 1:
            if out_channels is None:
                raise ValueError("num_repeats > 1 needs out_channels")
            # the reference's sum reads slot k of each repeat for the k-th
            # adapted block, whose width this takes to be channels[k]
            self.zero_convs = nn.ModuleList([nn.Conv2d(ch, out_channels, 1, **kw)
                                             for _ in range(num_repeats) for ch in channels])
            with torch.no_grad():
                for conv in self.zero_convs:
                    conv.weight.zero_()
                    conv.bias.zero_()

    def forward(self, down_block_res_samples: Sequence[torch.Tensor],
                mid_block_res_sample: Optional[torch.Tensor] = None, num_frames: int = 1,
                timestep=None, encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        with profiling.span("tower.adapter"):
            dtype = next(self.parameters()).dtype
            n_slots = len(down_block_res_samples)
            num_active = len([i for i in self.down_block_ids if i < n_slots])
            out: List[torch.Tensor] = []  # num_repeats x n_slots
            for r in range(self.num_repeats):
                k = 0
                for i, ref in enumerate(down_block_res_samples):
                    if i in self.down_block_ids:
                        out.append(self.down_blocks_adapter[k + r * num_active](
                            ref.to(dtype), num_frames, timestep, encoder_hidden_states))
                        k += 1
                    elif self.up_scale > 1:
                        n, c, h, w = ref.shape
                        out.append(torch.zeros((n, c, 2 * h, 2 * w), dtype=ref.dtype,
                                               device=ref.device))
                    else:
                        out.append(torch.zeros_like(ref))
            mid = None
            if mid_block_res_sample is not None and self.mid_block_adapter is not None:
                mid = self.mid_block_adapter(
                    mid_block_res_sample.to(dtype),
                    num_frames, timestep, encoder_hidden_states)
            if self.zero_convs is None:
                return out, mid
            aggregated = []
            for r in range(self.num_repeats):
                acc = 0.0
                for k in range(num_active):
                    conv = self.zero_convs[k + r * num_active]
                    x = out[k + n_slots * r]
                    if x.shape[1] != conv.in_channels:
                        raise ValueError(f"zero_convs.{k + r * num_active} reads slot {k} of "
                                         f"width {x.shape[1]}, built for {conv.in_channels}")
                    acc = acc + conv(x.to(dtype))
                aggregated.append(acc)
            return aggregated, None
