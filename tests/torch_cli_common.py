"""Thin towers and fabricated folders for the tests of the two CLIs of the port.

The CLIs build their towers at the released widths; the tests swap
``inference_torch.build_modules`` for ``thin_build_modules`` and
``train_torch.build_modules`` for ``thin_train_modules``, which build the same
classes at thin widths in float32 on the CPU. The widths the CLI's inputs fix stay: the
ControlNet's prompt width 768, the image embedding 1024, SDXL's 2048-wide
prompt and 1280-wide pooled embedding. ``write_thin_release`` writes a
pipeline's towers as diffusers folders, with thin CLIP encoders at those
widths, so the real-weights path runs too; ``write_annotators`` writes thin
depth and segmentation checkpoints where the extractors look for them, and
``write_clips`` a folder of PNG-frame clips for the training data path.
Imports neither JAX nor any
package the card's host lacks (``test_cli_runs_without_host_packages`` runs it
behind a blocking import hook).
"""

from __future__ import annotations

import argparse
import os

import torch

import chip_smoke
from ctrl_adapter_tpu_torch.conditions import MULTI_CONDITION_EXPERT_ORDER
from ctrl_adapter_tpu_torch.conditions.dpt import DPTConfig
from ctrl_adapter_tpu_torch.conditions.extractors import DEFAULT_PATHS
from ctrl_adapter_tpu_torch.conditions.segformer import SegformerConfig
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter, get_down_block_ids
from ctrl_adapter_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
from ctrl_adapter_tpu_torch.models.unet_2d import UNet2DConditionModel, UNet2DConfig
from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, I2VGenXLUNetConfig
from ctrl_adapter_tpu_torch.models.unet_svd import SVDUNetConfig
from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline
from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline
from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

torch.set_num_threads(1)

THIN_CHANNELS = (32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64)
CNET = ControlNetConfig(block_out_channels=(32, 32, 64, 64), num_attention_heads=(4, 4, 4, 4),
                        cross_attention_dim=768, conditioning_embedding_out_channels=(8, 8, 16, 16),
                        norm_num_groups=16)
SDXL_CNET = ControlNetConfig(block_out_channels=(32, 32, 32, 32),
                             num_attention_heads=(4, 4, 4, 4), cross_attention_dim=768,
                             conditioning_embedding_out_channels=(8, 8, 16, 16),
                             norm_num_groups=16)
SVD_UNET = SVDUNetConfig(block_out_channels=(32, 32, 64, 64), num_attention_heads=(2, 2, 4, 4),
                         cross_attention_dim=1024, addition_time_embed_dim=8,
                         projection_class_embeddings_input_dim=24)
I2V_UNET = I2VGenXLUNetConfig(block_out_channels=(32, 32, 64, 64), norm_num_groups=16,
                              cross_attention_dim=1024, attention_head_dim=16)
SDXL_UNET = UNet2DConfig(
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), block_out_channels=(32, 32),
    transformer_layers_per_block=(1, 2), num_attention_heads=(2, 2), cross_attention_dim=2048,
    use_linear_projection=True, norm_num_groups=16, addition_embed_type="text_time",
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=1280 + 6 * 8)
# SDXL trains only at 1024^2 (train.py's control latent min(64, height // 8) is
# half the UNet latent there alone): three levels of 32 channels at the 128^2
# latent, attention at 32^2 only, the two-residual levels of SDXL's UNet so
# that the adapter's slots 0-8 meet residuals of their sizes
SDXL_TRAIN_UNET = UNet2DConfig(
    down_block_types=("DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D"), block_out_channels=(32,) * 3,
    transformer_layers_per_block=(1, 1, 1), num_attention_heads=(2, 2, 2),
    cross_attention_dim=2048, use_linear_projection=True, norm_num_groups=16,
    addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=1280 + 6 * 8)
# SD-v1.5 CLIP-L and OpenCLIP-H towers at 2 layers, their output widths kept
CN_TEXT = CLIPTextConfig(vocab_size=1024, hidden_size=768, num_layers=2, num_heads=4,
                         intermediate_size=64, eos_token_id=2)
I2V_TEXT = CLIPTextConfig(vocab_size=1024, hidden_size=1024, num_layers=2, num_heads=4,
                          intermediate_size=64, hidden_act="gelu", eos_token_id=2)
SDXL_TEXT2 = CLIPTextConfig(vocab_size=1024, hidden_size=1280, num_layers=2, num_heads=4,
                            intermediate_size=64, hidden_act="gelu", eos_token_id=2,
                            projection_dim=1280)
VISION = CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=64, projection_dim=1024)
SIZE = {"svd": 64, "i2vgenxl": 64, "sdxl": 128}  # --height/--width of the thin runs
FRAMES = 3
# the extractors' networks at the thin widths of tests/test_dpt.py and tests/test_segformer.py
THIN_DPT = DPTConfig(hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
                     patch_size=8, image_size=32, backbone_out_indices=(0, 1, 2, 3),
                     neck_hidden_sizes=(16, 32, 64, 64), fusion_hidden_size=16)
THIN_SEGFORMER = SegformerConfig(num_labels=9, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 2, 1),
                                 num_heads=(1, 2, 3, 4), mlp_ratios=(2, 2, 2, 2),
                                 decoder_hidden_size=16)


def thin_build_modules(args, device, dtype=torch.float32):
    """``inference_torch.build_modules`` at thin widths (float32 by default)."""
    kw = dict(device=device, dtype=dtype)
    temporal = args.model_name != "sdxl"
    if args.model_name == "sdxl":
        adapter = ControlNetAdapter(
            backbone_model_name="sdxl", num_blocks=1, num_adapters_per_location=3,
            cross_attention_dim=2048, adapter_locations=("A",), add_temporal_resnet=False,
            add_temporal_transformer=False, custom_down_block_channels=(32,) * 3,
            attention_head_dim=16, **kw)
        vae = AutoencoderKL(VAEConfig(block_out_channels=(16,) * 4, norm_num_groups=8,
                                      layers_per_block=1, scaling_factor=0.13025), **kw)
        pipe = SDXLControlNetAdapterPipeline(UNet2DConditionModel(SDXL_UNET, **kw),
                                             ControlNetModel(SDXL_CNET, **kw), adapter, vae)
    else:
        adapter = ControlNetAdapter(
            backbone_model_name=args.model_name, num_blocks=1, num_adapters_per_location=3,
            cross_attention_dim=1024, adapter_locations=("A", "B", "C", "D", "M"),
            add_temporal_resnet=temporal, add_temporal_transformer=temporal,
            custom_down_block_channels=THIN_CHANNELS, custom_mid_block_channels=64,
            attention_head_dim=16, **kw)
        if args.model_name == "svd":
            vae = AutoencoderKLTemporalDecoder(
                VAEConfig(block_out_channels=(32,) * 4, norm_num_groups=8, layers_per_block=1),
                **kw)
            pipe = SVDControlNetAdapterPipeline(
                UNetSpatioTemporalConditionModel(SVD_UNET, **kw), ControlNetModel(CNET, **kw),
                adapter, vae)
        else:
            vae = AutoencoderKL(VAEConfig(block_out_channels=(16,) * 4, norm_num_groups=8,
                                          layers_per_block=1), **kw)
            router = None
            if len(args.control_types) > 1:
                router = ControlNetRouter(num_experts=len(MULTI_CONDITION_EXPERT_ORDER),
                                          device=device, dtype=torch.float32)
            cnets = MultiControlNetModel([ControlNetModel(CNET, **kw)
                                          for _ in args.control_types])
            pipe = I2VGenXLControlNetAdapterPipeline(I2VGenXLUNet(I2V_UNET, **kw), cnets,
                                                     adapter, vae, router=router)
    for name in ("unet", "controlnet", "adapter", "vae", "router"):
        module = getattr(pipe, name, None)
        if module is not None:
            module.eval().requires_grad_(False)
    return pipe


def thin_train_modules(args, num_experts, device, dtype=torch.float32):
    """``train_torch.build_modules`` at thin widths (float32 by default): the
    towers of ``thin_build_modules``, ``num_experts`` ControlNets, the adapter
    of the flags at the thin ControlNet's residual widths (for the flags'
    defaults, ``thin_build_modules``'s adapter) and, for several experts, a
    router of ``args.router_type``."""
    pipe = thin_build_modules(argparse.Namespace(model_name=args.model_name,
                                                 control_types=args.control_types[:1]),
                              device, dtype)
    sdxl = args.model_name == "sdxl"
    cnet = SDXL_CNET if sdxl else CNET
    nets = [ControlNetModel(cnet, device=device, dtype=dtype) for _ in range(num_experts)]
    widths = (32,) * 12 if sdxl else THIN_CHANNELS
    ids = get_down_block_ids(args.adapter_locations, args.num_adapters_per_location)
    adapter = ControlNetAdapter(
        backbone_model_name=args.model_name, num_blocks=args.num_blocks,
        num_adapters_per_location=args.num_adapters_per_location,
        cross_attention_dim=args.cross_attention_dim,
        adapter_locations=tuple(args.adapter_locations),
        add_spatial_resnet=args.add_spatial_resnet,
        add_temporal_resnet=args.add_temporal_resnet and not sdxl,
        add_spatial_transformer=args.add_spatial_transformer,
        add_temporal_transformer=args.add_temporal_transformer and not sdxl,
        custom_down_block_channels=[widths[i] for i in ids],
        custom_mid_block_channels=32 if sdxl else 64, attention_head_dim=16,
        num_repeats=args.num_repeats, out_channels=args.out_channels, device=device,
        dtype=dtype)
    router = (ControlNetRouter(num_experts, args.router_type, device=device, dtype=torch.float32)
              if num_experts > 1 else None)
    unet = UNet2DConditionModel(SDXL_TRAIN_UNET, device=device, dtype=dtype) if sdxl else pipe.unet
    return unet, nets, adapter, pipe.vae, router


def write_thin_release(pipe, model_name, root, dtype=torch.float32):
    """Write ``pipe``'s towers (randomised first, scale 0.05) and thin CLIP
    encoders as diffusers folders under ``root``; returns the CLI flags."""
    for i, module in enumerate(m for m in (pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae,
                                           getattr(pipe, "router", None)) if m is not None):
        chip_smoke.random_fill(module, 10 + i, scale=0.05)
    flags = chip_smoke.write_stack(pipe, root)
    sd15 = os.path.join(root, "sd15")
    chip_smoke.write_text_encoder(sd15, CN_TEXT, 1, dtype, "cpu")
    if model_name == "sdxl":
        chip_smoke.write_text_encoder(root, CN_TEXT, 2, dtype, "cpu")
        chip_smoke.write_text_encoder(root, SDXL_TEXT2, 3, dtype, "cpu",
                                      subfolder="text_encoder_2", tokenizer="tokenizer_2",
                                      pad_token="!")
    elif model_name == "i2vgenxl":
        chip_smoke.write_text_encoder(root, I2V_TEXT, 2, dtype, "cpu", pad_token="!")
    if model_name != "sdxl":
        chip_smoke.write_image_encoder(root, VISION, 4, dtype, "cpu")
    return flags + ["--controlnet_text_encoder_path", sd15]


def cli_argv(model_name, control_types, fixture, out, *extra):
    """The thin run's flags: 3 frames, 2 steps (one controlled)."""
    size = SIZE[model_name]
    return ["--model_name", model_name, "--control_types", *control_types,
            "--evaluation_input_folder", fixture, "--evaluation_output_folder", out,
            "--height", str(size), "--width", str(size), "--n_sample_frames", str(FRAMES),
            "--num_inference_steps", "2", "--seed", "3", *extra]


def write_fixture(root, control_types):
    return chip_smoke.write_cli_fixture(root, FRAMES, 48, control_types, seed=5)


def frames_of(path):
    with open(path, "rb") as fh:
        return chip_smoke.decode_gif(fh.read())


def write_annotators(root):
    """Thin ``Intel/dpt-large`` and SegFormer folders under ``root`` at the
    extractors' default paths (preprocessing to 32^2 and 64^2); returns
    {type: folder}."""
    chip_smoke.write_dpt(os.path.join(root, DEFAULT_PATHS["depth"]), THIN_DPT, 21, "cpu",
                         scale=0.2, preprocessor=dict(chip_smoke.DPT_PREPROCESSOR, size=32))
    chip_smoke.write_segformer(os.path.join(root, DEFAULT_PATHS["segmentation"]),
                               THIN_SEGFORMER, 22, "cpu", scale=0.3,
                               preprocessor=dict(chip_smoke.SEGFORMER_PREPROCESSOR, size=64))
    return {k: os.path.join(root, v) for k, v in DEFAULT_PATHS.items()}


def write_clips(root, frames=5, size=64):
    """Two PNG-frame clips and their captions csv; returns (folder, csv)."""
    return chip_smoke.write_clip_folder(root, 2, frames, size, seed=6)


def train_flags(flags):
    """``write_thin_release``'s flags without the adapter's and the router's
    folders, which the training CLI does not read."""
    out = list(flags)
    for name in ("--adapter_checkpoint_path", "--router_checkpoint_path"):
        if name in out:
            i = out.index(name)
            del out[i: i + 2]
    return out
