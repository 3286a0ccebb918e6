"""Flags of the two CLIs: argparse defaults a ``--yaml_file`` may overwrite.

A copy of ``ctrl_adapter_tpu/config.py`` (the reference's ~45 flags of
``train.py:59-342`` and ``inference.py:21-172``, same names, types and
defaults), so that the port's CLIs parse to the same namespaces. ``yaml`` is
imported only where a YAML file is read.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional


def bool_flag(s: str) -> bool:
    """Parse textual booleans (reference `utils/utils.py:bool_flag`); plain
    ``type=bool`` would treat any non-empty string — including "False" — as True."""
    if isinstance(s, bool):
        return s
    low = s.lower()
    if low in ("true", "1", "yes", "on"):
        return True
    if low in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean flag: {s!r}")


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml  # only a YAML config needs it; the inference CLI reads none

    with open(path) as f:
        return yaml.safe_load(f) or {}


def merge_yaml_over_args(args: argparse.Namespace, yaml_file: Optional[str]) -> argparse.Namespace:
    """YAML keys overwrite argparse attributes wholesale (reference `train.py:1525-1528`)."""
    if yaml_file:
        for key, value in load_yaml(yaml_file).items():
            setattr(args, key, value)
    return args


def add_train_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's training flag surface (`train.py:59-342`), defaults preserved."""
    add = parser.add_argument
    add("--yaml_file", type=str, default=None)
    add("--model_name", type=str, default="i2vgenxl",
        choices=["i2vgenxl", "svd", "sdxl"])
    add("--DATA_PATH", type=str, default="./outputs")
    add("--train_data_path", type=str, default="sample_data/videos")
    add("--train_prompt_path", type=str, default="sample_data/video_captions.csv")
    add("--train_batch_size", type=int, default=1)
    add("--height", type=int, default=512)
    add("--width", type=int, default=512)
    add("--use_size_512", type=bool_flag, default=True)
    add("--n_sample_frames", type=int, default=16)
    add("--output_fps", type=int, default=16)
    add("--input_data_type", type=str, default="videos")
    # adapter architecture
    add("--cross_attention_dim", type=int, default=1024)
    add("--add_spatial_resnet", type=bool_flag, default=True)
    add("--add_temporal_resnet", type=bool_flag, default=True)
    add("--add_spatial_transformer", type=bool_flag, default=True)
    add("--add_temporal_transformer", type=bool_flag, default=True)
    add("--num_blocks", type=int, default=1)
    add("--adapter_locations", type=str, nargs="+", default=["A", "B", "C", "D", "M"])
    add("--num_adapters_per_location", type=int, default=3)
    # controlnet
    add("--skip_conv_in", type=bool_flag, default=False)
    add("--skip_time_emb", type=bool_flag, default=False)
    add("--guess_mode", type=bool_flag, default=False,
        help="logspace 0.1->1.0 residual ramp over the ControlNet projection "
             "heads (reference `controlnet/controlnet.py:860-865`)")
    add("--fixed_controlnet_timestep", type=int, default=-1)
    add("--control_types", type=str, nargs="+", default=["depth"])
    add("--mixed_control_types_training", type=str, nargs="+", default=[])
    add("--multi_source_random_select_control_types", type=bool_flag, default=False)
    add("--max_num_multi_source_train", type=int, default=4)
    add("--router_type", type=str, default="simple_weights")
    add("--apply_sparse_frame_mask", type=bool_flag, default=None)
    # optimization (`train.py:86-179`)
    add("--learning_rate", type=float, default=5e-5)
    add("--lr_scheduler", type=str, default="constant",
        choices=["constant", "constant_with_warmup", "linear", "cosine"])
    add("--lr_warmup_steps", type=int, default=0)
    add("--scale_lr", type=bool_flag, default=False,
        help="multiply lr by the device count (reference `train.py:688-689` "
             "scales by num_processes)")
    add("--use_8bit_adam", type=bool_flag, default=False)
    add("--adam_beta1", type=float, default=0.9)
    add("--adam_beta2", type=float, default=0.999)
    add("--adam_weight_decay", type=float, default=1e-2)
    add("--adam_epsilon", type=float, default=1e-8)
    add("--max_grad_norm", type=float, default=1.0)
    add("--noise_offset", type=float, default=0.05)
    add("--snr_gamma", type=float, default=None)
    add("--latent_nan_checking", type=bool_flag, default=False)
    add("--gradient_checkpointing", type=bool_flag, default=True,
        help="rematerialize the frozen-UNet/adapter forwards in the backward (reference `train.py:676-681`); required to fit the full 512^2 step in v5e HBM, so on by default here")
    add("--max_train_steps", type=int, default=50000)
    add("--gradient_accumulation_steps", type=int, default=1)
    add("--checkpointing_steps", type=int, default=2000)
    add("--save_n_steps", type=int, default=None,
        help="reference alias for --checkpointing_steps; wins when set")
    add("--save_starting_step", type=int, default=0)
    add("--validate_every_steps", type=int, default=2000)
    add("--run_validation_at_start", type=bool_flag, default=False)
    add("--num_repeats", type=int, default=1,
        help="experimental repeated-adapter aggregation (`ctrl_adapter.py:78-100`)")
    add("--out_channels", type=int, default=None,
        help="zero-conv output width for --num_repeats > 1 "
             "(reference `train.py:337`, `ctrl_adapter.py:208-221`)")
    add("--max_vae_encode", type=int, default=None,
        help="chunk size for VAE encoding inside the train step "
             "(`train.py:1027-1036`); None encodes all frames at once")
    add("--disable_optimizer_restore", type=bool_flag, default=False)
    add("--num_inference_steps", type=int, default=25)
    add("--seed", type=int, default=42)
    add("--mixed_precision", type=str, default="bf16")
    # model paths (local; zero-egress image needs pre-downloaded checkpoints)
    add("--pretrained_model_path", type=str, default=None,
        help="local dir with converted backbone (unet/vae/text encoder) params")
    add("--controlnet_model_paths", type=str, nargs="+", default=None,
        help="local dirs with converted SD-v1.5 ControlNet params, one per control type")
    add("--controlnet_text_encoder_path", type=str, default=None,
        help="local SD-v1.5 dir (tokenizer/ + text_encoder/, CLIP-L 768) for the "
             "ControlNet prompt tower; the reference always loads SD-v1.5 here "
             "(`model/ctrl_helper.py:24`) regardless of backbone. Required for "
             "i2vgenxl/svd (their backbone dirs carry OpenCLIP-H / no text tower); "
             "defaults to --pretrained_model_path for sdxl (also CLIP-L 768)")
    add("--adapter_resume_path", type=str, default=None)
    add("--adapter_resume_step", type=int, default=None)
    return parser


def add_inference_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's inference flag surface (`inference.py:21-172`)."""
    add = parser.add_argument
    add("--model_name", type=str, default="i2vgenxl", choices=["i2vgenxl", "svd", "sdxl"])
    add("--control_types", type=str, nargs="+", default=["depth"])
    add("--eval_input_type", type=str, default="frames", choices=["frames", "images"])
    add("--evaluation_input_folder", type=str, default="assets/evaluation/frames")
    add("--evaluation_output_folder", type=str, default="outputs")
    add("--evaluation_prompt_file", type=str, default="captions.json")
    add("--num_inference_steps", type=int, default=50)
    add("--guidance_scale", type=float, default=9.0)
    # one value, or one per expert for multi-condition i2vgenxl inference
    # (reference Union[float, List[float]], `i2vgen_xl_..._pipeline.py:572`)
    add("--controlnet_conditioning_scale", type=float, nargs="+", default=1.0)
    add("--control_guidance_start", type=float, nargs="+", default=0.0)
    add("--control_guidance_end", type=float, nargs="+", default=0.8)
    add("--height", type=int, default=512)
    add("--width", type=int, default=512)
    add("--n_sample_frames", type=int, default=16)
    add("--output_fps", type=int, default=16)
    add("--skip_conv_in", type=bool_flag, default=False)
    add("--skip_time_emb", type=bool_flag, default=False)
    add("--guess_mode", type=bool_flag, default=False,
        help="logspace 0.1->1.0 residual ramp over the ControlNet projection "
             "heads (reference `controlnet/controlnet.py:860-865`)")
    add("--sparse_frames", type=str, nargs="+", default=None)
    add("--inference_expert_masks", type=int, nargs="+", default=None)
    add("--extract_control_conditions", type=bool_flag, default=False)
    add("--use_size_512", type=bool_flag, default=True)
    add("--seed", type=int, default=42)
    # checkpoints (local paths in this zero-egress image)
    add("--pretrained_model_path", type=str, default=None)
    add("--controlnet_model_paths", type=str, nargs="+", default=None)
    add("--controlnet_text_encoder_path", type=str, default=None,
        help="SD-v1.5 dir for the ControlNet prompt tower (see train args)")
    add("--adapter_checkpoint_path", type=str, default=None,
        help="dir with adapter safetensors (HF release subfolder) or orbax dir")
    add("--router_checkpoint_path", type=str, default=None)
    add("--num_images_per_prompt", type=int, default=1)
    add("--video_length", type=int, default=16)
    add("--video_duration", type=int, default=1000)
    add("--noise_aug_strength", type=float, default=0.02,
        help="SVD image-space noise augmentation before the VAE conditioning encode "
             "(reference `svd_...py:560-562`)")
    add("--negative_prompt", type=str, default="",
        help="negative prompt for the CFG uncond half (reference "
             "`sdxl_..._pipeline.py:547-589` exposes this on every pipeline)")
    add("--evaluate", type=bool_flag, default=False,
        help="emit per-sample control-fidelity metrics JSON next to the outputs "
             "(canny F1 / depth correlation / temporal consistency)")
    return parser
