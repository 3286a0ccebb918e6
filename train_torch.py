"""Ctrl-Adapter training CLI of the PyTorch port (SVD, I2VGen-XL, SDXL) on H100s.

The port's counterpart of ``train.py``, with the same flags
(``ctrl_adapter_tpu_torch/config.py:add_train_args`` plus ``--fake_weights``,
``--synthetic_data``, ``--run_validation``, ``--use_wandb`` and
``--multihost``), the same step log (``{DATA_PATH}/train_log.jsonl``, one
``{"step", "loss", "lr", "loss_time"}`` record a step, with a router also
``"down_block_weights"``) and the reference's checkpoint layout
(``checkpoint-{step}/`` holding ``adapter_{step}/``, ``router_{step}/``,
``optimizer/`` and ``config.json``: ``train/checkpoints.py``).

- The frozen towers (the backbone UNet, one SD-v1.5 ControlNet per expert,
  the VAE: the temporal one for SVD, which a released SVD ``vae/`` folder
  loads into) are bf16 under ``--mixed_precision bf16`` (else fp32); the
  adapter (and the router) train on fp32 masters (``train/trainer.py``),
  drawn under flax's default initialisers (``train/init.py``) or restored
  (``--adapter_resume_path`` is a ``checkpoint-{step}`` folder,
  ``--adapter_resume_step`` its step).
- ``--fake_weights``: the frozen towers drawn on the device from a generator
  of ``--seed`` at scale ``FAKE_WEIGHT_SCALE``. Otherwise diffusers folders, loaded strictly by
  name (``convert/release.py``): ``{--pretrained_model_path}/unet`` and
  ``/vae`` (the JAX CLI reads orbax directories there) and one
  ``--controlnet_model_paths`` folder per control type; the towers of
  ``--mixed_control_types_training`` stay resident.
- Data: synthetic batches in the trainer's layouts (``--synthetic_data``, or
  with ``--fake_weights``), or the dataset path (``build_real_data_pipeline``,
  as ``train.py``'s): ``--train_data_path`` holds clips (video files where
  cv2 is installed, else directories of PNG frames) or images (SDXL,
  ``--input_data_type images``), ``--train_prompt_path`` their captions; two
  prefetch threads read them, extract their conditions on the card
  (``conditions/extractors.py``; checkpoint paths by type from the JSON of
  ``CTRL_ADAPTER_ANNOTATORS``) and encode the captions and first frames with
  the CLIP towers of ``--pretrained_model_path`` and
  ``--controlnet_text_encoder_path``. Under ``--mixed_control_types_training``
  each batch has one type, and the resident ControlNet of that type is
  swapped in for its step. softedge, scribble, lineart, normal and openpose
  need their checkpoint's path under their type in
  ``CTRL_ADAPTER_ANNOTATORS`` (``conditions/extractors.py:ANNOTATORS``);
  without one the run raises ``RuntimeError`` before anything is built.
- Step ``s`` takes its synthetic batch, expert mask, sparse frames and the
  seed of its noise draws from numpy's generator of ``(--seed, s)``: every
  process draws the same, and a resumed run continues at
  ``adapter_resume_step + 1`` with what an uninterrupted run would have
  drawn. The dataset's items come from the prefetcher's own generators,
  seeded with ``--seed`` plus the process's rank, so that the processes read
  different items.
- Several processes, one card each: ``torchrun --nproc_per_node N
  train_torch.py ... --multihost`` (``cuda:LOCAL_RANK``, NCCL). Each builds
  the global batch of ``train_batch_size`` x N and trains on its slice; the
  trainer averages the gradients over the processes (``parallel/mesh.py``),
  so N processes make the update of one process that averages the gradients
  of the N slices. That equals one process over the whole batch only for the
  I2VGen-XL and SDXL branches with one expert or a simple-weights or
  equal-weights router: SVD's temporal blocks pair rows across videos at a batch above one,
  and the conditional routers average their input over the batch (ROADMAP
  Queue 3). Rank 0 logs (the loss and router weights averaged over the processes),
  validates and writes the checkpoints.

``main`` runs on the CUDA card, and raises when there is none unless its
caller passes ``device="cpu"``.

    python train_torch.py --yaml_file configs/svd_train_depth.yaml --fake_weights \\
        --max_train_steps 3 --checkpointing_steps 2 --DATA_PATH outputs/svd
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ctrl_adapter_tpu_torch.conditions.extractors import ConditionExtractor, check_control_types
from ctrl_adapter_tpu_torch.config import add_train_args, merge_yaml_over_args
from ctrl_adapter_tpu_torch.convert.release import load_release
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG, UNet2DConditionModel
from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet
from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.ops.backend import resolve_device
from ctrl_adapter_tpu_torch.parallel import mesh as parallel
from ctrl_adapter_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from ctrl_adapter_tpu_torch.train.init import init_trainable
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig
from ctrl_adapter_tpu_torch.utils.image import (resize, save_concat_gif, save_gif, save_png,
                                                unit_to_uint8)

# the std of the --fake_weights towers' draws
FAKE_WEIGHT_SCALE = 0.02
# the router input's width per conditional router type: a 256-wide timestep
# embedding and/or the embedding the trainer passes (CLIP image for the video
# backbones, the prompt for SDXL)
_TIMESTEP_DIM = 256


@dataclasses.dataclass
class TrainRun:
    """What ``main`` did: the trainer, this process's place among the
    processes, the records it logged, the checkpoints and validation samples it
    wrote, the resident per-type ControlNets of mixed-type training, each
    step's expert mask and (real data) control types, and its timings
    (seconds to build, fill or load and initialise; seconds of each
    ``train_step``, the card synchronised; seconds each real batch was waited
    for)."""

    trainer: CtrlAdapterTrainer
    mesh: parallel.Mesh
    records: List[dict]
    checkpoints: List[str]
    validations: List[str]
    controlnet_by_type: Dict[str, ControlNetModel]
    expert_masks: List[Optional[List[float]]]
    build_s: float
    step_s: List[float]
    step_types: List[Optional[List[str]]] = dataclasses.field(default_factory=list)
    wait_s: List[float] = dataclasses.field(default_factory=list)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    add_train_args(parser)
    parser.add_argument("--fake_weights", action="store_true",
                        help="fabricated frozen towers + synthetic data (smoke/perf)")
    parser.add_argument("--synthetic_data", action="store_true")
    parser.add_argument("--run_validation", action="store_true",
                        help="generate a validation sample every validate_every_steps "
                             "(the reference's run_validation, `train.py:943-953`)")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group torchrun describes (one process per card)")
    args = parser.parse_args(argv)
    args = merge_yaml_over_args(args, args.yaml_file)
    if args.save_n_steps:  # reference flag name wins when set
        args.checkpointing_steps = args.save_n_steps
    return args


def train_config(args) -> TrainConfig:
    """The JAX CLI's ``TrainConfig`` of ``args`` (``train.py:185-225``)."""
    num_experts = (len(args.control_types)
                   if getattr(args, "multi_source_random_select_control_types", False) else 1)
    return TrainConfig(
        model_name=args.model_name, learning_rate=args.learning_rate,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, noise_offset=args.noise_offset,
        snr_gamma=args.snr_gamma, n_sample_frames=args.n_sample_frames,
        output_fps=args.output_fps, num_inference_steps=args.num_inference_steps,
        vae_scaling_factor=0.13025 if args.model_name == "sdxl" else 0.18215,
        control_latent_size=min(64, args.height // 8), skip_conv_in=args.skip_conv_in,
        skip_time_emb=args.skip_time_emb, guess_mode=getattr(args, "guess_mode", False),
        num_experts=num_experts, train_router=num_experts > 1,
        fixed_controlnet_timestep=args.fixed_controlnet_timestep,
        latent_nan_checking=getattr(args, "latent_nan_checking", False),
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lr_scheduler=getattr(args, "lr_scheduler", "constant"),
        lr_warmup_steps=getattr(args, "lr_warmup_steps", 0),
        max_train_steps=args.max_train_steps,
        max_vae_encode=getattr(args, "max_vae_encode", None),
        gradient_checkpointing=getattr(args, "gradient_checkpointing", True))


def build_modules(args, num_experts, device, dtype):
    """(unet, [ControlNet per expert], adapter, vae, router or None) of
    ``args.model_name`` at the released architectures, the adapter from the
    flags, on ``device`` in ``dtype`` (the router in float32); weights as the
    constructors leave them."""
    kw = dict(device=device, dtype=dtype)
    temporal = args.model_name in ("i2vgenxl", "svd")
    adapter = ControlNetAdapter(
        backbone_model_name=args.model_name, num_blocks=args.num_blocks,
        num_adapters_per_location=args.num_adapters_per_location,
        cross_attention_dim=args.cross_attention_dim,
        adapter_locations=tuple(args.adapter_locations),
        add_spatial_resnet=args.add_spatial_resnet,
        add_temporal_resnet=args.add_temporal_resnet and temporal,
        add_spatial_transformer=args.add_spatial_transformer,
        add_temporal_transformer=args.add_temporal_transformer and temporal,
        num_repeats=args.num_repeats, out_channels=args.out_channels, **kw)
    nets = [ControlNetModel(**kw) for _ in range(num_experts)]
    if args.model_name == "svd":
        unet = UNetSpatioTemporalConditionModel(**kw)
        vae = AutoencoderKLTemporalDecoder(VAEConfig(scaling_factor=0.18215), **kw)
    elif args.model_name == "i2vgenxl":
        unet = I2VGenXLUNet(**kw)
        vae = AutoencoderKL(VAEConfig(scaling_factor=0.18215), **kw)
    else:
        unet = UNet2DConditionModel(SDXL_CONFIG, **kw)
        vae = AutoencoderKL(VAEConfig(scaling_factor=0.13025), **kw)
    router = None
    if num_experts > 1:
        embed = 2048 if args.model_name == "sdxl" else 1024
        dims = {"timestep_weights": _TIMESTEP_DIM, "embedding_weights": embed,
                "timestep_embedding_weights": _TIMESTEP_DIM + embed}
        router = ControlNetRouter(num_experts, args.router_type,
                                  embedding_dim=dims.get(args.router_type), device=device,
                                  dtype=torch.float32)
    return unet, nets, adapter, vae, router


def build_trainer(args, device, process_group=None) -> CtrlAdapterTrainer:
    """The trainer of ``args`` (``train.py:185-254``) on ``device``."""
    cfg = train_config(args)
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    unet, nets, adapter, vae, router = build_modules(args, cfg.num_experts, device, dtype)
    controlnet = MultiControlNetModel(nets) if len(nets) > 1 else nets[0]
    return CtrlAdapterTrainer(cfg, unet, controlnet, adapter, vae, router=router, device=device,
                              process_group=process_group)


@torch.no_grad()
def fabricate_frozen(trainer: CtrlAdapterTrainer, seed: int) -> None:
    """``--fake_weights``: every frozen tower's parameters (the UNet, the VAE,
    the ControlNets in order) drawn on the device from one generator of
    ``seed``, times ``FAKE_WEIGHT_SCALE``, in the towers' dtype."""
    g = torch.Generator(trainer.device).manual_seed(seed)
    for module in (trainer.unet, trainer.vae, *trainer.experts):
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=trainer.device)
                    * FAKE_WEIGHT_SCALE)


def load_frozen_real(args, trainer: CtrlAdapterTrainer) -> Dict[str, ControlNetModel]:
    """Load the frozen towers from diffusers folders (``train.py:67-107``):
    ``{--pretrained_model_path}/unet`` and ``/vae``, and ControlNet ``i`` from
    ``--controlnet_model_paths[i]``. Returns {control type: ControlNet}, the
    per-type towers of ``--mixed_control_types_training`` (else of
    ``--control_types``), resident on the device beside the experts."""
    if not args.pretrained_model_path:
        raise SystemExit("--pretrained_model_path required: a diffusers folder with unet/ and "
                         "vae/")
    for name in ("unet", "vae"):
        load_release(getattr(trainer, name), os.path.join(args.pretrained_model_path, name))
    n = trainer.config.num_experts
    paths = args.controlnet_model_paths or []
    types = list(args.mixed_control_types_training or []) or list(args.control_types)
    if len(paths) < n:
        raise SystemExit(f"need {n} --controlnet_model_paths (one per control type), got "
                         f"{len(paths)}")
    by_type = {}
    for i, path in enumerate(paths[:max(n, len(types))]):
        net = trainer.experts[i] if i < n else copy.deepcopy(trainer.experts[0])
        load_release(net, path)
        if i < len(types):
            by_type[types[i]] = net
    return by_type


def draw_expert_mask(rng: np.random.Generator, args, cfg: TrainConfig) -> np.ndarray:
    """1 to ``max_num_multi_source_train`` of the experts on."""
    mask = np.zeros((cfg.num_experts,), np.float32)
    on = rng.choice(cfg.num_experts, rng.integers(1, args.max_num_multi_source_train + 1),
                    replace=False)
    mask[on] = 1.0
    return mask


def synthetic_batch(rng: np.random.Generator, args, cfg: TrainConfig, b: int, f: int
                    ) -> Dict[str, np.ndarray]:
    """A global batch of ``b`` samples in the trainer's layouts, drawn from
    ``rng`` as the JAX CLI draws it (``train.py:389-415``), with the expert
    mask (1 to ``max_num_multi_source_train`` active) under several experts."""
    s8 = cfg.control_latent_size * 8
    batch = {
        "frames": rng.uniform(-1, 1, (b, f, args.height, args.width, 3)).astype(np.float32),
        "controlnet_cond": rng.uniform(0, 1, (cfg.num_experts, b * f, s8, s8, 3)
                                       ).astype(np.float32),
        "controlnet_text_emb": rng.standard_normal((b, 77, 768)).astype(np.float32) * 0.1,
    }
    if args.model_name == "sdxl":
        batch["prompt_embeds"] = rng.standard_normal((b, 77, 2048)).astype(np.float32) * 0.1
        batch["pooled_prompt_embeds"] = np.ones((b, 1280), np.float32) * 0.1
        batch["additional_time_ids"] = np.ones((b, 6), np.float32)
    else:
        batch["prompt_embeds"] = rng.standard_normal((b, 77, 1024)).astype(np.float32) * 0.1
        batch["image_embeddings"] = np.ones((b, 1, 1024), np.float32) * 0.1
    if cfg.num_experts > 1:
        batch["expert_mask"] = draw_expert_mask(rng, args, cfg)
    return batch


def step_inputs(args, cfg: TrainConfig, step: int, b: int, f: int, synthetic: bool = True):
    """(global synthetic batch, or only the expert mask under several experts
    when not ``synthetic``; sparse frame indices or None; seed of the noise
    draws) of ``step``, from numpy's generator of ``(--seed, step)``: the
    same in every process. Sparse frames: 1-4 of the ``f`` frames, sorted
    (``train.py:587-591``)."""
    rng = np.random.default_rng([args.seed, step])
    draw_seed = int(rng.integers(2 ** 62))
    if synthetic:
        batch = synthetic_batch(rng, args, cfg, b, f)
    else:
        batch = {"expert_mask": draw_expert_mask(rng, args, cfg)} if cfg.num_experts > 1 else {}
    sparse = None
    if args.apply_sparse_frame_mask:
        sparse = sorted(rng.choice(f, int(rng.integers(1, 5)), replace=False).tolist())
    return batch, sparse, draw_seed


def shard_step(mesh: parallel.Mesh, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This process's slice of a global batch: the samples (the conditions'
    second axis, b*f), the expert mask whole."""
    t = {k: torch.from_numpy(v) for k, v in raw.items()}
    whole = {k: t.pop(k) for k in ("expert_mask",) if k in t}
    cond = parallel.shard_batch(mesh, {"controlnet_cond": t.pop("controlnet_cond")}, axis=1)
    return {**parallel.shard_batch(mesh, t), **cond, **whole}


def build_real_data_pipeline(args, cfg: TrainConfig, b: int, f: int, device: torch.device,
                             seed: int):
    """The dataset path of ``train.py:109-183``: the dataset, its extractor on
    ``device`` (paths from ``CTRL_ADAPTER_ANNOTATORS``), the caption and
    first-frame encoders (``post_collate``, in the workers) and a
    ``Prefetcher`` of batches of ``b`` items, seeded with ``seed``."""
    from ctrl_adapter_tpu_torch.data.loader import ImageDataset, Prefetcher, VideoDataset
    from ctrl_adapter_tpu_torch.models.text_encoders import (
        CLIPImageEncoder, CLIPTextEncoder, build_controlnet_text_encoder)

    annotators = json.loads(os.environ.get("CTRL_ADAPTER_ANNOTATORS", "{}"))
    extractor = ConditionExtractor(local_model_paths=annotators, device=device)
    mixed = list(args.mixed_control_types_training or [])
    if args.model_name == "sdxl" or args.input_data_type == "images":
        dataset = ImageDataset(args.train_data_path, args.train_prompt_path, size=args.height,
                               control_size=cfg.control_latent_size * 8,
                               control_types=args.control_types, extractor=extractor)
    else:
        dataset = VideoDataset(args.train_data_path, args.train_prompt_path, n_sample_frames=f,
                               output_fps=args.output_fps, size=args.height,
                               control_types=args.control_types, extractor=extractor)
    path = args.pretrained_model_path
    cn_text = build_controlnet_text_encoder(path, args.controlnet_text_encoder_path,
                                            args.model_name, device=device)
    # SVD conditions on the CLIP image embedding only: its folder has no text tower
    text_enc = CLIPTextEncoder(path, device=device) if args.model_name != "svd" else None
    text_enc_2 = (CLIPTextEncoder(path, subfolder="text_encoder_2", with_projection=True,
                                  device=device) if args.model_name == "sdxl" else None)
    image_enc = (CLIPImageEncoder(path, device=device)
                 if args.model_name in ("i2vgenxl", "svd") else None)

    def post_collate(batch):
        captions = batch.pop("captions")
        first = batch.pop("first_frames")  # (b, h, w, 3) in [-1, 1]
        out = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in batch.items()}
        # the positive half of the [negative; positive] SD-v1.5 embedding
        out["controlnet_text_emb"] = cn_text(captions)[len(captions):]
        if args.model_name == "sdxl":
            h1, _ = text_enc.encode_with_pooled(captions)
            h2, pooled = text_enc_2.encode_with_pooled(captions)
            out["prompt_embeds"] = torch.cat([h1, h2], dim=-1)
            out["pooled_prompt_embeds"] = pooled
            out["additional_time_ids"] = torch.tensor(
                [[args.height, args.width, 0, 0, args.height, args.width]],
                dtype=torch.float32).repeat(len(captions), 1)
        else:
            if text_enc is not None:
                out["prompt_embeds"] = text_enc(captions)
            first_u8 = ((first + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
            out["image_embeddings"] = image_enc(list(first_u8))
        return out

    chooser = None
    if mixed and cfg.num_experts == 1:
        chooser = lambda rng: [rng.choice(mixed)]  # noqa: E731
    return Prefetcher(dataset, batch_size=b, num_workers=2, seed=seed,
                      control_types_chooser=chooser, post_collate=post_collate, device=device)


@torch.no_grad()
def run_validation(args, trainer: CtrlAdapterTrainer, step: int,
                   batch: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """One sample through the backbone's pipeline with the current adapter
    (``train.py:442-574``). With the step's real ``batch``: its first item's
    prompt, ControlNet and image embeddings (zero negatives), the VAE mean of
    its first frame and its conditions, at ``--num_inference_steps``, and a
    ``_concat.gif`` of conditions beside the video; without one the fixed
    pseudo-inputs of the synthetic path (zero embeddings and first-frame
    latent, conditions at 0.5) at 4 steps. Returns the gif (png for SDXL)
    under ``{DATA_PATH}/validation``."""
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline
    from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline
    from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

    cfg, dev = trainer.config, trainer.device
    f = 1 if args.model_name == "sdxl" else args.n_sample_frames
    s = cfg.control_latent_size
    lh, lw = args.height // trainer.latent_factor, args.width // trainer.latent_factor
    zeros = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    if batch is not None:
        batch = {k: v.to(dev) for k, v in batch.items()}
        pe_pos = batch["prompt_embeds"][:1] if "prompt_embeds" in batch else zeros(
            1, 77, args.cross_attention_dim)
        cn_pos = batch["controlnet_text_emb"][:1]
        prompt_embeds = torch.cat([torch.zeros_like(pe_pos), pe_pos])
        cn_embeds = torch.cat([torch.zeros_like(cn_pos), cn_pos])
        image_emb = batch["image_embeddings"][:1] if "image_embeddings" in batch else zeros(
            1, 1, 1024)
        first = batch["frames"][:1, 0].permute(0, 3, 1, 2)
        first_latent = trainer.vae.encode_moments(first)[0].float().permute(0, 2, 3, 1)
        cond = batch["controlnet_cond"][:, :f]
        steps = args.num_inference_steps
    else:
        prompt_embeds, cn_embeds = zeros(2, 77, args.cross_attention_dim), zeros(2, 77, 768)
        image_emb, first_latent = zeros(1, 1, 1024), zeros(1, lh, lw, 4)
        cond = torch.full((cfg.num_experts, f, s * 8, s * 8, 3), 0.5, device=dev)
        steps = 4
    common = dict(height=args.height, width=args.width, num_inference_steps=steps,
                  control_latent_size=s, generator=torch.Generator(dev).manual_seed(step))
    if args.model_name == "i2vgenxl":
        pipe = I2VGenXLControlNetAdapterPipeline(trainer.unet, trainer.controlnet,
                                                 trainer.adapter, trainer.vae,
                                                 router=trainer.router)
        video = pipe.generate(prompt_embeds, cn_embeds, image_emb, first_latent, cond,
                              num_frames=f, **common)
    elif args.model_name == "svd":
        pipe = SVDControlNetAdapterPipeline(trainer.unet, trainer.experts[0], trainer.adapter,
                                            trainer.vae)
        video = pipe.generate(image_emb, first_latent, cn_embeds, cond[0], num_frames=f,
                              skip_conv_in=cfg.skip_conv_in, **common)
    else:
        pipe = SDXLControlNetAdapterPipeline(trainer.unet, trainer.experts[0], trainer.adapter,
                                             trainer.vae)
        pooled = zeros(2, 1280)
        if batch is not None:
            pooled_pos = batch["pooled_prompt_embeds"][:1]
            pooled = torch.cat([torch.zeros_like(pooled_pos), pooled_pos])
        video = pipe.generate(prompt_embeds, pooled, cn_embeds, cond[0, :1], **common)[None]
    frames = list(video[0].float().cpu().numpy())
    out = os.path.join(args.DATA_PATH, "validation", f"step_{step}.gif")
    if len(frames) == 1:
        out = out.replace(".gif", ".png")
        save_png(frames[0], out)
    else:
        save_gif(frames, out, fps=args.output_fps)
        if batch is not None:
            cond_vis = [unit_to_uint8(c) for c in cond[0].float().cpu().numpy()]
            gen_vis = [unit_to_uint8(v) for v in frames]
            if cond_vis[0].shape != gen_vis[0].shape:
                cond_vis = [resize(c, gen_vis[0].shape[:2]) for c in cond_vis]
            save_concat_gif([cond_vis, gen_vis], out.replace(".gif", "_concat.gif"),
                            fps=args.output_fps)
    print(f"validation sample -> {out}", file=sys.stderr)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None) -> TrainRun:
    args = parse_args(argv)
    if not (args.synthetic_data or args.fake_weights):
        check_control_types(list(args.control_types)
                            + list(args.mixed_control_types_training or []),
                            json.loads(os.environ.get("CTRL_ADAPTER_ANNOTATORS", "{}")))
    device = resolve_device(device)
    if args.multihost and device.type == "cuda":
        device = torch.device("cuda", parallel.local_rank())
        torch.cuda.set_device(device)
    mesh = parallel.join(device) if args.multihost else parallel.Mesh()
    try:
        return _train(args, device, mesh)
    finally:
        parallel.leave(mesh)


def _train(args, device: torch.device, mesh: parallel.Mesh) -> TrainRun:
    lead = mesh.rank == 0
    if args.use_8bit_adam:
        print("8-bit Adam is a bitsandbytes feature the port does not have; using "
              "full-precision AdamW on fp32 masters", file=sys.stderr)
    if args.scale_lr:
        args.learning_rate *= mesh.world_size  # reference `train.py:688-689`

    t0 = time.perf_counter()
    trainer = build_trainer(args, device, mesh.group)
    cfg = trainer.config
    controlnet_by_type = {}
    if args.fake_weights:
        fabricate_frozen(trainer, args.seed)
    else:
        controlnet_by_type = load_frozen_real(args, trainer)
    init_trainable(trainer, torch.Generator(device).manual_seed(args.seed))
    first = 1
    if args.adapter_resume_path and args.adapter_resume_step is not None:
        restored = load_checkpoint(args.adapter_resume_path, args.adapter_resume_step,
                                   map_location=device)
        trainer.load_masters(restored["adapter"], restored.get("router"))
        if "optimizer" in restored and not args.disable_optimizer_restore:
            trainer.optimizer.load_state_dict(restored["optimizer"])
        first = args.adapter_resume_step + 1
        print(f"resumed adapter from {args.adapter_resume_path} @ step "
              f"{args.adapter_resume_step}", file=sys.stderr)
    parallel.replicate(mesh, trainer.optimizer.masters)
    trainer.optimizer.sync()
    _sync(device)
    build_s = time.perf_counter() - t0
    n_params = sum(m.numel() for m in trainer.optimizer.masters)
    print(f"trainable params: {n_params / 1e6:.1f}M over {mesh.world_size} process(es); "
          f"built in {build_s:.1f} s", file=sys.stderr)

    b = args.train_batch_size * mesh.world_size
    f = 1 if args.model_name == "sdxl" else args.n_sample_frames
    lh, lw = args.height // trainer.latent_factor, args.width // trainer.latent_factor
    log_path = os.path.join(args.DATA_PATH, "train_log.jsonl")
    if lead:
        os.makedirs(args.DATA_PATH, exist_ok=True)
    wandb_run = None
    if args.use_wandb and lead:
        try:
            import wandb

            wandb_run = wandb.init(project="ctrl-adapter-tpu",
                                   config={k: str(v) for k, v in vars(args).items()})
        except Exception as e:  # the card's host has no wandb
            print(f"wandb unavailable ({e}); falling back to JSONL log", file=sys.stderr)

    run = TrainRun(trainer, mesh, [], [], [], controlnet_by_type, [], build_s, [])
    prefetcher = None
    if not (args.synthetic_data or args.fake_weights):
        prefetcher = build_real_data_pipeline(args, cfg, args.train_batch_size, f, device,
                                              seed=args.seed + mesh.rank)
    try:
        if args.run_validation and args.run_validation_at_start and lead:
            run.validations.append(run_validation(args, trainer, 0))
        for step in range(first, args.max_train_steps + 1):
            t_step = time.perf_counter()
            raw, sparse, draw_seed = step_inputs(args, cfg, step, b, f,
                                                 synthetic=prefetcher is None)
            run.expert_masks.append(raw["expert_mask"].tolist() if "expert_mask" in raw else None)
            if prefetcher is None:
                batch = shard_step(mesh, raw)
            else:
                t_wait = time.perf_counter()
                batch = prefetcher.next()
                run.wait_s.append(time.perf_counter() - t_wait)
                ctypes = batch.pop("control_types", None)
                run.step_types.append(ctypes)
                if ctypes and run.controlnet_by_type:  # the batch type's resident tower
                    net = run.controlnet_by_type[ctypes[0]]
                    trainer.controlnet, trainer.experts = net, [net]
                if "expert_mask" in raw:
                    batch["expert_mask"] = torch.from_numpy(raw["expert_mask"])
            gen = torch.Generator(device).manual_seed(draw_seed)
            draws = parallel.shard_batch(mesh, trainer.draw(gen, b, f, lh, lw))
            lr = trainer.optimizer.lr_schedule(trainer.optimizer.update_count)
            t1 = time.perf_counter()
            metrics = trainer.train_step(batch, sparse, draws=draws)
            _sync(device)
            run.step_s.append(time.perf_counter() - t1)
            # the loss (and the router's weights) of this step, averaged over the processes
            logged = torch.cat([metrics["loss"].float().reshape(1)]
                               + ([metrics["down_block_weights"].float().reshape(-1)]
                                  if cfg.num_experts > 1 else []))
            if mesh.group is not None:
                parallel.all_reduce_mean_(logged, mesh.group)
            logged = logged.cpu()
            rec = {"step": step, "loss": float(logged[0]), "lr": lr,
                   "loss_time": time.perf_counter() - t_step}
            if cfg.num_experts > 1:
                rec["down_block_weights"] = logged[1:].reshape(
                    metrics["down_block_weights"].shape).tolist()
            run.records.append(rec)
            if not lead:
                continue
            with open(log_path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            if wandb_run is not None:
                wandb_run.log(rec, step=step)
            print(f"step {step}: loss={rec['loss']:.5f} ({rec['loss_time']:.2f}s)", file=sys.stderr)
            if args.run_validation and step % args.validate_every_steps == 0:
                run.validations.append(run_validation(
                    args, trainer, step, None if prefetcher is None else batch))
            if ((step % args.checkpointing_steps == 0 or step == args.max_train_steps)
                    and step >= args.save_starting_step):
                path = save_checkpoint(
                    args.DATA_PATH, step, trainer.adapter_state(), trainer.optimizer.state_dict(),
                    config={"model_name": args.model_name,
                            "adapter_locations": list(args.adapter_locations)},
                    router_state=trainer.router_state())
                run.checkpoints.append(path)
                print(f"checkpoint -> {path}", file=sys.stderr)

    finally:
        if prefetcher is not None:
            prefetcher.close()
    return run


if __name__ == "__main__":
    main()
