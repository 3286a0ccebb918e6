"""Ctrl-Adapter inference CLI of the PyTorch port (SVD, I2VGen-XL, SDXL) on an H100.

The port's counterpart of ``inference.py``, with the same flags
(``ctrl_adapter_tpu_torch/config.py:add_inference_args`` plus ``--fake_weights``,
``--max_samples``, ``--lora`` and ``--lora_scale``): per sample it reads the
frames and their condition frames (read or extracted), encodes the prompt and the
first frame, generates, and writes ``output.gif`` and ``output_concat.gif``
(``output.png`` for SDXL), ``metrics.json`` under ``--evaluate``, and a final
``{"status": "ok", "output": ...}`` line.

Weights:
- ``--fake_weights``: every tower filled from seeded numpy at scale 0.02, in
  bf16; the prompt and image embeddings are pseudo-embeddings and the
  conditioning image latent is zero, as in the JAX CLI;
- otherwise diffusers-layout folders, loaded strictly by name
  (``convert/release.py``): ``{--pretrained_model_path}/unet`` and ``/vae``
  (the JAX CLI reads orbax directories there instead), ``image_encoder/`` and
  ``feature_extractor/`` (I2VGen-XL, SVD), ``text_encoder/`` and
  ``tokenizer/`` (I2VGen-XL, SDXL; SDXL also ``text_encoder_2/``), one
  ``--controlnet_model_paths`` folder per control type,
  ``--adapter_checkpoint_path``, ``--router_checkpoint_path`` (multi-condition
  I2VGen-XL) and ``--controlnet_text_encoder_path`` (SD-v1.5's
  ``text_encoder/`` + ``tokenizer/``).

The towers run in bf16 and the encoders in fp32 on the CUDA card; ``main``
raises when there is none unless its caller passes ``device="cpu"``. Condition
frames are read from ``{input_root}/{control_type}/{sample}/*.png``; with
``--extract_control_conditions``, or where that folder is missing, they are
extracted from the frames on the same device (``conditions/extractors.py``:
depth from ``Intel/dpt-large``, segmentation from
``nvidia/segformer-b5-finetuned-ade-640-640``, both folders read relative to
the working directory; canny and shuffle need none). softedge, scribble,
lineart, normal and openpose need a checkpoint path, which this CLI does not
take (the JAX CLI passes none either): their extraction raises
``RuntimeError`` before any tower is built.

    python inference_torch.py --model_name svd --control_types depth --fake_weights \\
        --evaluation_input_folder FRAMES_DIR --num_inference_steps 4 --n_sample_frames 14
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ctrl_adapter_tpu_torch.conditions.extractors import (
    MULTI_CONDITION_EXPERT_ORDER, ConditionExtractor, check_control_types)
from ctrl_adapter_tpu_torch.config import add_inference_args
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
from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline
from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline
from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline
from ctrl_adapter_tpu_torch.utils.image import (
    image_to_unit, load_image, resize, save_concat_gif, save_gif, save_png, unit_to_uint8,
)

CROSS_DIM = {"i2vgenxl": 1024, "svd": 1024, "sdxl": 2048}
ADAPTER_LOCATIONS = {"i2vgenxl": ("A", "B", "C", "D", "M"),
                     "svd": ("A", "B", "C", "D", "M"),
                     "sdxl": ("A", "B", "C")}


@dataclasses.dataclass
class InferenceRun:
    """What ``main`` did: the pipeline and encoders it ran, the videos per sample
    ((1, f, H, W, 3) in [0, 1]), the output folder, and its timings (seconds to
    build and load the towers and encoders; per sample, ms of the encoders and
    seconds of ``generate``)."""

    pipe: object
    encoders: Optional[Dict[str, object]]
    out_root: str
    videos: Dict[str, np.ndarray]
    load_s: float
    encode_ms: Dict[str, float]
    generate_s: Dict[str, float]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_modules(args, device, dtype=torch.bfloat16):
    """The pipeline of ``args.model_name`` at the released architectures, on
    ``device`` in ``dtype`` (weights uninitialised)."""
    kw = dict(device=device, dtype=dtype)
    temporal = args.model_name in ("i2vgenxl", "svd")
    adapter = ControlNetAdapter(
        backbone_model_name=args.model_name, num_blocks=1,
        cross_attention_dim=CROSS_DIM[args.model_name],
        adapter_locations=ADAPTER_LOCATIONS[args.model_name],
        add_spatial_resnet=True, add_temporal_resnet=temporal,
        add_spatial_transformer=True, add_temporal_transformer=temporal, **kw)
    if args.model_name == "svd":
        vae = AutoencoderKLTemporalDecoder(VAEConfig(scaling_factor=0.18215), **kw)
    else:
        vae = AutoencoderKL(VAEConfig(
            scaling_factor=0.13025 if args.model_name == "sdxl" else 0.18215), **kw)
    if args.model_name == "sdxl":
        pipe = SDXLControlNetAdapterPipeline(UNet2DConditionModel(SDXL_CONFIG, **kw),
                                             ControlNetModel(**kw), adapter, vae)
    elif args.model_name == "i2vgenxl":
        cnets = MultiControlNetModel([ControlNetModel(**kw) for _ in args.control_types])
        router = None
        if len(args.control_types) > 1:
            router = ControlNetRouter(num_experts=len(MULTI_CONDITION_EXPERT_ORDER),
                                      device=device, dtype=torch.float32)
        pipe = I2VGenXLControlNetAdapterPipeline(I2VGenXLUNet(**kw), cnets, adapter, vae,
                                                 router=router)
    else:
        pipe = SVDControlNetAdapterPipeline(UNetSpatioTemporalConditionModel(**kw),
                                            ControlNetModel(**kw), adapter, vae)
    for module in towers(pipe).values():
        module.eval().requires_grad_(False)
    return pipe


def towers(pipe) -> Dict[str, torch.nn.Module]:
    """{name: module} of the pipeline's towers (``controlnet`` is a
    ``MultiControlNetModel`` for I2VGen-XL)."""
    names = ("unet", "controlnet", "adapter", "vae", "router")
    return {n: getattr(pipe, n) for n in names if getattr(pipe, n, None) is not None}


@torch.no_grad()
def fabricate_params(pipe, scale: float = 0.02) -> None:
    """``--fake_weights``: every parameter drawn from seeded numpy (a fresh
    ``default_rng`` per tower, seed e for ControlNet expert e, else 0), times
    ``scale``, rounded to bf16, in the module's dtype."""
    def fill(module, seed):
        rng = np.random.default_rng(seed)
        for p in module.parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape), dtype=np.float32) * scale)
            p.copy_(draw.to(torch.bfloat16))

    for name, module in towers(pipe).items():
        if isinstance(module, MultiControlNetModel):
            for e, net in enumerate(module.nets):
                fill(net, e)
        else:
            fill(module, 0)


def load_params(args, pipe) -> None:
    """Load the towers from diffusers-layout folders (see the module docstring)."""
    if not args.pretrained_model_path:
        raise SystemExit("--pretrained_model_path required (diffusers folder with unet/ "
                         "and vae/)")
    if not args.adapter_checkpoint_path:
        raise SystemExit("--adapter_checkpoint_path required (the released adapter folder)")
    load_release(pipe.adapter, args.adapter_checkpoint_path)
    if getattr(pipe, "router", None) is not None:
        if not args.router_checkpoint_path:
            raise SystemExit("--router_checkpoint_path required for multi-condition inference")
        load_release(pipe.router, args.router_checkpoint_path)
    for name in ("unet", "vae"):
        load_release(getattr(pipe, name), os.path.join(args.pretrained_model_path, name))
    nets = (list(pipe.controlnet.nets) if isinstance(pipe.controlnet, MultiControlNetModel)
            else [pipe.controlnet])
    paths = args.controlnet_model_paths or []
    if len(paths) != len(nets):
        raise SystemExit(f"--controlnet_model_paths: {len(paths)} folders for {len(nets)} "
                         f"ControlNets (one per control type)")
    for net, path in zip(nets, paths):
        load_release(net, path)


def build_encoders(args, device) -> Dict[str, object]:
    """The prompt and image encoders of the real-weights path, in fp32 on
    ``device``. SVD's backbone has no text tower and gets none."""
    from ctrl_adapter_tpu_torch.models.text_encoders import (
        CLIPImageEncoder, CLIPTextEncoder, build_controlnet_text_encoder)

    path = args.pretrained_model_path
    encoders = {"controlnet": build_controlnet_text_encoder(
        path, args.controlnet_text_encoder_path, args.model_name, device=device)}
    if args.model_name == "sdxl":
        # CLIP-L and OpenCLIP-bigG: penultimate hiddens concatenated (2048),
        # pooled bigG -> add_text_embeds; both read tokenizer/, as the JAX CLI does
        encoders["text"] = CLIPTextEncoder(path, device=device)
        encoders["text_2"] = CLIPTextEncoder(path, subfolder="text_encoder_2",
                                             with_projection=True, device=device)
    elif args.model_name == "i2vgenxl":
        # the reference I2VGen-XL pipeline encodes prompts with clip_skip=1
        encoders["text"] = CLIPTextEncoder(path, clip_skip=1, device=device)
    if args.model_name in ("i2vgenxl", "svd"):
        encoders["image"] = CLIPImageEncoder(path, device=device)
    return encoders


def extracted_types(args, input_root, samples):
    """The control types ``load_conditions`` will extract for ``samples``."""
    return [c for c in args.control_types
            if args.extract_control_conditions
            or any(not os.path.isdir(os.path.join(input_root, c, s)) for s in samples)]


def load_conditions(args, input_root, sample_name, frames, extractor=None):
    """Pre-extracted condition frames in the reference fixture layout
    ``{input_root}/{control_type}/{sample}/*.png``, or, with
    ``--extract_control_conditions`` or no such folder, ``extractor``'s maps
    of ``frames`` (a ``ConditionExtractor`` on the card when None) ->
    (E, f, 512, 512, 3) in [0, 1]."""
    conds = []
    for ctype in args.control_types:
        cdir = os.path.join(input_root, ctype, sample_name)
        if os.path.isdir(cdir) and not args.extract_control_conditions:
            files = sorted(
                fn for fn in os.listdir(cdir)
                if fn.lower().endswith((".png", ".jpg", ".jpeg"))
            )[: len(frames)]
            maps = [load_image(os.path.join(cdir, fn), (512, 512)) for fn in files]
            while len(maps) < len(frames):
                maps.append(maps[-1])
        else:
            extractor = extractor or ConditionExtractor()
            maps = extractor.extract(ctype, frames)
        conds.append(np.stack([image_to_unit(m) for m in maps]))
    return np.stack(conds)  # (E, f, 512, 512, 3)


def _scalar(v):
    """One value of a per-expert flag (nargs="+") for the single-expert backbones."""
    return float(v[0]) if isinstance(v, (list, tuple)) else float(v)


def main(argv=None, device=None) -> InferenceRun:
    parser = argparse.ArgumentParser()
    add_inference_args(parser)
    parser.add_argument("--fake_weights", action="store_true",
                        help="random params at real architecture (no checkpoints needed)")
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--lora", type=str, default=None,
                        help="LoRA checkpoint folded into the backbone UNet")
    parser.add_argument("--lora_scale", type=float, default=1.0)
    args = parser.parse_args(argv)
    device = resolve_device(device)

    # evaluation set: {root}/raw_input/{sample}/*.png with sibling
    # {root}/{control_type}/{sample}/ condition folders
    input_root = args.evaluation_input_folder
    raw_root = os.path.join(input_root, "raw_input")
    if not os.path.isdir(raw_root):
        raw_root = input_root
    samples = sorted(
        d for d in os.listdir(raw_root) if os.path.isdir(os.path.join(raw_root, d))
    ) or [""]
    if args.max_samples:
        samples = samples[: args.max_samples]
    check_control_types(extracted_types(args, input_root, samples))
    extractor = ConditionExtractor(device=device)

    t0 = time.perf_counter()
    pipe = build_modules(args, device)
    if args.fake_weights:
        fabricate_params(pipe)
    else:
        load_params(args, pipe)
    if args.lora:
        from ctrl_adapter_tpu_torch.convert.lora import apply_lora, load_lora_file

        state = pipe.unet.state_dict()
        n = apply_lora(state, load_lora_file(args.lora), scale=args.lora_scale)
        pipe.unet.load_state_dict(state)
        print(f"merged LoRA deltas into {n} UNet modules from {args.lora}", file=sys.stderr)
    encoders = None if args.fake_weights else build_encoders(args, device)
    _sync(device)
    load_s = time.perf_counter() - t0

    # with fake weights, fixed pseudo-embeddings keep the CLI hermetic
    f = 1 if args.model_name == "sdxl" else args.n_sample_frames
    rng_np = np.random.default_rng(args.seed)

    def pseudo_text(n, dim):
        return torch.from_numpy(rng_np.standard_normal((n, 77, dim)).astype(np.float32) * 0.1)

    captions = {}
    cap_path = os.path.join(args.evaluation_input_folder, args.evaluation_prompt_file)
    if os.path.exists(cap_path):
        with open(cap_path) as fh:
            captions = {os.path.splitext(k)[0]: v for k, v in json.load(fh).items()}

    out_root = os.path.join(
        args.evaluation_output_folder, args.model_name, "_".join(args.control_types))
    os.makedirs(out_root, exist_ok=True)

    run = InferenceRun(pipe, encoders, out_root, {}, load_s, {}, {})
    for sample_name in samples:
        frame_dir = os.path.join(raw_root, sample_name)
        frame_files = sorted(
            fn for fn in os.listdir(frame_dir)
            if fn.lower().endswith((".png", ".jpg", ".jpeg"))
        )[:f]
        if not frame_files:
            print(f"skip {sample_name}: no frames", file=sys.stderr)
            continue
        frames = [load_image(os.path.join(frame_dir, fn), (512, 512)) for fn in frame_files]
        while len(frames) < f:
            frames.append(frames[-1])
        conds = load_conditions(args, input_root, sample_name, frames,
                                extractor)  # (E, f, 512, 512, 3)
        # SDXL's ControlNet features sit at half the backbone latent size (the
        # adapter upsamples x2); the video backbones share the 64x64 latent grid
        if args.use_size_512:
            ctrl_latent = (min(64, args.height // 16) if args.model_name == "sdxl"
                           else min(64, args.height // 8))
            cond_hw = (ctrl_latent * 8, ctrl_latent * 8)
        elif args.model_name == "sdxl":
            ctrl_latent = (args.height // 16, args.width // 16)
            cond_hw = (args.height // 2, args.width // 2)
        else:
            # use_size_512=False: the condition stays at the sample's own size and
            # the ControlNet consumes the latents unpooled
            ctrl_latent = (args.height // 8, args.width // 8)
            cond_hw = (args.height, args.width)
        if tuple(conds.shape[2:4]) != cond_hw:
            conds = np.stack([np.stack([resize(fr, cond_hw) for fr in c]) for c in conds])

        prompt = captions.get(sample_name, "")
        t_enc = time.perf_counter()

        def cn_embeds():
            if encoders is not None:
                return encoders["controlnet"]([prompt], [args.negative_prompt])
            return pseudo_text(2, 768)

        def backbone_text(dim):
            if encoders is not None and args.model_name == "i2vgenxl":
                return torch.cat([encoders["text"]([args.negative_prompt]),
                                  encoders["text"]([prompt])])
            return pseudo_text(2, dim)

        def sdxl_text():
            """(prompt_embeds (2, 77, 2048) [neg; pos], add_text_embeds (2, 1280))."""
            if encoders is None:
                return pseudo_text(2, 2048), torch.ones((2, 1280)) * 0.1
            embs, pools = [], []
            for text in (args.negative_prompt, prompt):  # [neg; pos]
                h1, _ = encoders["text"].encode_with_pooled([text])
                h2, pool2 = encoders["text_2"].encode_with_pooled([text])
                embs.append(torch.cat([h1, h2], dim=-1))
                pools.append(pool2)
            return torch.cat(embs), torch.cat(pools)

        def image_embeds():
            if encoders is not None:
                # SVD preprocesses with the antialiased resize path
                return encoders["image"]([frames[0]], antialiased=args.model_name == "svd")
            return torch.ones((1, 1, 1024)) * 0.1

        def conditioning_image_latent():
            """The VAE latent of the first frame: a sample for I2VGen-XL, the
            noise-augmented mode for SVD; zero with fake weights."""
            shape = (1, args.height // 8, args.width // 8, 4)
            if args.fake_weights:
                return torch.zeros(shape)
            from ctrl_adapter_tpu_torch.pipelines.image_latents import (
                encode_first_frame_latent, encode_svd_image_latent)

            img = frames[0]
            if img.shape[:2] != (args.height, args.width):
                img = resize(img, (args.height, args.width))
            unit = torch.from_numpy(image_to_unit(img))
            if args.model_name == "svd":
                return encode_svd_image_latent(pipe.vae, unit, generator=latent_gen,
                                               noise_aug_strength=args.noise_aug_strength)
            return encode_first_frame_latent(pipe.vae, unit, generator=latent_gen)

        # the latents and the image-latent noise come from two generators of the seed
        gen = torch.Generator(device).manual_seed(args.seed)
        latent_gen = torch.Generator(device).manual_seed(args.seed + 1)
        common = dict(
            height=args.height, width=args.width,
            num_inference_steps=args.num_inference_steps,
            guess_mode=args.guess_mode, control_latent_size=ctrl_latent, generator=gen)
        if args.model_name == "sdxl":
            sdxl_prompt_embeds, sdxl_pooled = sdxl_text()
            inputs = dict(
                prompt_embeds=sdxl_prompt_embeds, add_text_embeds=sdxl_pooled,
                controlnet_prompt_embeds=cn_embeds(),
                control_image=torch.from_numpy(conds[0]),
                guidance_scale=args.guidance_scale,
                controlnet_conditioning_scale=_scalar(args.controlnet_conditioning_scale),
                control_guidance_start=_scalar(args.control_guidance_start),
                control_guidance_end=_scalar(args.control_guidance_end))
        elif args.model_name == "i2vgenxl":
            inputs = dict(
                prompt_embeds=backbone_text(1024), controlnet_prompt_embeds=cn_embeds(),
                image_embeddings=image_embeds(),
                first_frame_latent=conditioning_image_latent(),
                control_images=torch.from_numpy(
                    conds.reshape(conds.shape[0], -1, *conds.shape[2:])),
                num_frames=f, guidance_scale=args.guidance_scale,
                controlnet_conditioning_scale=args.controlnet_conditioning_scale,
                control_guidance_start=args.control_guidance_start,
                control_guidance_end=args.control_guidance_end,
                sparse_frames=args.sparse_frames,
                inference_expert_masks=args.inference_expert_masks,
                skip_conv_in=args.skip_conv_in)
        else:
            inputs = dict(
                image_embeddings=image_embeds(), image_latent=conditioning_image_latent(),
                controlnet_prompt_embeds=cn_embeds(),
                control_images=torch.from_numpy(conds[0]), num_frames=f,
                controlnet_conditioning_scale=_scalar(args.controlnet_conditioning_scale),
                control_guidance_start=_scalar(args.control_guidance_start),
                control_guidance_end=_scalar(args.control_guidance_end),
                sparse_frames=args.sparse_frames, skip_conv_in=args.skip_conv_in)
        _sync(device)
        run.encode_ms[sample_name] = 1000 * (time.perf_counter() - t_enc)
        t0 = time.perf_counter()
        video = pipe.generate(**inputs, **common).float().cpu().numpy()
        if args.model_name == "sdxl":
            video = video[None]  # (1, 1, h, w, 3)
        dt = time.perf_counter() - t0
        run.generate_s[sample_name] = dt
        run.videos[sample_name] = video
        print(f"{sample_name or 'sample'}: {video.shape} in {dt:.1f}s", file=sys.stderr)

        out_dir = os.path.join(out_root, sample_name or "sample")
        os.makedirs(out_dir, exist_ok=True)
        vid = video[0]
        if vid.shape[0] == 1:
            save_png(vid[0], os.path.join(out_dir, "output.png"))
        else:
            save_gif(list(vid), os.path.join(out_dir, "output.gif"), fps=args.output_fps)
            cond_vis = [unit_to_uint8(c) for c in conds[0][: vid.shape[0]]]
            gen_vis = [unit_to_uint8(v) for v in vid]
            if cond_vis[0].shape != gen_vis[0].shape:
                cond_vis = [resize(c, gen_vis[0].shape[:2]) for c in cond_vis]
            save_concat_gif([cond_vis, gen_vis],
                            os.path.join(out_dir, "output_concat.gif"), fps=args.output_fps)

        if args.evaluate:
            from ctrl_adapter_tpu_torch.evaluation.metrics import evaluate_video

            cond_uint8 = np.stack([unit_to_uint8(c) for c in conds[0][: vid.shape[0]]])
            if cond_uint8.shape[1:3] != vid.shape[1:3]:
                # nearest: bilinear would soften edge and segment maps
                cond_uint8 = np.stack([resize(c, vid.shape[1:3], "nearest")
                                       for c in cond_uint8])
            metrics = evaluate_video(np.asarray(vid, np.float32), cond_uint8,
                                     control_type=args.control_types[0])
            with open(os.path.join(out_dir, "metrics.json"), "w") as fh:
                json.dump({"sample": sample_name or "sample",
                           "control_type": args.control_types[0], **metrics}, fh)
            print(f"metrics[{sample_name or 'sample'}]: {metrics}", file=sys.stderr)

    print(json.dumps({"status": "ok", "output": out_root}))
    return run


if __name__ == "__main__":
    main()
