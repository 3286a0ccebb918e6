"""Flags of the two CLIs: argparse defaults a ``--yaml_file`` may overwrite.

A copy of ``ctrl_adapter_tpu/config.py`` (the reference's ~45 flags of
``train.py:59-342`` and ``inference.py:21-172``, same names, types and
defaults), so that the port's CLIs parse to the same namespaces.

``load_yaml`` reads a config without PyYAML (the card's host has none): the
flat subset that ``configs/*.yaml`` uses, resolved as PyYAML's ``safe_load``
resolves it (YAML 1.1) so that both give the same dict. Anything outside the
subset raises ``ValueError`` with its line number; the reader never guesses.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict, List, Optional, Tuple


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


# PyYAML's implicit resolvers (``yaml/resolver.py``) for the forms of the
# subset, whole-string matches
_BOOL = {**dict.fromkeys(("true", "True", "TRUE"), True),
         **dict.fromkeys(("false", "False", "FALSE"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
# what PyYAML would read as a boolean, a number, a timestamp, a merge key or a
# value tag in forms outside the subset (yes/no/on/off, .inf and .nan,
# underscores, octal, hex, binary, base 60, dates)
_OUTSIDE = re.compile(r"""yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
    |[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?(?:0|[1-9][0-9_]*)|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?|<<|=""", re.X)
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?=\s|$)(.*)")
_ITEM = re.compile(r"( *)-(?=\s|$)(.*)")


def _fail(lineno: int, what: str):
    raise ValueError(f"line {lineno}: {what} (outside the YAML subset this reader takes)")


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """(the value of the quoted scalar that starts ``text``, what follows it);
    a quoted scalar holds no escape."""
    quote = text[0]
    end = text.find(quote, 1)
    if end < 0:
        _fail(lineno, "a quoted string not closed on its line")
    value, rest = text[1:end], text[end + 1:]
    if (quote == '"' and "\\" in value) or (quote == "'" and rest.startswith("'")):
        _fail(lineno, "an escape in a quoted string")
    return value, rest


def _resolve(plain: str, lineno: int):
    """A plain scalar as PyYAML's resolvers read it."""
    if plain in _NULL:
        return None
    if plain in _BOOL:
        return _BOOL[plain]
    if _INT.fullmatch(plain):
        return int(plain)
    if _FLOAT.fullmatch(plain):
        return float(plain)
    if _OUTSIDE.fullmatch(plain):
        _fail(lineno, f"the scalar {plain!r}")
    return plain


def _scalar(text: str, lineno: int):
    """One scalar (plain, single- or double-quoted) with an optional trailing
    comment; ``text`` has no leading space."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        if rest.strip() and not re.match(r"\s+#", rest):
            _fail(lineno, f"text after a quoted string: {rest.strip()!r}")
        return value
    plain = re.split(r"\s#", text, maxsplit=1)[0].rstrip()
    if plain[:1] and (plain[0] in "[]{},&*!|>%@`#" or plain[:2] in ("- ", "? ", ": ")
                      or plain in ("-", "?", ":")):
        _fail(lineno, f"the value {plain!r}")
    if ": " in plain or plain.endswith(":"):
        _fail(lineno, f"a nested mapping in {plain!r}")
    return _resolve(plain, lineno)


def _is_blank(line: str) -> bool:
    stripped = line.strip()
    return not stripped or stripped.startswith("#")


def parse_yaml(text: str) -> Dict[str, Any]:
    """The mapping of a YAML document in the subset of ``configs/*.yaml``:
    top-level ``key: scalar`` lines (null, ``true``/``false``, decimal ints,
    floats with a point, plain strings and quoted ones without escapes),
    ``key:`` followed by ``- item`` lines of scalars, the empty flow list
    ``[]``, full-line and trailing comments, and an anchor ``&name`` on a
    key's block list with aliases ``*name`` to it (the same object, as PyYAML
    gives). Values equal ``yaml.safe_load``'s."""
    lines = text.splitlines()
    out: Dict[str, Any] = {}
    anchors: Dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line, lineno = lines[i], i + 1
        i += 1
        if "\t" in line:
            _fail(lineno, "a tab")
        if _is_blank(line):
            continue
        m = _KEY.match(line)
        if not m:
            _fail(lineno, f"{line.strip()!r} is not a top-level 'key: value'")
        key, rest = m.group(1), m.group(2).strip()
        if key in out:
            _fail(lineno, f"the key {key!r} a second time")
        anchor = None
        a = re.match(r"&([A-Za-z0-9_-]+)(?=\s|$)\s*(.*)", rest)
        if a:
            anchor, rest = a.group(1), a.group(2)
        if not rest or rest.startswith("#"):
            items: List[Any] = []
            indent = None
            while i < len(lines) and (_is_blank(lines[i]) or _ITEM.match(lines[i])):
                if not _is_blank(lines[i]):
                    item = _ITEM.match(lines[i])
                    if indent is None:
                        indent = len(item.group(1))
                    elif len(item.group(1)) != indent:
                        _fail(i + 1, "list items at different indentations")
                    body = item.group(2).strip()
                    items.append(None if not body or body.startswith("#")
                                 else _scalar(body, i + 1))
                i += 1
            value = items if indent is not None else None
        elif anchor is not None:
            _fail(lineno, f"the anchor &{anchor} on a scalar")
        elif rest.startswith("*"):
            name = re.split(r"\s#", rest[1:], maxsplit=1)[0].rstrip()
            if name not in anchors:
                _fail(lineno, f"the alias *{name} of no anchor before it")
            value = anchors[name]
        elif re.fullmatch(r"\[\s*\](?:\s+#.*)?", rest):
            value = []
        else:
            value = _scalar(rest, lineno)
        if anchor is not None:
            anchors[anchor] = value
        out[key] = value
    return out


def load_yaml(path: str) -> Dict[str, Any]:
    """The config file ``path`` read by ``parse_yaml``."""
    with open(path) as f:
        text = f.read()
    try:
        return parse_yaml(text)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


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
