"""Weights on disk in the diffusers layout, read and written without the
``safetensors`` package.

Counterpart of the JAX package's release loaders
(``ctrl_adapter_tpu/train/checkpoints.py:load_torch_release``,
``convert/convert_checkpoints.py:_find_weights``,
``models/text_encoders.py:_load_tower``). A release folder holds
``config.json`` beside its weights; the weights are looked up in this order:

1. ``diffusion_pytorch_model.safetensors``, ``model.safetensors``,
   ``model.fp16.safetensors``;
2. a sharded ``diffusion_pytorch_model.safetensors.index.json`` or
   ``model.safetensors.index.json`` (its ``weight_map`` names the shards);
3. ``diffusion_pytorch_model.bin``, read with ``torch.load(weights_only=True)``.

The safetensors format is simple enough to read and write by hand: an 8-byte
little-endian header length N, N bytes of JSON (``{name: {"dtype", "shape",
"data_offsets": [begin, end]}}`` with offsets relative to the end of the
header, and an optional ``__metadata__`` entry of strings), then the raw
little-endian buffers. The writer pads the header with spaces to a multiple of
8 bytes, as the package does. Modules are built by the caller at fixed
configs and loaded strictly by their diffusers names; stored fp32 or fp16
tensors are cast to the module's parameter dtypes (one rounding, as flax's
compute dtype gives).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import torch

WEIGHTS_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "model.fp16.safetensors")
INDEX_NAMES = ("diffusion_pytorch_model.safetensors.index.json",
               "model.safetensors.index.json")
BIN_NAME = "diffusion_pytorch_model.bin"
CONFIG_NAME = "config.json"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a ``.safetensors`` file, in the stored dtypes."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        header.pop("__metadata__", None)
        size = max((v["data_offsets"][1] for v in header.values()), default=0)
        buf = bytearray(size)
        view, got = memoryview(buf), 0
        while got < size:  # one read() returns at most ~2 GiB
            n = fh.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: file shorter than its header says")
            got += n
    out = {}
    for name, entry in header.items():
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {entry['dtype']}")
        dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = end - begin
        if count != itemsize * int(torch.Size(shape).numel()):
            raise ValueError(f"{path}: {name} spans {count} bytes for shape {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        # a buffer that is not aligned to its element size is copied first
        src = buf if begin % itemsize == 0 else bytearray(buf[begin:end])
        offset = begin if src is buf else 0
        out[name] = torch.frombuffer(src, dtype=dtype, count=count // itemsize,
                                     offset=offset).reshape(shape)
    return out


def write_safetensors(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``state_dict`` as a ``.safetensors`` file (tensors in name order)."""
    header, tensors, offset = {}, [], 0
    for name in sorted(state_dict):
        t = state_dict[name].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        tensors.append(t)
        offset += nbytes
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for t in tensors:
            if t.numel():
                fh.write(t.reshape(-1).view(torch.uint8).numpy().data)


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """The state dict stored in the release folder ``path`` (lookup order in the
    module docstring)."""
    for name in WEIGHTS_NAMES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            return read_safetensors(p)
    for name in INDEX_NAMES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            with open(p) as fh:
                shards = sorted(set(json.load(fh)["weight_map"].values()))
            out: Dict[str, torch.Tensor] = {}
            for shard in shards:
                out.update(read_safetensors(os.path.join(path, shard)))
            return out
    p = os.path.join(path, BIN_NAME)
    if os.path.exists(p):
        return torch.load(p, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights under {path} (looked for {', '.join(WEIGHTS_NAMES)}, "
                            f"{', '.join(INDEX_NAMES)}, {BIN_NAME})")


def read_config(path: str) -> dict:
    """``config.json`` of the release folder ``path``, or {} when there is none."""
    p = os.path.join(path, CONFIG_NAME)
    if not os.path.exists(p):
        return {}
    with open(p) as fh:
        return json.load(fh)


def load_release(module: torch.nn.Module, path: str) -> dict:
    """Load the weights of the release folder ``path`` into ``module`` by their
    diffusers names (``load_state_dict``, strict: a missing or an unexpected
    key, or a wrong shape, raises), each cast to the dtype of the module's
    tensor of that name. Returns the folder's config."""
    state = read_weights(path)
    own = module.state_dict()
    for name, t in state.items():
        if name in own:
            if tuple(t.shape) != tuple(own[name].shape):
                raise RuntimeError(f"{path}: {name} has shape {tuple(t.shape)}, the module "
                                   f"expects {tuple(own[name].shape)}")
            state[name] = t.to(own[name].dtype)
    module.load_state_dict(state, strict=True)
    return read_config(path)


def save_release(state_dict: Mapping[str, torch.Tensor], path: str,
                 config: Optional[dict] = None) -> None:
    """Write ``state_dict`` into the release folder ``path`` as
    ``diffusion_pytorch_model.safetensors`` (and ``config.json`` when given)."""
    os.makedirs(path, exist_ok=True)
    write_safetensors(state_dict, os.path.join(path, WEIGHTS_NAMES[0]))
    if config is not None:
        with open(os.path.join(path, CONFIG_NAME), "w") as fh:
            json.dump(config, fh, indent=2)
