"""Weight bridge: a JAX (flax) parameter tree of numpy arrays -> a port ``state_dict``.

The key map is built forward from the port module's own ``named_parameters()``
with the naming rule of the JAX package's converter
(``ctrl_adapter_tpu/convert/torch_to_jax.py``): numeric path segments merge
into their parent (``down_blocks.0`` -> ``down_blocks_0``), a 1-D ``weight`` is
a norm ``scale``, any other ``weight`` is a ``kernel``. Layouts go back to
torch's:

- ``kernel`` (in, out)                 -> ``weight`` (out, in)
- ``kernel`` (kh, kw, in, out)         -> ``weight`` (out, in, kh, kw)
- ``kernel`` (kd, kh, kw, in, out)     -> ``weight`` (out, in, kd, kh, kw)
- ``scale``                            -> ``weight``

The rule covers every name of the port: the SDXL slice's Linear
``proj_in``/``proj_out`` and ``add_embedding`` are (in, out) kernels,
``processor.to_k_ip.0`` is ``processor/to_k_ip_0``,
``encoder_hid_proj.image_projection_layers.0.norm`` a LayerNorm's
``scale``/``bias``, ``zero_convs.3`` the 1x1 conv ``zero_convs_3``.

The bridge is strict: every port parameter is filled and every JAX leaf is used
exactly once, or it raises. ``dtype`` overrides the module's dtypes, e.g.
float32 for a trainer's master weights (``CtrlAdapterTrainer.load_masters``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def jax_path(torch_key: str, ndim: int) -> Tuple[str, ...]:
    """The flax tree path of the port parameter ``torch_key`` of rank ``ndim``."""
    *parts, leaf = torch_key.split(".")
    merged = []
    for p in parts:
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    return (*merged, leaf)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def state_dict_from_jax(module: torch.nn.Module, params: Mapping,
                        dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (with or without the ``{"params": ...}`` wrapper)
    onto ``module`` and return its state dict, in the module's dtypes or in
    ``dtype``."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    used = set()
    out: Dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        path = jax_path(name, p.dim())
        if path not in flat:
            raise KeyError(f"no JAX leaf {'/'.join(path)} for port parameter {name}")
        arr = flat[path]
        if path[-1] == "kernel":
            if arr.ndim not in _TO_TORCH:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            arr = arr.transpose(_TO_TORCH[arr.ndim])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX {'/'.join(path)} has shape {arr.shape}, "
                             f"port expects {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype or p.dtype)
        used.add(path)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} JAX leaves have no port parameter: {unused[:10]}")
    return out


def load_from_jax(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a flax param tree into ``module`` in place (strict); returns it."""
    module.load_state_dict(state_dict_from_jax(module, params), strict=True)
    return module
