"""Device probe for kernel dispatch (counterpart of ``ops/backend.py:is_tpu_backend``).

The hand-written kernels target Hopper (``sm_90a``). A tensor decides where its
op runs: on a CUDA device of capability >= (9, 0) the kernel launches; on the CPU
the plain PyTorch version runs. Anything else is refused by the kernel wrappers.
Entry points run on the card unless their caller names another device
(``resolve_device``).
"""

from __future__ import annotations

import torch

# Bytes of shared memory one block may use on an H100 (of the SM's 256 KB).
SMEM_PER_BLOCK = 232448


_HOPPER = {}


def is_hopper(x: torch.Tensor) -> bool:
    """True when ``x`` lies on a CUDA device of compute capability >= (9, 0)."""
    if x.device.type != "cuda":
        return False
    if x.device not in _HOPPER:
        _HOPPER[x.device] = torch.cuda.get_device_capability(x.device) >= (9, 0)
    return _HOPPER[x.device]


_SMS = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (what the kernel plans fill)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def resolve_device(device=None) -> torch.device:
    """The CUDA card, or the device the caller names; no card and no name raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); the CPU "
                           "runs only when the caller passes device='cpu'")
    return torch.device("cuda")
