"""Device probe for kernel dispatch (counterpart of ``ops/backend.py:is_tpu_backend``).

The hand-written kernels target Hopper (``sm_90a``). A tensor decides where its
op runs: on a CUDA device of capability >= (9, 0) the kernel launches; on the CPU
the plain PyTorch version runs. Anything else is refused by the kernel wrappers.
"""

from __future__ import annotations

import torch


def is_hopper(x: torch.Tensor) -> bool:
    """True when ``x`` lies on a CUDA device of compute capability >= (9, 0)."""
    if x.device.type != "cuda":
        return False
    return torch.cuda.get_device_capability(x.device) >= (9, 0)
