"""The run's environment: build and kernel caches at fixed paths inside the
checkout, libraries kept from loading JAX, and the check that JAX stayed out
of the process."""

from __future__ import annotations

import os
import sys

JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "ctrl_adapter_tpu")


def prepare(root: str) -> None:
    """Point the caches the program may use at ``build/`` in the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def started(t: float) -> float:
    """The run's start on ``time.perf_counter``'s clock, which on Linux is the
    host's monotonic clock, the same in every process: ``t`` in the process
    the run began with, which hands it to the ranks it launches."""
    return float(os.environ.setdefault("BENCHMARK_T_START", repr(t)))


def jax_loaded() -> list:
    """Top-level names among ``sys.modules`` that are JAX or the JAX package,
    compared whole (``ctrl_adapter_tpu_torch`` is not ``ctrl_adapter_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(JAX_MODULES))
