"""Tracing and step timing over ``torch.profiler``.

Counterpart of ``ctrl_adapter_tpu/utils/profiling.py``:

- ``trace(log_dir)``: ``with trace(dir): run()`` profiles the host and, where
  there is a card, the device, and writes ``dir/trace.json``, a Chrome trace
  (Perfetto, ``chrome://tracing``);
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``);
- ``StepTimer``: host-clock step times; ``block_and_stop(result)`` waits for
  the devices of the result's tensors first; ``stats()`` gives the mean,
  p50, p95, min and count, as the JAX class;
- ``device_memory_stats()``: ``bytes_in_use`` and ``peak_bytes_in_use`` per
  CUDA device from ``torch.cuda.memory_stats``, and ``{}`` without one (the
  JAX function's result where no device reports its memory).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

annotate = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CUDA device too, where there is one) and write
    ``log_dir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(result) -> None:
    """Wait for every CUDA device holding a tensor of ``result`` (nested
    lists, tuples and dicts walked)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(result)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Host-clock step times: ``with timer:`` times a block;
    ``block_and_stop(result)`` ends the step begun at ``__enter__`` once the
    result's devices are done."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def block_and_stop(self, result):
        _sync(result)
        self.times.append(time.perf_counter() - self._t0)
        return result

    def stats(self) -> Dict[str, float]:
        arr = np.asarray(self.times)
        if arr.size == 0:
            return {}
        return {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)), "min_s": float(arr.min()),
                "steps": int(arr.size)}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} of PyTorch's
    allocator on each CUDA device; {} without one."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0))}
    return out
