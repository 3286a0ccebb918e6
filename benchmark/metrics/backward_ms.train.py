"""Milliseconds per step from the end of the loss to the start of the
optimizer (``MasterOptimizer.step``): the backward with its recompute, and the
gradients' cast to fp32; CUDA events in the traced run's window."""


def read(record):
    times = record.get("step_ms", {}).get("backward")
    return sum(times) / len(times) if times else None
