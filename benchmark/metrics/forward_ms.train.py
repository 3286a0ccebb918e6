"""Milliseconds of the training step's forward (the trainer's
``loss_and_weights``, checkpointed towers included) per step: CUDA events
around the call in the traced run's window."""


def read(record):
    times = record.get("step_ms", {}).get("forward")
    return sum(times) / len(times) if times else None
