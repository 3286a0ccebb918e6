"""Milliseconds of the backbone UNet per denoising step (controlled and
UNet-only steps alike): CUDA events from its forward pre-hook to its forward
hook in the traced run's window."""


def read(record):
    times = record.get("tower_ms", {}).get("unet")
    return sum(times) / len(times) if times else None
