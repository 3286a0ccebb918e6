"""Milliseconds of the pipeline's decode per clip: CUDA events around
``_decode`` in the traced run's window (``modes/generate.py:TowerTimer``)."""


def read(record):
    times = record.get("tower_ms", {}).get("decode")
    return sum(times) / len(times) if times else None
