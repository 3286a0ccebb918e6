"""The whole clip's share of the card's bf16 peak, in %: the model FLOPs of
the traced run's finished clips (``harness/flops.py``, counted on the
reference) over the window's time times 989 TFLOP/s."""


def read(record):
    flops = record.get("clip_flops")
    if not flops or record.get("window_s", 0) <= 0:
        return None
    return 100.0 * flops * record["clips"] / (record["window_s"] * record["peak_flops"])
