"""The training steps' share of the card's bf16 peak, in %: the model FLOPs
of the traced run's finished steps (``harness/flops.py``: the reference's
forward and backward, no recompute) over the window's time times 989 TFLOP/s."""


def read(record):
    flops = record.get("step_flops")
    if not flops or record.get("window_s", 0) <= 0:
        return None
    return 100.0 * flops * record["steps"] / (record["window_s"] * record["peak_flops"])
