"""Milliseconds per training step of the optimizer (the program's
``trainer.optimizer`` span: both global norms, the norm's read to the host,
the clip, AdamW and the copy into the bf16 weights): the device interval from
its first event's start to its last event's end, idle time in it included, in
the profiled step (``harness/spans.py``). Nothing without the program's
spans."""


def read(record):
    table = record.get("spans")
    steps = table.total(["trainer.step"], "calls") if table is not None else 0
    if not steps:
        return None
    return 1000.0 * table.total(["trainer.optimizer"], "interval_s") / steps
