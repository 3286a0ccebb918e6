"""Milliseconds of device time per training step in the exchange of the
gradients over the ranks: the device events (the copy into one flat fp32
buffer, the all-reduce and the division) launched under the program's
``trainer.allreduce`` span in the profiled step (``harness/spans.py``).
NCCL's kernel starts when its rank arrives and ends when the last rank's data
has come, so this holds the wait for the slowest rank as well as the
exchange; ``exchange_ms.train`` times the exchange alone. Nothing without
that span: a cell of one card exchanges nothing."""


def read(record):
    table = record.get("spans")
    steps = table.total(["trainer.step"], "calls") if table is not None else 0
    if not steps or not table.outermost(["trainer.allreduce"]):
        return None
    return 1000.0 * table.total(["trainer.allreduce"], "device_s") / steps
