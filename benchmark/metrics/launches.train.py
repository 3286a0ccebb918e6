"""Device launches per training step: the kernels, memsets and copies
launched under the program's ``trainer.step`` span in the profiled step
(``harness/spans.py``). Nothing without the program's spans."""


def read(record):
    table = record.get("spans")
    steps = table.total(["trainer.step"], "calls") if table is not None else 0
    if not steps:
        return None
    return table.total(["trainer.step"], "launches") / steps
