"""Milliseconds of device time per training step in the recompute of the
checkpointed towers: the device events under the program's outermost
``tower.*`` spans inside ``trainer.backward`` in the profiled step
(``harness/spans.py``). Nothing without the program's spans."""


def read(record):
    table = record.get("spans")
    steps = table.total(["trainer.step"], "calls") if table is not None else 0
    if not steps:
        return None
    total = 0.0
    for path, row in table.rows.items():
        parts = path.split("/")
        towers = [p for p in parts if p.startswith("tower.")]
        if "trainer.backward" in parts and towers == parts[-1:]:
            total += row.device_s
    return 1000.0 * total / steps
