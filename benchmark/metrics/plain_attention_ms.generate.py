"""Milliseconds of device time per clip in the attentions that kernel K2 does
not take (the program's ``op.attention.plain`` spans): the device events
launched under those spans in the profiled segment, weighted to one clip
(``harness/spans.py``). Nothing without the program's spans."""


def read(record):
    table = record.get("spans")
    if table is None or not table.outermost(["pipeline.generate"]):
        return None
    return 1000.0 * table.total(["op.attention.plain"], "device_s")
