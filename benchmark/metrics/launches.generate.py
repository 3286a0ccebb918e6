"""Device launches per clip: the kernels, memsets and copies launched under
the program's ``pipeline.generate`` spans (the profiled steps, weighted to a
clip's) and ``pipeline.decode`` spans (``harness/spans.py``). Nothing without
the program's spans."""


def read(record):
    table = record.get("spans")
    if table is None or not table.outermost(["pipeline.generate"]):
        return None
    return table.total(["pipeline.generate", "pipeline.decode"], "launches")
