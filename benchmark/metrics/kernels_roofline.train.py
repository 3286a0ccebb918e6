"""Share of their roofline that the program's kernels reach in one profiled
training step, in %: the sum of the frozen bounds (``kernels/<op>.py``) of
every kernel call over the sum of those kernels' device time. Nothing when no
kernel of the program ran or the trace was partial."""


def read(record):
    seg = record.get("segment")
    if seg is None or seg.kernel_time_s <= 0 or seg.kernel_bound_s <= 0:
        return None
    return 100.0 * seg.kernel_bound_s / seg.kernel_time_s
