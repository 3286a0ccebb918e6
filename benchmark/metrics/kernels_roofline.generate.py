"""Share of their roofline that the program's kernels reach, in %: the sum of
the frozen bounds (``kernels/<op>.py``) of every kernel call in the profiled
segment over the sum of those kernels' device time, both weighted to one clip.
Nothing when no kernel of the program ran or the trace was partial."""


def read(record):
    seg = record.get("segment")
    if seg is None or seg.kernel_time_s <= 0 or seg.kernel_bound_s <= 0:
        return None
    return 100.0 * seg.kernel_bound_s / seg.kernel_time_s
