"""Share of a clip's time in which no kernel ran on the device, in %: 1 -
busy / clip, busy the union of the device kernels' spans in the profiled
segment weighted to one clip (device trace), the clip's time the traced run's
window over its clips (host clock, the profiler off). The traced segment's
own span is not used: tracing slows the host that paces the launches, and
the span grew from run to run on the card (11.58-12.87 s for 11.16 s busy)."""


def read(record):
    seg = record.get("segment")
    if seg is None or not record.get("clips"):
        return None
    return 100.0 * (1.0 - seg.busy_s / (record["window_s"] / record["clips"]))
