"""Share of a training step's time in which no kernel ran on the device, in %:
1 - busy / step, busy the union of the device kernels' spans in one profiled
step (device trace), the step's time the traced run's window over its steps
(host clock, the profiler off), as ``idle_pct.generate`` takes it."""


def read(record):
    seg = record.get("segment")
    if seg is None or not record.get("steps"):
        return None
    return 100.0 * (1.0 - seg.busy_s / (record["window_s"] / record["steps"]))
