"""Read a segment of the program under ``torch.profiler`` (CPU and CUDA).

For one call ``run()`` it gives the device's busy time (the union of the
device kernels' spans), the span from the first kernel's start to the last
one's end, each device function's time, the idle gaps with the host operation
in flight at each, and the roofline bound of every call of the program's
kernel ops (each op's Python entry is wrapped for the call, and its cost taken
from ``kernels/<op>.py``).

Tracing the host's operations slows the host, and a host that paces the
device then leaves it idle for longer: on the card the SVD clip's idle share
read 10.8 % with them traced against 2.2 % from its busy time and its clip
time. So the times come from a trace of the device alone (``host=False``),
and a second trace with the host's operations (``host=True``) only names the
gaps (``named_gaps``).

The profiler has been seen to drop events late in a long trace. A trace counts
only if it holds an event of each op's once-a-launch device function for every
launch the op's counters saw; else ``run()`` is made again, up to three times,
and then the segment is "not measured" (None). A partial trace is never
scaled up.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch


@dataclass
class Segment:
    busy_s: float
    span_s: float
    device_ops: Dict[str, float]          # device function -> seconds
    idle_gaps: Dict[str, float]           # host op in flight -> seconds of idle device
    kernel_bound_s: float                 # sum of the roofline bounds of the ops' calls
    kernel_time_s: float                  # the ops' device functions' seconds
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    result: object = None

    def scaled(self, w: float) -> "Segment":
        return Segment(self.busy_s * w, self.span_s * w,
                       {k: v * w for k, v in self.device_ops.items()},
                       {k: v * w for k, v in self.idle_gaps.items()},
                       self.kernel_bound_s * w, self.kernel_time_s * w,
                       {k: round(v * w) for k, v in self.kernel_calls.items()})

    def __add__(self, other: "Segment") -> "Segment":
        def add(a, b):
            return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}
        return Segment(self.busy_s + other.busy_s, self.span_s + other.span_s,
                       add(self.device_ops, other.device_ops), add(self.idle_gaps, other.idle_gaps),
                       self.kernel_bound_s + other.kernel_bound_s,
                       self.kernel_time_s + other.kernel_time_s,
                       add(self.kernel_calls, other.kernel_calls))


def _entry_module(op):
    return importlib.import_module(op.ENTRY[0])


@contextlib.contextmanager
def recorded(ops: Dict[str, object], bounds: Dict[str, float], calls: Dict[str, int]):
    """Wrap each op's Python entry so that every call adds its roofline bound
    (seconds) to ``bounds[op]`` and one to ``calls[op]``."""
    saved = []
    try:
        for name, op in ops.items():
            module = _entry_module(op)
            original = getattr(module, op.ENTRY[1])

            def wrapper(*args, _name=name, _op=op, _fn=original, **kwargs):
                bounds[_name] = bounds.get(_name, 0.0) + _op.cost(*args, **kwargs).bound_s
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kwargs)

            setattr(module, op.ENTRY[1], wrapper)
            saved.append((module, op.ENTRY[1], original))
        yield
    finally:
        for module, attr, original in saved:
            setattr(module, attr, original)


def _launches(ops) -> Dict[str, int]:
    return {name: sum(getattr(_entry_module(op), c).launches for c in op.COUNTERS)
            for name, op in ops.items()}


def _pattern(names) -> re.Pattern:
    return re.compile(r"\b(" + "|".join(re.escape(n) for n in names) + r")\b")


def _merge(spans):
    spans = sorted(spans)
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s > merged[-1][1]:
            merged.append([s, e])
        else:
            merged[-1][1] = max(merged[-1][1], e)
    return merged


def _host_op(cpu_starts, cpu_events, t: float) -> str:
    """The innermost host operation in flight at time ``t`` (µs)."""
    i = bisect.bisect_right(cpu_starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):  # the latest start that still holds t
        _, end, name = cpu_events[j]
        if end >= t:
            return name
    return "(no host operation)"


def trace(run: Callable[[], object], ops: Dict[str, object], host: bool = False,
          attempts: int = 3, log=print) -> Optional[Segment]:
    """``run()`` under the profiler, read as set out in the module's doc;
    with ``host``, the host's operations are traced too."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    once = {name: _pattern(op.ONE_PER_LAUNCH) for name, op in ops.items()}
    owned = {name: _pattern(op.DEVICE_FUNCTIONS) for name, op in ops.items()}
    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = _launches(ops)
        bounds, calls = {}, {}
        activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
        with recorded(ops, bounds, calls), profile(activities=activities) as prof:
            result = run()
            torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _launches(ops).items()}
        t0 = time.perf_counter()
        raw = prof.profiler.kineto_results
        start = raw.trace_start_ns()
        names, kern, cpu = {}, [], []
        for e in raw.events():
            if e.is_hidden_event():
                continue
            s, t = (e.start_ns() - start) / 1000, (e.end_ns() - start) / 1000
            if e.device_type() == DeviceType.CUDA:
                n = e.name()
                if n not in names:
                    names[n] = _rewrite_name(name=n, with_wildcard=True)
                kern.append((s, t, names[n]))
            elif t > s:
                cpu.append((s, t, e.name()))
        short = {k: (sum(1 for _, _, n in kern if once[k].search(n)), n)
                 for k, n in launched.items()}
        short = {k: v for k, v in short.items() if v[0] < v[1]}
        if kern and not short:
            break
        log(f"profile: trace {attempt + 1} of {attempts} is partial ("
            + (", ".join(f"{k} {a} events of {b} launches" for k, (a, b) in short.items())
               if short else "no device kernels") + ")")
    else:
        log("profile: not measured (every trace was partial)")
        return None
    merged = _merge([(s, t) for s, t, _ in kern])
    busy = sum(t - s for s, t in merged)
    span = merged[-1][1] - merged[0][0]
    per_name: Dict[str, float] = {}
    for s, t, n in kern:
        per_name[n] = per_name.get(n, 0.0) + (t - s) / 1e6
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    gaps: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        name = _host_op(starts, cpu, (end + nxt) / 2)
        gaps[name] = gaps.get(name, 0.0) + (nxt - end) / 1e6
    kernel_time = sum(sec for n, sec in per_name.items()
                      if any(p.search(n) for p in owned.values()))
    log(f"profile: {len(kern)} device events, {len(cpu)} host events, read in "
        f"{time.perf_counter() - t0:.1f} s")
    return Segment(busy / 1e6, span / 1e6, per_name, gaps, sum(bounds.values()), kernel_time,
                   calls, result)


def named_gaps(timed: Segment, named: Segment) -> Dict[str, float]:
    """The idle time of ``timed`` (a device-only trace) shared out over the host
    operations in flight in the gaps of ``named`` (the same work traced with
    the host), in proportion to ``named``'s gaps."""
    total = sum(named.idle_gaps.values())
    idle = timed.span_s - timed.busy_s
    return {k: v * idle / total for k, v in named.idle_gaps.items()} if total > 0 else {}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
