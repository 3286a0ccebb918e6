"""Device time, launches and idle gaps by the program's spans.

The program records spans at its layer boundaries
(``ctrl_adapter_tpu_torch/utils/profiling.py``: ``pipeline.step``,
``tower.unet``, ``op.group_norm.plain``, ``trainer.optimizer``, ...) on the
host clock of the profiler's events. ``attribute`` sets them beside one
profiler trace:

- each device event (a kernel, a memset or a copy) goes, through its
  correlation id, to the runtime call that launched it, and from there to
  the innermost span open on the launching thread at that moment; where that
  thread had none open, or the trace does not say which thread launched
  (a trace of the device alone gives all launches one thread id), to the
  innermost span open on any thread; an event whose launch the trace lacks
  goes by its own start, and is counted (``unmatched``);
- each idle gap of the device (between two of its busy intervals) goes to
  the innermost span open at the gap's midpoint.

"Innermost" is by depth in the spans' tree, in which a thread's outermost
span hangs under the innermost span that another thread had open when it
started: the recompute of a checkpointed tower, opened on the autograd
engine's thread, sits under ``trainer.backward``.

A span's path is its name behind those of its ancestors, joined by ``/``. The
table has a row per path: its calls; the device seconds and launches of the
events under it (its descendants' included); the sum over its calls of the
device interval from its first event's start to its last event's end and of
the device's idle time inside that interval; the idle gaps it is the
innermost span of; and the device functions of the events whose innermost
span it is (its self time). Rows scale and add as ``profile.Segment`` does.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Kernel = Tuple[int, int, str, int]  # start_ns, end_ns, device function, correlation id
Launch = Tuple[int, Optional[int]]  # time_ns, launching thread (None: unknown)


@dataclass
class Row:
    calls: int = 0
    device_s: float = 0.0
    launches: int = 0
    interval_s: float = 0.0
    idle_s: float = 0.0
    gap_s: float = 0.0
    kernels: Dict[str, float] = field(default_factory=dict)  # self: device function -> s

    @property
    def self_s(self) -> float:
        return sum(self.kernels.values())

    def scaled(self, w: float) -> "Row":
        return Row(round(self.calls * w), self.device_s * w, round(self.launches * w),
                   self.interval_s * w, self.idle_s * w, self.gap_s * w,
                   {k: v * w for k, v in self.kernels.items()})

    def __add__(self, other: "Row") -> "Row":
        return Row(self.calls + other.calls, self.device_s + other.device_s,
                   self.launches + other.launches, self.interval_s + other.interval_s,
                   self.idle_s + other.idle_s, self.gap_s + other.gap_s,
                   _add(self.kernels, other.kernels))


def _add(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


@dataclass
class SpanTable:
    rows: Dict[str, Row]      # span path -> row
    device_s: float = 0.0     # every device event of the trace
    launches: int = 0
    idle_s: float = 0.0       # every idle gap of the trace
    unmatched: int = 0        # device events without their runtime launch in the trace

    def scaled(self, w: float) -> "SpanTable":
        return SpanTable({k: r.scaled(w) for k, r in self.rows.items()}, self.device_s * w,
                         round(self.launches * w), self.idle_s * w, round(self.unmatched * w))

    def __add__(self, other: "SpanTable") -> "SpanTable":
        rows = dict(self.rows)
        for k, r in other.rows.items():
            rows[k] = rows[k] + r if k in rows else r
        return SpanTable(rows, self.device_s + other.device_s, self.launches + other.launches,
                         self.idle_s + other.idle_s, self.unmatched + other.unmatched)

    def outermost(self, names: Iterable[str]) -> List[Row]:
        """The rows of spans named one of ``names`` inside no span of those names."""
        names = set(names)
        out = []
        for path, row in self.rows.items():
            parts = path.split("/")
            if parts[-1] in names and not names & set(parts[:-1]):
                out.append(row)
        return out

    def total(self, names: Iterable[str], key: str) -> float:
        """``key`` summed over :meth:`outermost` ``names``."""
        return sum(getattr(r, key) for r in self.outermost(names))

    def lines(self, n: int = 30, functions: int = 5) -> List[str]:
        """The ``n`` rows with the most device time, then the device functions
        under the ``functions`` rows with the most self time."""
        out = [f"spans: {self.device_s * 1e3:.3f} ms on the device in {self.launches} "
               f"launches ({self.unmatched} without their launch in the trace), idle "
               f"{self.idle_s * 1e3:.3f} ms; rows by device ms (calls, device ms, self ms, "
               f"launches, interval ms, idle ms in it, gaps ms)"]
        for path, r in sorted(self.rows.items(), key=lambda kv: -kv[1].device_s)[:n]:
            out.append(f"  {path}: {r.calls}, {r.device_s * 1e3:.3f}, {r.self_s * 1e3:.3f}, "
                       f"{r.launches}, {r.interval_s * 1e3:.3f}, {r.idle_s * 1e3:.3f}, "
                       f"{r.gap_s * 1e3:.3f}")
        for path, r in sorted(self.rows.items(), key=lambda kv: -kv[1].self_s)[:functions]:
            out.append(f"  self time of {path}:")
            for name, s in sorted(r.kernels.items(), key=lambda kv: -kv[1])[:5]:
                out.append(f"    {s * 1e3:.3f} ms {name[:140]}")
        gaps = sorted(((r.gap_s, p) for p, r in self.rows.items() if r.gap_s > 0), reverse=True)
        out.append("  idle gaps by innermost span: " + ", ".join(
            f"{p} {s * 1e3:.3f} ms" for s, p in gaps[:10]))
        return out


def _logical_parents(spans) -> List[Optional[int]]:
    """Each span's parent in the spans' tree (module doc): its own thread's,
    else, for a thread's outermost span, the span of another thread with the
    latest start that holds its start."""
    parents = []
    for i, s in enumerate(spans):
        if s.parent is not None:
            parents.append(s.parent)
            continue
        best = None
        for j in range(i - 1, -1, -1):  # spans are in the order they opened
            o = spans[j]
            if o.thread != s.thread and (o.end_ns is None or o.end_ns >= s.start_ns):
                best = j
                break
        parents.append(best)
    return parents


def _innermost(spans, depth, queries: Sequence[Launch]) -> List[Optional[int]]:
    """For each (time_ns, thread or None) query, the innermost span open then:
    on that thread where it has one open, else on any thread."""
    events = []  # (time, kind, index): at one time opens, then queries, then closes
    for i, s in enumerate(spans):
        events.append((s.start_ns, 0, i))
        events.append((s.end_ns if s.end_ns is not None else float("inf"), 2, i))
    for q, (t, _) in enumerate(queries):
        events.append((t, 1, q))
    events.sort()
    stacks: Dict[int, List[int]] = {}
    out: List[Optional[int]] = [None] * len(queries)
    for _, kind, x in events:
        if kind == 0:
            stacks.setdefault(spans[x].thread, []).append(x)
        elif kind == 2:
            stacks[spans[x].thread].remove(x)  # a sibling may open at its parent's end
        else:
            thread = queries[x][1]
            own = stacks.get(thread)
            if own:
                out[x] = own[-1]
            else:
                tops = [st[-1] for st in stacks.values() if st]
                out[x] = max(tops, key=lambda i: (depth[i], spans[i].start_ns)) if tops else None
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def attribute(spans, kernels: Sequence[Kernel], launches: Dict[int, Launch],
              since_ns: Optional[int] = None) -> SpanTable:
    """The table of ``spans`` (the program's ``SpanRecord``s; those opened
    before ``since_ns`` are left out) over one trace's device events
    ``kernels`` and the runtime calls ``launches`` that launched them, keyed
    by correlation id (module doc)."""
    keep = [i for i, s in enumerate(spans) if since_ns is None or s.start_ns >= since_ns]
    index = {old: new for new, old in enumerate(keep)}
    spans = [spans[i]._replace(parent=index.get(spans[i].parent)) for i in keep]
    parents = _logical_parents(spans)
    depth, paths = [], []
    for i, s in enumerate(spans):
        p = parents[i]
        depth.append(0 if p is None else depth[p] + 1)
        paths.append(s.name if p is None else paths[p] + "/" + s.name)

    merged = _merge((s, e) for s, e, _, _ in kernels)
    ends = [e for _, e in merged]
    starts = [s for s, _ in merged]
    busy_before = [0]
    for s, e in merged:
        busy_before.append(busy_before[-1] + e - s)

    def busy(a: int, b: int) -> int:
        """Device busy ns inside [a, b]."""
        total = 0
        i = bisect.bisect_right(ends, a)
        j = bisect.bisect_left(starts, b)
        if i < j:
            total = busy_before[j] - busy_before[i]
            total -= max(0, a - merged[i][0]) + max(0, merged[j - 1][1] - b)
        return total

    gaps = [(e, s2) for (_, e), (s2, _) in zip(merged, merged[1:])]
    queries = [launches.get(c, (s, None)) for s, _, _, c in kernels]
    queries += [((a + b) // 2, None) for a, b in gaps]
    found = _innermost(spans, depth, queries)
    owner, gap_owner = found[:len(kernels)], found[len(kernels):]

    n = len(spans)
    dev = [0] * n
    count = [0] * n
    first: List[Optional[int]] = [None] * n
    last: List[Optional[int]] = [None] * n
    own: List[Dict[str, float]] = [{} for _ in range(n)]
    for (s, e, name, _), i in zip(kernels, owner):
        if i is None:
            continue
        own[i][name] = own[i].get(name, 0.0) + (e - s) / 1e9
        dev[i] += e - s
        count[i] += 1
        first[i] = s if first[i] is None else min(first[i], s)
        last[i] = e if last[i] is None else max(last[i], e)
    for i in range(n - 1, -1, -1):  # a parent opened before its children
        p = parents[i]
        if p is not None:
            dev[p] += dev[i]
            count[p] += count[i]
            if first[i] is not None:
                first[p] = first[i] if first[p] is None else min(first[p], first[i])
                last[p] = last[i] if last[p] is None else max(last[p], last[i])
    gap_ns = [0] * n
    for (a, b), i in zip(gaps, gap_owner):
        if i is not None:
            gap_ns[i] += b - a

    rows: Dict[str, Row] = {}
    for i in range(n):
        interval = 0 if first[i] is None else last[i] - first[i]
        idle = 0 if first[i] is None else interval - busy(first[i], last[i])
        row = Row(1, dev[i] / 1e9, count[i], interval / 1e9, idle / 1e9, gap_ns[i] / 1e9, own[i])
        rows[paths[i]] = rows[paths[i]] + row if paths[i] in rows else row
    total = sum(e - s for s, e, _, _ in kernels)
    return SpanTable(rows, total / 1e9, len(kernels), sum(b - a for a, b in gaps) / 1e9,
                     sum(1 for *_, c in kernels if c not in launches))


def trace_events(prof) -> Tuple[List[Kernel], Dict[int, Launch], int]:
    """(device events, their launches by correlation id, the trace's start ns)
    of a finished ``torch.profiler.profile``. A device event that is a
    profiler range (a ``record_function`` shown on the device's timeline) is
    not work, and is left out. A launch is a CUDA API call (the runtime's
    ``cudaLaunchKernel``, ``cudaMemcpyAsync``, ..., and ``cuLaunchKernel``); its
    thread is the event's ``device_resource_id`` (the native thread id where
    the host's operations were traced too)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name

    raw = prof.profiler.kineto_results
    names: Dict[str, str] = {}
    kernels: List[Kernel] = []
    launches: Dict[int, Launch] = {}
    for e in raw.events():
        if e.is_hidden_event() or e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            n = e.name()
            if n not in names:
                names[n] = _rewrite_name(name=n, with_wildcard=True)
            kernels.append((e.start_ns(), e.end_ns(), names[n], e.correlation_id()))
        elif e.correlation_id() and e.name().startswith("cu"):  # CUDA API calls
            launches[e.correlation_id()] = (e.start_ns(), e.device_resource_id())
    return kernels, launches, raw.trace_start_ns()
