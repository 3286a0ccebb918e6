"""Spans at the port's layer boundaries, and a Chrome trace of a block.

- ``span(name, **ids)``: ``with span("tower.unet"):`` marks a layer
  boundary. While no recording is open (the default) it returns one shared
  no-op object: no allocation, no clock read, no profiler range.
- ``recording()``: ``with recording() as rec:`` records every span opened in
  the block, on any thread, in ``rec.spans``; each recorded span also opens a
  profiler range of its name (as ``torch.profiler.record_function`` does), so
  a profiler running over the block shows it. Nothing is written anywhere.
- ``trace(log_dir)``: ``with trace(dir): run()`` profiles the host and,
  where there is a card, the device, and writes ``dir/trace.json``, a Chrome
  trace (Perfetto, ``chrome://tracing``) that holds the spans of a recording
  open around it.

A recorded span is ``(name, parent, thread, start_ns, end_ns, ids)``: the
index in ``rec.spans`` of the innermost span open on the same thread when it
opened (None for a thread's outermost span), the thread's native id
(``threading.get_native_id``), and its times on the clock of
``time.time_ns``, which is the host clock of the profiler's (Kineto's)
events, so that a span can be set beside the device events launched inside
it. Each thread keeps its own stack: the autograd engine runs the backward
of card tensors, and the recompute of checkpointed towers, on a thread of
its own, and the spans opened there have their outermost span on that
thread. Spans are listed in the order they opened.

Names are fixed strings at each call site (``tower.unet``, ``block.down.0``,
``op.group_norm.plain``, ...; ``PERF.md`` lists them with the metrics they
feed); counts at a boundary are the number of its spans.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[int]   # index of the enclosing span on the same thread
    thread: int             # threading.get_native_id() of the opening thread
    start_ns: int
    end_ns: Optional[int]   # None while the span is still open
    ids: dict


class _NoSpan:
    """The span while nothing records: enters and exits and does nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "parent", "thread", "start_ns", "end_ns", "ids", "index",
                 "_range")

    def __init__(self, rec: "Recording", name: str, ids: dict):
        self.rec, self.name, self.ids = rec, name, ids
        self.end_ns = None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_native_id()
        with rec._lock:
            self.index = len(rec._open)
            rec._open.append(self)
        stack.append(self)
        self.start_ns = time.time_ns()
        # record_function's C++ range: its Python wrapper costs ten times more
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        self.rec._stack().pop()
        return False


class Recording:
    """The spans opened while a :func:`recording` is open."""

    def __init__(self):
        self._open: List[_Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def spans(self) -> List[SpanRecord]:
        """Every span opened so far, in the order they opened."""
        return [SpanRecord(s.name, None if s.parent is None else s.parent.index, s.thread,
                           s.start_ns, s.end_ns, s.ids) for s in list(self._open)]


_recording: Optional[Recording] = None

# the block spans' names, built once: BLOCK_DOWN[i] == "block.down.<i>"
BLOCK_DOWN = tuple(f"block.down.{i}" for i in range(16))
BLOCK_UP = tuple(f"block.up.{i}" for i in range(16))


def span(name: str, **ids):
    """A span named ``name`` (its ``ids``: step, clip, ... numbers kept with
    it) around a ``with`` block; a no-op unless a :func:`recording` is open."""
    rec = _recording
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, ids)


@contextlib.contextmanager
def recording():
    """Record every span opened in the block (module doc); yields the
    :class:`Recording`. Recordings do not nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a span recording is already open")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CUDA device too, where there is one) and write
    ``log_dir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
