"""Thin copies of the benchmark's cells for the CPU tests: the cell as
``BENCHMARK.json`` has it, with its configuration swapped for the thin one of
``tests/thin/``; and the stand-ins a traced run takes on the CPU, where no
device can be profiled and no CUDA event timed."""

import contextlib
import os
import time

import torch

from harness import profile
from harness import spans as hs
from harness.manifest import BENCH_DIR, Cell, load_cell, read_json

THIN = {"svd_depth.generate": "svd_thin", "i2vgenxl_depth.generate": "i2vgenxl_thin",
        "svd_depth.train": "svd_train_thin", "svd_depth.train_ddp4": "svd_train_thin"}


def thin_cell(name: str) -> Cell:
    cell = load_cell(name)
    cell.config = read_json(os.path.join(BENCH_DIR, "tests", "thin", THIN[name] + ".json"))
    return cell


def run_thin(name: str, seed: int, control=None) -> dict:
    """One run of the thin cell on the CPU, the chip check skipped."""
    cell = thin_cell(name)
    return cell.mode().run(cell, seed, 0.1, False, torch.device("cpu"), time.perf_counter(),
                           lambda *a: None, control=control)


def cpu_trace(run, ops, host=False, attempts=3, log=print, agree=bool, spans=False):
    """``profile.trace`` on the CPU: ``run()``, timed by the host's clock;
    with ``spans``, the program's span recording open, and each span given
    one device event of its own length, launched at its start on its thread,
    so that the table of ``harness/spans.py`` holds every span the run
    opened. No kernel bound or device time."""
    from ctrl_adapter_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    with profiling.recording() if spans else contextlib.nullcontext() as rec:
        result = run()
    length = time.perf_counter() - t0
    agree(True)
    table = None
    if spans:
        kernels = [(s.start_ns, s.end_ns, s.name, i) for i, s in enumerate(rec.spans)]
        table = hs.attribute(rec.spans, kernels,
                             {i: (s.start_ns, s.thread) for i, s in enumerate(rec.spans)})
    return profile.Segment(length, length, {}, {}, 0.0, 0.0, {}, result, table)


class NoTimer:
    """The modes' CUDA-event timers (``TowerTimer``, ``StepTimer``) on the CPU:
    they time nothing."""

    def __init__(self, _owner):
        pass

    def close(self) -> dict:
        return {}


def traced_mode(cell):
    """The cell's mode module (a copy of its own, ``Cell.mode``) with
    ``NoTimer`` in place of its timers; the caller puts ``cpu_trace`` in
    place of ``harness.profile.trace``."""
    mode = cell.mode()
    mode.TowerTimer = mode.StepTimer = NoTimer
    return mode
