"""The attribution of device events and idle gaps to the program's spans
(``harness/spans.py``) on a synthetic trace worked out by hand, the table's
scaling and sum, and the span readers of ``metrics/``; and a traced thin run
of each one-card cell on the CPU, whose ``record["spans"]`` gives its span
readers numbers.

The trace (times in µs): a training step on the main thread (1) whose
backward's recompute opens a tower and a norm on the engine's thread (2);
kernels launched from both threads, one from a thread the trace names but no
span has (a device-only trace's launches), one whose launch the trace lacks,
and one after every span."""

import os
import time

import pytest
import torch

from ctrl_adapter_tpu_torch.utils.profiling import SpanRecord
from harness import profile
from harness import spans as hs
from harness.manifest import BENCH_DIR, load_module
from thin_cells import cpu_trace, thin_cell, traced_mode

US = 1000  # ns


def _span(name, parent, thread, start, end, **ids):
    return SpanRecord(name, parent, thread, start * US, end * US, ids)


TRAIN_SPANS = [
    _span("trainer.step", None, 1, 0, 1000, step=0),            # 0
    _span("trainer.forward", 0, 1, 10, 395, step=0),            # 1
    _span("tower.unet", 1, 1, 20, 300),                         # 2
    _span("op.group_norm.plain", 2, 1, 50, 100),                # 3
    _span("trainer.backward", 0, 1, 400, 890, step=0),          # 4
    _span("tower.unet", None, 2, 450, 700),                     # 5: the recompute
    _span("op.group_norm.plain", 5, 2, 500, 550),               # 6
    _span("trainer.optimizer", 0, 1, 900, 999, step=0),         # 7
]
# (start, end, device function, correlation id) and launches {id: (time, thread)}
TRAIN_KERNELS = [(100, 150, "gn_a", 1), (150, 250, "conv", 2), (520, 560, "gn_b", 3),
                 (570, 590, "gn_b", 4), (600, 690, "attn", 5), (800, 850, "bwd", 6),
                 (950, 960, "adam", 7), (970, 980, "adam", 8), (1005, 1010, "tail", 9)]
TRAIN_LAUNCHES = {1: (60, 1), 2: (200, 1), 3: (510, 2), 4: (520, None), 5: (600, 2),
                  6: (800, 2), 7: (950, 777), 9: (1004, 1)}


def _table(span_list, kernels, launches, **kw):
    return hs.attribute(span_list, [(s * US, e * US, n, c) for s, e, n, c in kernels],
                        {c: (t * US, th) for c, (t, th) in launches.items()}, **kw)


def _us(x):
    return pytest.approx(x * 1e-6, abs=1e-12)


def test_training_trace_by_hand():
    table = _table(TRAIN_SPANS, TRAIN_KERNELS, TRAIN_LAUNCHES)
    step, back = "trainer.step", "trainer.step/trainer.backward"
    fwd = "trainer.step/trainer.forward"
    expect = {  # path: calls, device µs, launches, interval µs, idle µs in it, gaps µs
        step: (1, 370, 8, 880, 510, 0),
        fwd: (1, 150, 2, 150, 0, 270),
        fwd + "/tower.unet": (1, 150, 2, 150, 0, 0),
        fwd + "/tower.unet/op.group_norm.plain": (1, 50, 1, 50, 0, 0),
        back: (1, 200, 4, 330, 130, 110),
        back + "/tower.unet": (1, 150, 3, 170, 20, 20),
        back + "/tower.unet/op.group_norm.plain": (1, 60, 2, 70, 10, 0),
        "trainer.step/trainer.optimizer": (1, 20, 2, 30, 10, 135),
    }
    assert set(table.rows) == set(expect)
    for path, (calls, dev, launches, interval, idle, gap) in expect.items():
        row = table.rows[path]
        assert row.calls == calls and row.launches == launches, path
        assert row.device_s == _us(dev) and row.interval_s == _us(interval), path
        assert row.idle_s == _us(idle) and row.gap_s == _us(gap), path
    assert table.rows[back + "/tower.unet"].kernels == {"attn": _us(90)}
    assert table.rows[back].kernels == {"bwd": _us(50)}
    assert table.rows["trainer.step/trainer.optimizer"].kernels == {"adam": _us(20)}
    assert table.device_s == _us(375) and table.launches == 9 and table.unmatched == 1
    assert table.idle_s == _us(535)
    assert table.total(["trainer.step"], "device_s") / table.device_s == pytest.approx(370 / 375)
    lines = table.lines()
    assert lines[1].startswith("  trainer.step: 1, 0.370")
    assert any("idle gaps by innermost span: trainer.step/trainer.forward 0.270" in x
               for x in lines)


def test_spans_before_the_trace_are_left_out():
    early = [_span("trainer.step", None, 1, -500, -100, step=9)]
    shifted = [s._replace(parent=None if s.parent is None else s.parent + 1) for s in TRAIN_SPANS]
    table = _table(early + shifted, TRAIN_KERNELS, TRAIN_LAUNCHES, since_ns=0)
    assert table.rows == _table(TRAIN_SPANS, TRAIN_KERNELS, TRAIN_LAUNCHES).rows


GEN_SPANS = [
    _span("pipeline.generate", None, 1, 0, 500, clip=0),              # 0
    _span("pipeline.step", 0, 1, 5, 250, step=0, controlled=True),    # 1
    _span("tower.unet", 1, 1, 10, 240),                               # 2
    _span("op.group_norm.plain", 2, 1, 20, 40),                       # 3
    _span("op.attention.plain", 2, 1, 60, 80),                        # 4
    _span("pipeline.step", 0, 1, 255, 490, step=1, controlled=False), # 5
    _span("op.group_norm.plain", 5, 1, 260, 270),                     # 6
]
GEN_KERNELS = [(30, 70, "gn", 1), (70, 100, "gn", 2), (100, 160, "softmax", 3),
               (300, 320, "gn", 4), (330, 400, "gemm", 5)]
GEN_LAUNCHES = {1: (25, 1), 2: (30, 1), 3: (65, 1), 4: (262, 1), 5: (300, 1)}
DECODE_SPANS = [_span("pipeline.decode", None, 1, 0, 100, clip=0),
                _span("tower.vae_decode", 0, 1, 5, 95),
                _span("op.group_norm.plain", 1, 1, 10, 20)]
DECODE_KERNELS = [(15, 35, "gn", 1), (40, 90, "conv", 2)]
DECODE_LAUNCHES = {1: (12, 1), 2: (30, 1)}


def _readers():
    return {p: load_module(os.path.join(BENCH_DIR, "metrics", p + ".py")) for p in (
        "plain_norm_ms.generate", "plain_attention_ms.generate", "launches.generate",
        "optimizer_ms.train", "recompute_ms.train", "launches.train", "allreduce_ms.train")}


def test_scaled_and_added_and_the_generate_readers():
    steps = _table(GEN_SPANS, GEN_KERNELS, GEN_LAUNCHES)
    decode = _table(DECODE_SPANS, DECODE_KERNELS, DECODE_LAUNCHES)
    norm = "pipeline.generate/pipeline.step/tower.unet/op.group_norm.plain"
    assert steps.rows[norm].device_s == _us(70) and steps.rows[norm].launches == 2
    clip = steps.scaled(4) + decode
    assert clip.rows[norm].calls == 4 and clip.rows[norm].device_s == _us(280)
    assert clip.rows[norm].kernels == {"gn": _us(280)}
    assert clip.rows["pipeline.decode"].launches == 2 and clip.launches == 4 * 5 + 2
    assert clip.device_s == _us(4 * 220 + 70) and clip.idle_s == _us(4 * 150 + 5)
    gen = "pipeline.generate"
    assert clip.rows[gen].calls == 4 and clip.rows[gen].interval_s == _us(4 * 370)
    r = _readers()
    record = {"spans": clip}
    # 4 x (the first step's norm, 70, and the second's, 20) + the decode's, 20
    assert r["plain_norm_ms.generate"].read(record) == pytest.approx(4 * 90e-3 + 20e-3)
    assert r["plain_attention_ms.generate"].read(record) == pytest.approx(4 * 60e-3)
    assert r["launches.generate"].read(record) == 4 * 5 + 2
    for name in ("optimizer_ms.train", "recompute_ms.train", "launches.train",
                 "allreduce_ms.train"):
        assert r[name].read(record) is None


def test_the_train_readers():
    r = _readers()
    record = {"spans": _table(TRAIN_SPANS, TRAIN_KERNELS, TRAIN_LAUNCHES)}
    assert r["optimizer_ms.train"].read(record) == pytest.approx(30e-3)
    assert r["recompute_ms.train"].read(record) == pytest.approx(150e-3)
    assert r["launches.train"].read(record) == 8
    for name in ("plain_norm_ms.generate", "plain_attention_ms.generate", "launches.generate",
                 "allreduce_ms.train"):  # one card: no exchange
        assert r[name].read(record) is None


@pytest.mark.parametrize("record", [{}, {"spans": None}, {"spans": hs.SpanTable({})}])
def test_readers_find_nothing_without_spans(record):
    for name, reader in _readers().items():
        assert reader.read(record) is None, name


SPAN_READERS = {"svd_depth.generate": ("plain_norm_ms.generate", "plain_attention_ms.generate",
                                       "launches.generate"),
                "svd_depth.train": ("optimizer_ms.train", "recompute_ms.train", "launches.train")}
SPAN_READERS["i2vgenxl_depth.generate"] = SPAN_READERS["svd_depth.generate"]


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_traced_thin_run_gives_the_span_readers_numbers(name, monkeypatch):
    """``--trace 1`` on the CPU (``thin_cells.cpu_trace``): the mode puts the
    profiled segment's span table in ``record["spans"]``, and each of the
    cell's span readers prints a number."""
    cell = thin_cell(name)
    calls = []

    def trace(*args, host=False, spans=False, **kwargs):
        calls.append((host, spans))
        return cpu_trace(*args, host=host, spans=spans, **kwargs)

    monkeypatch.setattr(profile, "trace", trace)
    result = traced_mode(cell).run(cell, 2 ** 31 + 43, 0.1, True, torch.device("cpu"),
                                   time.perf_counter(), lambda *a: None)
    for reader in SPAN_READERS[name]:
        assert result["metrics"][reader]["value"] > 0, (reader, result["metrics"])
    assert "allreduce_ms.train" not in result["metrics"]
    assert "exchange_ms.train" not in result["metrics"]
    # each profiled part: the device-only and the host trace without the
    # span recording, then a third trace that records the spans
    parts = 1 if cell.traffic["mode"] == "train" else 2
    assert calls == [(False, False), (True, False), (False, True)] * parts
