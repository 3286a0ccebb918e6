"""``BENCHMARK.json`` against the benchmark's contract: names, units, metrics'
cells and ``moves``, the share of four-chip cells, and a file for every
configuration, traffic mix, reader and limit it names."""

import json
import os
import re

from harness.manifest import BENCH_DIR, ROOT, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = read_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[key]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in MANIFEST[key]}) == len(MANIFEST[key])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_bounds_and_seconds():
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])


def test_every_moves_is_reported_by_the_metrics_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in _cells(m):
            assert cell in _cells(e2e[m["moves"]]), (m["name"], cell)
    for w in MANIFEST["workloads"]:
        reported = [m for m in MANIFEST["end_to_end"] if w["name"] in _cells(m)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in _cells(m) for m in MANIFEST["per_layer"])


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_files_for_every_name():
    assert MANIFEST["paths"] == ["benchmark"]
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = read_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(BENCH_DIR, "pipelines", cfg["pipeline"] + ".py"))
    for w in MANIFEST["workloads"]:
        traffic = read_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH_DIR, "modes", traffic["mode"] + ".py"))
        assert os.path.exists(os.path.join(BENCH_DIR, "limits", w["name"] + ".json"))
    for m in MANIFEST["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))
