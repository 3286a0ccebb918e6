"""A cell, configuration, traffic mix, per-layer metric and kernel cost are
added as new files and entries, and the harness finds them with no existing
file edited."""

import json
import os
import shutil

from harness.manifest import BENCH_DIR, ROOT, kernel_ops, load_cell


def test_new_files_are_found_without_edits(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in map(str, bench.rglob("*")) if os.path.isfile(p)}

    cfg = json.load(open(bench / "configs" / "svd_depth.json"))
    cfg["name"] = "svd_dummy"
    (bench / "configs" / "svd_dummy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy.json").write_text(json.dumps({"mode": "generate",
                                                             "warmup_steps": 2}))
    (bench / "metrics" / "dummy_ms.generate.py").write_text(
        "def read(record):\n    return record.get('dummy')\n")
    (bench / "kernels" / "dummy_op.py").write_text(
        "ENTRY = ('math', 'fabs')\nCOUNTERS = ()\nDEVICE_FUNCTIONS = ('dummy_kernel',)\n"
        "ONE_PER_LAUNCH = ('dummy_kernel',)\n\ndef cost(*args):\n    return None\n")
    (bench / "limits" / "svd_dummy.dummy.json").write_text(json.dumps({"start": 0.0}))
    manifest["configs"].append({"name": "svd_dummy", "source": cfg["source"],
                                "file": "benchmark/configs/svd_dummy.json", "reduced": [],
                                "why": "a dummy"})
    manifest["workloads"].append({"name": "svd_dummy.dummy", "config": "svd_dummy",
                                  "traffic": "dummy", "chips": 1, "why": "a dummy"})
    manifest["per_layer"].append({"name": "dummy_ms.generate", "unit": "ms", "better": "lower",
                                  "source": "program_span", "layer": "pipeline",
                                  "moves": "frames_per_s", "workloads": ["svd_dummy.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = load_cell("svd_dummy.dummy", str(tmp_path / "BENCHMARK.json"), str(bench))
    assert cell.config["name"] == "svd_dummy" and cell.traffic["mode"] == "generate"
    assert cell.limits() == {"start": 0.0}
    readers = cell.readers()
    assert readers["dummy_ms.generate"].read({"dummy": 3.0}) == 3.0
    assert list(readers) == ["dummy_ms.generate"]
    assert cell.family().TOWERS and hasattr(cell.mode(), "run")
    assert "dummy_op" in kernel_ops(str(bench)) and "group_norm_silu" in kernel_ops(str(bench))
    old = load_cell("svd_depth.generate", str(tmp_path / "BENCHMARK.json"), str(bench))
    assert "dummy_ms.generate" not in old.readers() and "decode_ms.generate" in old.readers()
    for path, data in before.items():
        assert open(path, "rb").read() == data, path
