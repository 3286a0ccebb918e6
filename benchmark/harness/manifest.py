"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cells, and each
configuration, traffic mix, pipeline family, run mode, per-layer metric reader
and kernel cost lives in a file of its own under ``benchmark/``:

- ``configs/<config>.json``: one model configuration (its ``pipeline`` names
  the family module ``pipelines/<pipeline>.py``);
- ``traffic/<mix>.json``: one traffic mix (its ``mode`` names
  ``modes/<mode>.py``, the loop that drives it);
- ``metrics/<metric>.py``: ``read(record) -> float | None``;
- ``kernels/<op>.py``: one kernel op of the program, its entry, device
  functions, launch counters and ``cost``.

A later change adds a file and an entry; nothing here lists them.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(path: str, name: Optional[str] = None):
    """Import the Python file ``path`` under a private module name."""
    mod_name = name or "bench_" + os.path.relpath(path, BENCH_DIR).replace("/", "_").replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR

    def limits(self) -> dict:
        """The comparison limits of this cell (``limits/<cell>.json``)."""
        return read_json(os.path.join(self.bench_dir, "limits", f"{self.name}.json"))

    def family(self):
        return load_module(os.path.join(self.bench_dir, "pipelines",
                                        f"{self.config['pipeline']}.py"))

    def mode(self):
        return load_module(os.path.join(self.bench_dir, "modes", f"{self.traffic['mode']}.py"))

    def readers(self) -> Dict[str, object]:
        """{metric name: reader module} of the per-layer metrics this cell reports."""
        return {m["name"]: load_module(os.path.join(self.bench_dir, "metrics",
                                                    m["name"] + ".py"))
                for m in self.per_layer}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest_path: Optional[str] = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, traffic
    mix and the metrics it reports."""
    manifest = read_json(manifest_path or os.path.join(os.path.dirname(bench_dir),
                                                       "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(os.path.join(os.path.dirname(bench_dir), configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def check_traffic(traffic: dict, known) -> None:
    """Refuse a traffic mix with a key that its mode does not implement, so that
    no setting is silently ignored."""
    unknown = sorted(set(traffic) - set(known) - {"mode", "why"})
    if unknown:
        raise ValueError(f"traffic mode {traffic['mode']!r} implements no {unknown}")


def kernel_ops(bench_dir: str = BENCH_DIR) -> Dict[str, object]:
    """{op name: module} of every ``kernels/<op>.py``."""
    return {os.path.basename(p)[:-3]: load_module(p)
            for p in sorted(glob.glob(os.path.join(bench_dir, "kernels", "*.py")))}
