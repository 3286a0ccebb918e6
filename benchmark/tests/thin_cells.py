"""Thin copies of the benchmark's cells for the CPU tests: the cell as
``BENCHMARK.json`` has it, with its configuration swapped for the thin one of
``tests/thin/``."""

import os
import time

import torch

from harness.manifest import BENCH_DIR, Cell, load_cell, read_json

THIN = {"svd_depth.generate": "svd_thin", "i2vgenxl_depth.generate": "i2vgenxl_thin",
        "svd_depth.train": "svd_train_thin"}


def thin_cell(name: str) -> Cell:
    cell = load_cell(name)
    cell.config = read_json(os.path.join(BENCH_DIR, "tests", "thin", THIN[name] + ".json"))
    return cell


def run_thin(name: str, seed: int, control=None) -> dict:
    """One run of the thin cell on the CPU, the chip check skipped."""
    cell = thin_cell(name)
    return cell.mode().run(cell, seed, 0.1, False, torch.device("cpu"), time.perf_counter(),
                           lambda *a: None, control=control)
