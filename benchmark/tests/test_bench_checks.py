"""``correct`` on thin runs of each cell on the CPU, the chip check skipped:
true for the program as it is, false with the timed path broken underneath
(``faults.py``), and false with the fp8 control in the program's place. The
training cell runs its thin copy in float32 (``tests/thin/svd_train_thin.json``).
A traffic mix with a setting that its mode does not implement is refused."""

import pytest
import torch

from faults import DDP_FAULTS, FAULTS
from harness import compare
from reference.precision import fp8_towers
from thin_cells import run_thin, thin_cell

CELLS = ["svd_depth.generate", "i2vgenxl_depth.generate"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_thin(name, 2 ** 31 + 17)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in sorted(FAULTS["generate"])])
def test_faults_are_not_correct(name, fault):
    with FAULTS["generate"][fault]():
        result = run_thin(name, 2 ** 31 + 17)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control's numbers, put against the cell's limits, fail."""
    result = run_thin(name, 2 ** 31 + 23, control=fp8_towers)
    ok, checks = compare.judge(result["control"], thin_cell(name).limits())
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(set(FAULTS["train"]) - set(DDP_FAULTS)))
def test_training_faults_are_not_correct(fault):
    with FAULTS["train"][fault]():
        result = run_thin("svd_depth.train", 2 ** 31 + 29)
    assert not result["correct"], (fault, result["checks"])


def test_training_sound_run_and_control():
    result = run_thin("svd_depth.train", 2 ** 31 + 29, control=fp8_towers)
    assert result["correct"], result["checks"]
    ok, checks = compare.judge(result["control"], thin_cell("svd_depth.train").limits())
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS + ["svd_depth.train"])
def test_unread_traffic_setting_is_refused(name):
    cell = thin_cell(name)
    cell.traffic = dict(cell.traffic, clients=8)
    with pytest.raises(ValueError, match="clients"):
        cell.mode().run(cell, 1, 0.1, False, torch.device("cpu"), 0.0, lambda *a: None)
