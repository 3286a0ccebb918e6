"""``mfu.*`` counts its FLOPs on the benchmark's reference on the ``meta``
device: the count is the same whether the program's kernels are on or off,
since it never reaches them."""

import importlib

from harness import flops
from harness.manifest import kernel_ops
from modes.generate import control_steps
from thin_cells import thin_cell


def _count(name):
    cell = thin_cell(name)
    window, steps = control_steps(cell.config["generate"])
    return flops.step_flops(cell.family(), cell.config, window, steps)


def test_flops_do_not_depend_on_the_kernels(monkeypatch):
    on = _count("svd_depth.generate")
    assert on["controlled"] > on["unet_only"] > 0 and on["decode"] > 0

    def off(*args, **kwargs):
        raise AssertionError("the FLOP count reached a kernel of the program")

    for op in kernel_ops().values():
        monkeypatch.setattr(importlib.import_module(op.ENTRY[0]), op.ENTRY[1], off)
    assert _count("svd_depth.generate") == on


def test_full_size_counts():
    """The published configurations' counts, for the record in PERF.md."""
    from harness.manifest import load_cell

    for name, lo, hi in (("svd_depth.generate", 40e12, 80e12),
                         ("i2vgenxl_depth.generate", 50e12, 90e12)):
        cell = load_cell(name)
        window, steps = control_steps(cell.config["generate"])
        per = flops.step_flops(cell.family(), cell.config, window, steps)
        assert lo < per["controlled"] < hi, (name, per)
