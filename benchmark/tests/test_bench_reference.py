"""At thin sizes on the CPU, the benchmark's float32 reference agrees with the
program's plain path: tower by tower on the same weights, and through a whole
run of each cell with the program in float32, where every number the check
compares is rounding."""

import pytest
import torch

from harness import seeds
from thin_cells import run_thin, thin_cell


def _close(a, b, tol):
    a, b = a.float(), b.float()
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("name", ["svd_depth.generate", "i2vgenxl_depth.generate"])
def test_towers_match_the_program(name):
    cell = thin_cell(name)
    cfg = dict(cell.config, dtype="float32")
    fam = cell.family()
    pipe, _ = fam.build(cfg, torch.device("cpu"), 11)
    ref = fam.reference_towers(cfg, torch.device("cpu"), 11)
    for tower in fam.TOWERS:
        # a pipeline may hold its ControlNet in a list of experts ("nets.0.")
        got = {k.removeprefix("nets.0."): v for k, v in getattr(pipe, tower).named_parameters()}
        want = dict(getattr(ref, tower).named_parameters())
        assert got.keys() == want.keys(), tower
        for k, v in want.items():
            assert torch.equal(got[k], v), (tower, k)
    inputs = fam.inputs(cfg, torch.device("cpu"), seeds.generator("cpu", 11, "clip", 0))
    with torch.no_grad():
        video = pipe.generate(**inputs, **fam.generate_kwargs(cfg))
        smp = fam.sampler(ref, inputs, cfg)
        x = smp.start(inputs["latents"])
        for i in range(cfg["generate"]["num_inference_steps"]):
            x = smp.step(x, i)["next"]
        want = smp.decode(x.permute(0, 1, 3, 4, 2))
    _close(video, want, 1e-4)


@pytest.mark.parametrize("name", ["svd_depth.generate", "i2vgenxl_depth.generate"])
def test_float32_program_reads_rounding(name, monkeypatch):
    cell = thin_cell(name)
    cfg = dict(cell.config, dtype="float32")
    monkeypatch.setattr(cell, "config", cfg)
    import thin_cells

    monkeypatch.setattr(thin_cells, "thin_cell", lambda _: cell)
    result = run_thin(name, 5)
    assert result["correct"]
    for number, c in result["checks"].items():
        assert c["value"] <= 1e-4, (number, c["value"])
