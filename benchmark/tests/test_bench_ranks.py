"""The launcher of a cell of several cards (``harness/ranks.py``, as
``run.py`` drives it), rehearsed on the CPU over gloo with two ranks at the
thin training configuration (``thin_ranks.py``): every rank takes the same
steps, the masters stay equal and the check passes; the faults of the
gradients' exchange, and those of one card that the exchange could hide,
fail the check; a rank that exits early ends the run with an error within
the launcher's grace, and the run prints no result."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from faults import DDP_FAULTS
from harness import ranks

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "thin_ranks.py")
CELL = "svd_depth.train_ddp4"
STOP_S = 60  # a failed rank ends the run within the launcher's 30 s grace, with room


def rehearse(*extra, seed=2 ** 31 + 41):
    """(exit code, the result line or None, standard error, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, SCRIPT, "--workload", CELL, "--seed", str(seed),
                          "--seconds", "0.5", *extra], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else None
    return out.returncode, result, out.stderr, time.perf_counter() - t0


def test_sound_run_takes_equal_steps_and_is_correct():
    code, result, err, _ = rehearse()
    assert code == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["checks"]["masters_equal"]["value"] == 0.0
    steps = re.findall(r"steps by rank \[(\d+), (\d+)\]", err)
    assert steps and all(a == b == str(result["attempted"]) for a, b in steps), steps


@pytest.mark.parametrize("fault", sorted(DDP_FAULTS) + ["half_frames", "state_unchanged"])
def test_faults_are_not_correct(fault):
    code, result, err, _ = rehearse("--fault", fault)
    assert code == 0, err[-3000:]
    assert not result["correct"], (fault, result["checks"])


def test_a_rank_that_exits_early_ends_the_run():
    code, result, err, seconds = rehearse("--exit-after", "1")
    assert code == ranks.FAILED and result is None, err[-3000:]
    assert seconds < STOP_S, seconds
    assert "rank 1 exited with 9" in err


def test_traced_run_reads_the_training_span_metrics():
    code, result, err, _ = rehearse("--trace", "1")
    assert code == 0, err[-3000:]
    for name in ("optimizer_ms.train", "recompute_ms.train", "launches.train",
                 "allreduce_ms.train", "exchange_ms.train"):
        assert result["metrics"][name]["value"] > 0, (name, result["metrics"])
