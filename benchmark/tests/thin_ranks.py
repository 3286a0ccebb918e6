"""A rehearsal on the CPU of ``run.py`` for a cell of several cards: the
cell's thin copy (``thin_cells.py``) on ``RANKS`` ranks, launched and joined
by ``harness/ranks.py`` as on the cards, over gloo, the look for a chip
skipped. The tests of ``test_bench_ranks.py`` run it.

    python benchmark/tests/thin_ranks.py --workload svd_depth.train_ddp4 --seed <n> \\
        --seconds <s> [--trace 1] [--fault <f>] [--exit-after <k>]

``--fault`` plants a fault of ``faults.py`` in every rank; ``--exit-after``
makes rank 1 exit with an error after its k-th training step. Rank 0 prints
the checks and the result line as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(TESTS)
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR), TESTS]

import torch  # noqa: E402

import run  # noqa: E402

RANKS = 2
THREADS = 2  # each rank's, so that the ranks do not crowd the host's cores


def exit_after(steps: int):
    """Rank 1 exits with 9 after its ``steps``-th training step."""
    import torch.distributed as dist

    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer
    from faults import patched

    step = CtrlAdapterTrainer.train_step

    def counted(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        if dist.get_rank() == 1 and self.steps >= steps:
            os._exit(9)
        return out

    return patched((CtrlAdapterTrainer, "train_step", counted))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = run.parser()
    p.add_argument("--fault", default=None)
    p.add_argument("--exit-after", type=int, default=None)
    args = p.parse_args(argv)
    from faults import FAULTS
    from harness import compare, env, profile, ranks
    from thin_cells import cpu_trace, thin_cell, traced_mode

    start = env.started(T_START)
    if ranks.launcher(RANKS):
        try:
            ranks.launch(RANKS, os.path.abspath(__file__), argv, run.log)
        except ranks.ChildFailed:
            return ranks.FAILED
        return 0
    cell = thin_cell(args.workload)
    cell.chips = RANKS
    mode = traced_mode(cell)
    profile.trace = cpu_trace

    def body(dev, group):
        torch.set_num_threads(THREADS)
        fault = FAULTS[cell.traffic["mode"]][args.fault]() if args.fault else contextlib.nullcontext()
        stop = exit_after(args.exit_after) if args.exit_after else contextlib.nullcontext()
        with fault, stop:
            return mode.run(cell, args.seed, args.seconds, bool(args.trace), dev, start,
                            run.log, group=group)

    result = ranks.run(body, RANKS, cuda=False)
    if ranks.rank():
        return 0
    compare.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
