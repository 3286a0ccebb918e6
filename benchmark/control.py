"""Readings of the check's control and faults: a run of a cell whose check
also puts the reference computed in fp8 (``reference/precision.py``) in the
program's place and prints the numbers it gives beside the program's; with
``--fault``, the program carries that fault of ``faults.py`` instead, one
fault after the other where several are named, and the control, which no
fault of the program changes, is not computed again. The benchmark's own
runs never do this.

    python3 benchmark/control.py --workload <name> --seed <n> --seconds <s> [--fault <f> ...]
        [--more-seeds <n> ...]

``--fault none`` reads the sound program with the control, so that sound
seeds and faults can be read in one process.

Each seed (of each fault) prints one line of JSON on standard output:
{"workload", "seed", "fault", "program": {number: value}, "control": {number:
value} or null}. A cell of several cards runs on its ranks as ``run.py`` runs
it, the fault planted in each; rank 0 prints.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = run.parser()
    p.add_argument("--fault", nargs="+", default=["none"],
                   help="faults of faults.py, read one after the other; none: the sound program")
    p.add_argument("--more-seeds", type=int, nargs="*", default=[],
                   help="further seeds read in the same process, a line each")
    args = p.parse_args(argv)
    sys.path[:0] = [run.BENCH_DIR, run.ROOT]
    import torch

    import contextlib

    from faults import FAULTS
    from harness import env, ranks
    from harness.manifest import load_cell
    from reference.precision import fp8_towers

    env.prepare(run.ROOT)
    start = env.started(T_START)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        run.log(f"control readings need {cell.chips} CUDA card(s)")
        return 2

    def body(dev, group):
        nonlocal start
        for fault in [None if f == "none" else f for f in args.fault]:
            for seed in [args.seed] + args.more_seeds:
                planted = FAULTS[cell.traffic["mode"]][fault]() if fault else contextlib.nullcontext()
                with planted:
                    result = cell.mode().run(cell, seed, args.seconds, False, dev, start, run.log,
                                             control=None if fault else fp8_towers, group=group)
                start = time.perf_counter()
                program = {k: v["value"] for k, v in result["checks"].items()}
                if not ranks.rank():
                    print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                                      "program": program, "control": result.get("control")}),
                          flush=True)

    try:
        run.on_ranks(cell, argv, body, os.path.abspath(__file__))
    except ranks.ChildFailed:
        return ranks.FAILED
    return 0


if __name__ == "__main__":
    sys.exit(main())
