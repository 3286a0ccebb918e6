"""Readings of the check's control and faults: a run of a cell whose check
also puts the reference computed in fp8 (``reference/precision.py``) in the
program's place and prints the numbers it gives beside the program's; with
``--fault``, the program carries that fault of ``faults.py``. The benchmark's
own runs never do this.

    python3 benchmark/control.py --workload <name> --seed <n> --seconds <s> [--fault <f>]
        [--more-seeds <n> ...]

Each seed prints one line of JSON on standard output: {"workload", "seed",
"fault", "program": {number: value}, "control": {number: value}}.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    p = run.parser()
    p.add_argument("--fault", default=None)
    p.add_argument("--more-seeds", type=int, nargs="*", default=[],
                   help="further seeds read in the same process, a line each")
    args = p.parse_args(argv)
    sys.path[:0] = [run.BENCH_DIR, run.ROOT]
    import torch

    import contextlib

    from faults import FAULTS
    from harness import env
    from harness.manifest import load_cell
    from reference.precision import fp8_towers

    env.prepare(run.ROOT)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log("control readings need a CUDA card")
        return 2
    fault = args.fault
    for seed in [args.seed] + args.more_seeds:
        planted = FAULTS[cell.traffic["mode"]][fault]() if fault else contextlib.nullcontext()
        with planted:
            start = T_START if seed == args.seed else time.perf_counter()
            result = cell.mode().run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                     start, run.log, control=fp8_towers)
        program = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                          "program": program, "control": result["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
