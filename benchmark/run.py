"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``); the mix's mode (``modes/``) drives the program,
``ctrl_adapter_tpu_torch``, on the card. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, ``breakdown`` (traced runs) and ``checks``, each
number compared beside its limit; the checks are also the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell asks
for, it prints no result and exits with 2; with JAX loaded in the process, 3;
without the program beside it, 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    from harness import compare, env
    from harness.manifest import load_cell

    env.prepare(ROOT)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    try:
        import ctrl_adapter_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as err:
        log(f"the program is not in this checkout: {err}")
        return 4
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    result = cell.mode().run(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START, log)
    found = env.jax_loaded()
    if found:
        log(f"JAX was loaded in this process: {', '.join(found)}")
        return 3
    result["device"]["power_limit"] = smi.stdout.strip()
    compare.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
