"""Readings of a cell by the program's spans: one run of the cell as
``run.py --trace 1`` makes it (the program's span recording,
``ctrl_adapter_tpu_torch/utils/profiling.py``, open in the third trace of
each profiled part, and that trace set beside the spans, ``harness/spans.py``),
with the whole table printed. A cell of several cards runs on its ranks as
``run.py`` runs it; rank 0 prints.

    python3 benchmark/spans.py --workload <name> --seed <n> --seconds <s>

Standard error gets the span table of the profiled segment (weighted to a
clip, or one training step). Standard output gets one line of JSON:
``span_metrics`` (the readers ``metrics/plain_norm_ms.generate.py``,
``plain_attention_ms.generate.py``, ``launches.generate.py``,
``optimizer_ms.train.py``, ``recompute_ms.train.py``, ``launches.train.py``,
``allreduce_ms.train.py`` on that table),
``coverage`` (the share of the device time that falls under the outermost
spans), ``agreement`` (span intervals beside the hooks' timings of the same
run), ``span_cost_ns`` (a span's host cost with the recording off and on),
and the run's own ``metrics``, ``device`` and ``correct``.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402

READERS = ("plain_norm_ms.generate", "plain_attention_ms.generate", "launches.generate",
           "optimizer_ms.train", "recompute_ms.train", "launches.train", "allreduce_ms.train")
ROOTS = {"generate": ("pipeline.generate", "pipeline.decode"), "train": ("trainer.step",)}


def collecting(original, tables):
    """``profile.trace`` that also puts the span table of each trace that
    recorded spans (None for no segment) into ``tables``."""
    def trace(fn, ops, spans=False, **kwargs):
        segment = original(fn, ops, spans=spans, **kwargs)
        if spans:
            tables.append(None if segment is None else segment.spans)
        return segment

    return trace


def weighted(cell, tables):
    """The span tables as the mode weights its segment: one training step,
    or the profiled steps scaled to a clip plus the decode."""
    if cell.traffic["mode"] == "train":
        return tables[0]
    if None in tables:
        return None
    mode = cell.mode()
    g = cell.config["generate"]
    (lo, hi), _ = mode.control_steps(g)
    (plo, phi), _ = mode.control_steps(g, cell.traffic["profile_steps"])
    return tables[0].scaled((hi - lo) / (phi - plo)) + tables[1]


def readings(table, readers) -> dict:
    if table is None:
        return {}
    out = {}
    for name, reader in readers.items():
        value = reader.read({"spans": table})
        if value is not None:
            out[name] = value
    return out


def agreement(table, metrics) -> dict:
    """Each hook-timed metric of the run (its window, the profiler off)
    beside the same spans' device interval per call in the profiled segment,
    and that interval less the idle time in it."""
    def per_call(names, key):  # ms per call of the first name
        n = table.total(names[:1], "calls")
        return 1000.0 * sum(table.total([x], key) for x in names) / n if n else None

    out = {}
    for metric, names in (("unet_ms.generate", ["tower.unet"]),
                          ("control_ms.generate", ["tower.controlnet", "tower.adapter"]),
                          ("decode_ms.generate", ["pipeline.decode"]),
                          ("forward_ms.train", ["trainer.forward"])):
        interval = per_call(names, "interval_s")
        if interval is not None and metric in metrics:
            out[metric] = {"hooks": metrics[metric]["value"], "interval": interval,
                           "busy": interval - per_call(names, "idle_s")}
    return out


def span_cost(n: int = 200_000) -> dict:
    """Host ns per ``with span(...)`` with the recording off and on (no
    profiler running)."""
    from ctrl_adapter_tpu_torch.utils import profiling

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("op.group_norm.plain"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = min(loop() for _ in range(3))
    with profiling.recording():
        on = loop()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = run.parser().parse_args(argv)
    sys.path[:0] = [run.BENCH_DIR, run.ROOT]
    import torch

    from harness import env, profile, ranks
    from harness.manifest import load_cell, load_module

    env.prepare(run.ROOT)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        run.log(f"span readings need {cell.chips} CUDA card(s)")
        return 2
    readers = {name: load_module(os.path.join(run.BENCH_DIR, "metrics", name + ".py"))
               for name in READERS}
    tables = []
    profile.trace = collecting(profile.trace, tables)

    start = env.started(T_START)

    def body(dev, group):
        return cell.mode().run(cell, args.seed, args.seconds, True, dev, start, run.log,
                               group=group)

    try:
        result = run.on_ranks(cell, argv, body, os.path.abspath(__file__))
    except ranks.ChildFailed:
        return ranks.FAILED
    if result is None or ranks.rank():
        return 0
    table = weighted(cell, tables)
    out = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"], "span_metrics": readings(table, readers)}
    if table is not None:
        for line in table.lines():
            run.log(line)
        covered = sum(table.total([r], "device_s") for r in ROOTS[cell.traffic["mode"]])
        out["coverage"] = covered / table.device_s
        out["agreement"] = agreement(table, result["metrics"])
        out["idle_by_span_ms"] = dict(sorted(
            ((p, 1000.0 * r.gap_s) for p, r in table.rows.items() if r.gap_s > 0),
            key=lambda kv: -kv[1])[:15])
        out["idle_ms"] = 1000.0 * table.idle_s
        out["span_calls"] = sum(r.calls for r in table.rows.values())
    out["span_cost_ns"] = span_cost()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
