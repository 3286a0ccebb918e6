"""Readings of a cell by the program's spans: one run of the cell as
``run.py --trace 1`` makes it, with the program's span recording
(``ctrl_adapter_tpu_torch/utils/profiling.py``) open around each profiled
segment, and each segment's trace set beside the spans
(``harness/spans.py``). The benchmark's own runs never open the recording.

    python3 benchmark/spans.py --workload <name> --seed <n> --seconds <s>

Standard error gets the span table of the profiled segment (weighted to a
clip, or one training step). Standard output gets one line of JSON:
``span_metrics`` (the readers ``metrics/plain_norm_ms.generate.py``,
``plain_attention_ms.generate.py``, ``launches.generate.py``,
``optimizer_ms.train.py``, ``recompute_ms.train.py``, ``launches.train.py``
on that table, and the same on the host-traced segment under ``named``),
``coverage`` (the share of the device time that falls under the outermost
spans), ``agreement`` (span intervals beside the hooks' timings of the same
run), ``span_cost_ns`` (a span's host cost with the recording off and on),
and the run's own ``metrics``, ``device`` and ``correct``.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
from collections import Counter  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402

READERS = ("plain_norm_ms.generate", "plain_attention_ms.generate", "launches.generate",
           "optimizer_ms.train", "recompute_ms.train", "launches.train")
ROOTS = {"generate": ("pipeline.generate", "pipeline.decode"), "train": ("trainer.step",)}


def recorded_trace(original, tables):
    """``profile.trace`` with the program's recording open around it; the
    accepted trace's span table (None for none) goes into ``tables`` with
    whether the host was traced."""
    import torch

    from ctrl_adapter_tpu_torch.utils import profiling
    from harness import spans

    def trace(fn, ops, host=False, attempts=3, log=print):
        kept = []

        class Keeping(torch.profiler.profile):
            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                kept.append(self)
                return out

        saved, torch.profiler.profile = torch.profiler.profile, Keeping
        try:
            with profiling.recording() as rec:
                segment = original(fn, ops, host, attempts, log)
        finally:
            torch.profiler.profile = saved
        table = None
        if segment is not None:
            kernels, launches, start = spans.trace_events(kept[-1])
            table = spans.attribute(rec.spans, kernels, launches, since_ns=start)
            lost = Counter(n for _, _, n, c in kernels if c not in launches)
            if lost:
                log(f"spans: {sum(lost.values())} device events without their launch: "
                    f"{lost.most_common(3)}")
        tables.append((host, table))
        return segment

    return trace


def weighted(cell, tables):
    """The timed (device-only) tables as the mode weights its segment: one
    training step, or the profiled steps scaled to a clip plus the decode."""
    timed = [t for host, t in tables if not host]
    named = [t for host, t in tables if host]
    if cell.traffic["mode"] == "train":
        return timed[0], named[0]
    if None in timed + named:
        return None, None
    mode = cell.mode()
    g = cell.config["generate"]
    (lo, hi), _ = mode.control_steps(g)
    (plo, phi), _ = mode.control_steps(g, cell.traffic["profile_steps"])
    w = (hi - lo) / (phi - plo)
    return timed[0].scaled(w) + timed[1], named[0].scaled(w) + named[1]


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
    args = run.parser().parse_args(argv)
    sys.path[:0] = [run.BENCH_DIR, run.ROOT]
    import torch

    from harness import env, profile
    from harness.manifest import load_cell, load_module

    env.prepare(run.ROOT)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log("span readings need a CUDA card")
        return 2
    readers = {name: load_module(os.path.join(run.BENCH_DIR, "metrics", name + ".py"))
               for name in READERS}
    tables = []
    profile.trace = recorded_trace(profile.trace, tables)
    result = cell.mode().run(cell, args.seed, args.seconds, True, torch.device("cuda", 0),
                             T_START, run.log)
    table, named = weighted(cell, tables)
    out = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"], "span_metrics": readings(table, readers),
           "named": readings(named, readers)}
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
