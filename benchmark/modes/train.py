"""The ``train`` mode: the family's training step back to back.

Set-up builds one trainer (the program's ``CtrlAdapterTrainer``: frozen
towers, the trainable adapter with its fp32 masters and AdamW state) on
weights drawn from the seed, and drives it through the traffic's
``checked_steps`` first steps with ``train_step``, the window's own call, each
on a fresh batch and fresh noise drawn from the seed. It keeps each of those
steps' loss, the norm of each leaf of the first gradient as the optimizer got
it (AdamW's first moment after one step over 1 - beta1) and of each leaf's
change over the checked steps. The same trainer then runs in the window,
steps after step, each on new rows; a step starts only while the previous
step's time still fits, and there is always one.

The check, once the window has closed and the program is freed: the float32
reference rebuilds the towers from the seed and takes the same steps on the
same batches and noise. Compared: the checked steps' widest relative loss
gap; by its worst leaf, the gap between the program's norm and the
reference's, over the larger of the reference leaf's norm and the median
leaf's, for the first gradient and for the change; and the median leaf's gap
of the change. Leaves whose reference gradient is under a thousandth of the
median leaf's move by weight decay and round-off alone and are left out of
the change.

With ``--trace 1`` the window times the loss (``loss_and_weights``) and the
backward (from the loss's end to the optimizer's start) with CUDA events, and
one step then runs under the profiler, traced three times, the third with the
program's spans recorded (``harness/profile.py``).

A cell of several cards runs this on each rank (``harness/ranks.py``), the
trainer built with the group, so that its gradients are averaged over the
ranks before the optimizer. Each rank draws its own batches and noise (the
keys get the rank), and rank 0 decides whether another step fits in the
window and tells the others (one one-element broadcast a step, outside
``train_step``), so that every rank takes the same steps. Rank 0's window
and steps give the step time, the fullest card the peak. The check adds
``masters_equal``: after each checked step, the number of ranks whose fp32
masters are not rank 0's to the bit (exact, 0). The reference takes each
rank's steps on that rank's batches and averages its gradients over the
ranks in fp32 before the clip and AdamW, as the program does; the loss
compared is the mean over the ranks, the leaves are rank 0's. With
``--trace 1`` the trainer's flat all-reduce is also timed alone, on a buffer
of the gradients' size, every rank waiting for the others before each
(``exchange_ms``): the exchange without the wait for the last rank that the
step's all-reduce holds.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from harness import compare, flops, profile, seeds
from harness.manifest import check_traffic, kernel_ops
from harness.ranks import Ranks
from harness.peaks import BF16_FLOPS
from modes.generate import _sync, device_info, read_metrics

TRAFFIC = ("checked_steps",)  # the traffic mix's settings this mode reads
GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient are not compared


def _median(xs: List[float]) -> float:
    return float(torch.tensor(xs).median())


class StepTimer:
    """CUDA events around each step's loss and from its end to the optimizer."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.events: Dict[str, List[torch.cuda.Event]] = {"loss_start": [], "loss_end": [],
                                                           "opt_start": []}
        self._loss, self._opt = trainer.loss_and_weights, trainer.optimizer.step
        trainer.loss_and_weights = self._timed_loss
        trainer.optimizer.step = self._timed_opt

    def _mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name].append(ev)

    def _timed_loss(self, *args, **kwargs):
        self._mark("loss_start")
        out = self._loss(*args, **kwargs)
        self._mark("loss_end")
        return out

    def _timed_opt(self, *args, **kwargs):
        self._mark("opt_start")
        return self._opt(*args, **kwargs)

    def close(self) -> Dict[str, List[float]]:
        del self.trainer.loss_and_weights, self.trainer.optimizer.step
        self.trainer = None
        torch.cuda.synchronize()
        e = self.events
        return {"forward": [a.elapsed_time(b) for a, b in zip(e["loss_start"], e["loss_end"])],
                "backward": [a.elapsed_time(b) for a, b in zip(e["loss_end"], e["opt_start"])]}


def _leaf_norms(tensors) -> List[float]:
    return [torch.linalg.vector_norm(t.float()).item() for t in tensors]


def _gaps(got: List[float], want: List[float], keep=None) -> List[float]:
    """Each kept leaf's gap of the norms over the larger of its reference norm
    and the median leaf's."""
    keep = range(len(want)) if keep is None else keep
    floor = _median([want[i] for i in keep])
    return [abs(got[i] - want[i]) / max(want[i], floor) for i in keep]


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, log=print,
        control=None, group=None) -> dict:
    fam = cell.family()
    cfg, traffic = cell.config, cell.traffic
    check_traffic(traffic, TRAFFIC)
    tc = cfg["train"]["config"]
    checked = traffic["checked_steps"]
    ranks = Ranks(group, dev)
    rank = () if ranks.world == 1 else ("rank", ranks.rank)

    def step_inputs(k):
        return fam.train_inputs(cfg, dev, seeds.generator(dev, seed, "step", k, *rank))

    trainer, n_params = fam.build_trainer(cfg, dev, seed, process_group=group)
    opt = trainer.optimizer
    names = list(trainer.names)
    start = [m.detach().clone() for m in opt.masters]
    losses, norms, grad1, differ = [], [], None, 0
    for k in range(checked):
        batch, draws = step_inputs(k)
        out = trainer.train_step(batch, draws=draws)
        losses.append(out["loss"].item())
        norms.append(out["grad_norm"].item())
        differ += ranks.differ(opt.masters)
        if k == 0:  # an optimizer that took no step holds no moment: a zero gradient
            grad1 = _leaf_norms(opt.adamw.state.get(m, {}).get("exp_avg", torch.zeros(1))
                                / (1 - tc["adam_beta1"]) for m in opt.masters)
    change = _leaf_norms(m - s for m, s in zip(opt.masters, start))
    del start
    ranks.all(True)  # every rank's set-up is done
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({n_params} parameters; losses {losses}, gradient norms "
        f"{norms})")

    timer = StepTimer(trainer) if trace else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    _sync(dev)
    t0 = time.perf_counter()
    while ranks.lead(not times or (time.perf_counter() - t0) + times[-1] <= seconds):
        batch, draws = step_inputs(checked + len(times))
        c0 = time.perf_counter()
        trainer.train_step(batch, draws=draws)["loss"].item()
        times.append(time.perf_counter() - c0)
    steps = len(times)
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = ranks.max(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    record = {"window_s": window_s, "steps": steps,
              "step_ms": timer.close() if timer else {}}
    log(f"window {window_s:.3f} s, {steps} steps (each {min(times):.4f}-{max(times):.4f} s, "
        f"median {sorted(times)[steps // 2]:.4f}), peak {peak} bytes"
        + (f"; steps by rank {ranks.gather(steps)}" if group is not None else ""))

    segment = None
    if trace:
        if group is not None:
            record["exchange_ms"] = exchange_ms(sum(m.numel() for m in opt.masters), dev, ranks)
        batch, draws = step_inputs("profile")
        timed = profile.trace(lambda: trainer.train_step(batch, draws=draws), kernel_ops(),
                              log=log, agree=ranks.all)
        named = profile.trace(lambda: trainer.train_step(batch, draws=draws), kernel_ops(),
                              host=True, log=log, agree=ranks.all)
        spanned = profile.trace(lambda: trainer.train_step(batch, draws=draws), kernel_ops(),
                                log=log, agree=ranks.all, spans=True)
        if timed is not None and named is not None and spanned is not None:
            timed.idle_gaps = profile.named_gaps(timed, named)
            timed.spans = spanned.spans
            segment = timed
        record["segment"] = segment
        record["spans"] = segment.spans if segment is not None else None
        record["step_flops"] = flops.train_step_flops(fam, cfg)
        record["peak_flops"] = BF16_FLOPS
    del trainer, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    program = {"losses": ranks.mean(losses), "norms": norms, "grad1": grad1, "change": change}
    ref = reference_steps(fam, cfg, dev, seed, checked, step_inputs, ranks=ranks)
    numbers = compare_steps(program, ref)
    if group is not None:
        numbers["masters_equal"] = float(differ)
    ok, checks = compare.judge(numbers, cell.limits())
    log(f"check {time.perf_counter() - t_check:.1f} s; losses {program['losses']}, "
        f"reference's {ref['losses']}" + " (means over the ranks)" * (group is not None)
        + f"; gradient norms {norms}, reference's {ref['norms']}")
    for key in ("grad1", "change"):
        log(f"{key}: median leaf {_median(program[key]):.4e}, reference's "
            f"{_median(ref[key]):.4e}; widest gaps: " + ", ".join(
                f"{names[i]} {program[key][i]:.4e} vs {ref[key][i]:.4e}"
                for i in worst_leaves(program[key], ref[key])))

    result = {"correct": ok, "attempted": steps, "failed": 0 if ok else 1}
    if trace:
        result["metrics"] = read_metrics(cell, record)
    else:
        e2e = {"train_step_ms": 1000 * window_s / steps, "peak_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device_info(dev, cell.chips, peak)
    if segment is not None:  # busy and traced time averaged over the cards
        busy_s, span_s = ranks.mean([segment.busy_s, segment.span_s])
        result["device"].update(busy_s=busy_s, window_s=span_s)
        result["breakdown"] = {"device_ops": profile.top(segment.device_ops),
                               "idle_gaps": profile.top(segment.idle_gaps)}
    if control is not None:
        result["control"] = compare_steps(
            reference_steps(fam, cfg, dev, seed, checked, step_inputs, control, ranks), ref)
    result["checks"] = checks
    return result


def exchange_ms(numel: int, dev, ranks: Ranks, repeats: int = 5) -> float:
    """The median ms of the trainer's flat fp32 all-reduce (the program's
    ``all_reduce_mean_``) of ``numel`` elements, each call started once every
    rank has arrived: CUDA events on the card, the host's clock on the CPU."""
    from ctrl_adapter_tpu_torch.parallel.mesh import all_reduce_mean_

    flat = torch.ones(numel, dtype=torch.float32, device=dev)
    times = []
    for i in range(repeats + 1):  # the first call sets NCCL's buffers up
        ranks.all(True)
        _sync(dev)
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            all_reduce_mean_(flat, ranks.group)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            all_reduce_mean_(flat, ranks.group)
            ms = 1000.0 * (time.perf_counter() - t0)
        times.append(ms)
    return _median(times[1:])


def reference_steps(fam, cfg, dev, seed, checked, step_inputs, control=None,
                    ranks: Ranks = None) -> dict:
    """The float32 reference's losses (averaged over the ``ranks``), first-gradient
    and change norms per leaf over the checked steps, TF32 off, each step's
    gradients averaged over the ranks; with ``control``, of the control."""
    ranks = ranks or Ranks(None, dev)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        towers = fam.reference_towers(cfg, dev, seed)
        if control is not None:
            control(towers)
        ref = fam.reference_trainer(towers, cfg)
        start = [m.detach().clone() for m in ref.masters]
        losses, norms, grad1 = [], [], None
        for k in range(checked):
            value, grads, norm = ref.step(*step_inputs(k), reduce=ranks.average)
            losses.append(value)
            norms.append(norm)
            if k == 0:
                grad1 = _leaf_norms(grads)
            del grads
        change = _leaf_norms(m.detach() - s for m, s in zip(ref.masters, start))
        return {"losses": ranks.mean(losses), "norms": norms, "grad1": grad1, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()


def worst_leaves(got: List[float], want: List[float], n: int = 4) -> List[int]:
    floor = _median(want)
    return sorted(range(len(want)), key=lambda i: -abs(got[i] - want[i]) / max(want[i], floor))[:n]


def loss_gap(got: dict, want: dict) -> float:
    """The checked steps' widest relative loss gap."""
    return max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))


def compare_steps(got: dict, want: dict) -> Dict[str, float]:
    """The loss gap, the worst leaf's gap of the first gradient and of the
    change, and the median leaf's gap of the change, which is steady where the
    worst is one small leaf's round-off (PERF.md)."""
    floor = GRAD_FLOOR * _median(want["grad1"])
    moved = [i for i, g in enumerate(want["grad1"]) if g >= floor]
    change = _gaps(got["change"], want["change"], moved)
    return {"loss": loss_gap(got, want), "grad1": max(_gaps(got["grad1"], want["grad1"])),
            "change": max(change), "change_median": _median(change)}
