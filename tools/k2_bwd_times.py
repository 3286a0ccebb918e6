"""Time K2's backward (bf16) of a package tree on one Hopper card at the 11
shapes of ``PERF.md``'s two K2 bwd rows, on the card's clock:

- warm: CUDA events around 20 back-to-back calls enqueued behind a sleep
  that outlasts the host's enqueue, median of 5 (``chip_smoke.py:warm_ms``);
- cold: one call at a time behind a 512 MB write that flushes L2, median of
  20 (``chip_smoke.py:cold_ms``).

    python tools/k2_bwd_times.py [--root DIR] [--tag NAME] [--library]

The shapes are ``chip_smoke.K2_BWD_SHAPES`` (the SVD training step's two and
H = 128) and the backward rows of the I2VGen-XL and SDXL training steps at
batch 1 (``i2v_flash_rows``, ``sdxl_flash_rows``), each with its launches
per training step. Each call's inputs come from one seeded generator; the
gradients are first held to the plain version (``chip_smoke.k2_bwd_row``'s
tolerances) and two calls compared bit for bit (dQ, dK, dV each, with dQ's
max difference), then timed beside the bound from ``ops/roofline.py`` and,
with ``--library``, SDPA's flash and cuDNN backward (``sdpa_bwd_times``,
CUDA events around 10 calls, forward and backward less the forward). One
JSON line a shape, then one with the sums over each training step's
launches; each line carries the tree's tag and the card's name and power
limit.

``--root`` is the directory holding the ``ctrl_adapter_tpu_torch`` package to
time (default: this repository), e.g. an unpacked ``git archive`` of another
commit under ``build/``: its kernels are built from its own ``csrc/``, so two
trees can be timed in one call on one card, in turns (parent, change,
change, parent), one process each. Only the entry points both trees share
are called (``_forward``, ``attention_bnth_bwd``, ``_torch_attention_bwd``).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This repository's ``chip_smoke.py`` (its timers and row lists), loaded
    by path."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(smoke) -> list:
    """(shape, model, launches per training step) of the 11 rows."""
    rows = [(s, "svd", n) for s, n in zip(smoke.K2_BWD_SHAPES, smoke.K2_BWD_PER_STEP)]
    for model, flash in (("i2vgenxl", smoke.i2v_flash_rows(batch=1)),
                         ("sdxl", smoke.sdxl_flash_rows(batch=1))):
        rows += [(s, model, r["train_bwd"]) for s, r in flash.items() if r["train_bwd"]]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--library", action="store_true",
                    help="also time SDPA's flash and cuDNN backward at each shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd_times: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()

    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"k2_bwd_times: imported the package from {_build.CSRC_DIR}, "
                         f"not from {root}")
    card = smoke.nvidia_smi_line()
    tag = args.tag or root
    _build.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sums = {}
    for (b, n, t, h), model, per_step in shapes(smoke):
        label = f"({b},{n},{t},{h})"
        q, k, v, do = (torch.randn(b, t, n * h, generator=g, device=dev).to(torch.bfloat16)
                       .view(b, t, n, h).transpose(1, 2) for _ in range(4))
        o, lse = fa._forward(q, k, v, True)
        bwd = lambda: fa.attention_bnth_bwd(q, k, v, o, do, lse)  # noqa: E731
        got, again = bwd(), bwd()
        want = fa._torch_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        err = max(smoke.compare(f"{tag}: K2 backward {label} d{name}", x, y,
                                atol=5e-2 * y.abs().max().item(), rtol=5e-2, rel_norm=2e-2)
                  for name, x, y in zip("qkv", got, want))
        out = {"tree": tag, "model": model, "shape": label, "per_training_step": per_step,
               "max_abs_err": err,
               **{f"d{name}_same_bits": torch.equal(x, y)
                  for name, x, y in zip("qkv", got, again)},
               "dq_max_diff": (got[0].float() - again[0].float()).abs().max().item()}
        del got, again, want
        cost = rl.attention_bwd(b, n, t, h)
        out.update(warm_ms=smoke.warm_ms(bwd), cold_ms=smoke.cold_ms(bwd, flush),
                   bound_ms=cost.bound_ms, bound_by=cost.bound_by)
        out["warm_share"] = cost.bound_ms / out["warm_ms"]
        if args.library:
            out.update(smoke.sdpa_bwd_times(q, k, v, do))
        print(json.dumps({**out, "card": card}), flush=True)
        step = sums.setdefault(model, {"launches": 0, "bound_ms": 0.0, "warm_ms": 0.0,
                                       "cold_ms": 0.0})
        step["launches"] += per_step
        for key in ("bound_ms", "warm_ms", "cold_ms"):
            step[key] += per_step * out[key]
        del q, k, v, do, o, lse
    print(json.dumps({"tree": tag, "per_training_step": sums, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
