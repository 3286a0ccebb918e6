"""Time K1 fp32 (GroupNorm (+ SiLU) on fp32 input) of a package tree on one
Hopper card at every fp32 training row, on the card's clock:

- warm: CUDA events around 20 back-to-back calls enqueued behind a sleep
  that outlasts the host's enqueue, median of 5 (``chip_smoke.py:warm_ms``);
- cold: one call at a time behind a 512 MB write that flushes L2, median of
  20 (``chip_smoke.py:cold_ms``).

    python tools/k1_fp32_times.py [--root DIR] [--tag NAME]

The rows are the adapter norms the JAX rule admits at itemsize 4: SVD
(``k1_rows(14, 1, 4)``), I2VGen-XL (``k1_rows(16, 1, 4)``) and SDXL
(``sdxl_k1_rows(batch=1, itemsize=4)``), with and without SiLU. Each row is
first held to the plain version (within 1e-5 of its norm, ``FP32_TOL``) and
to itself over two calls (the same bits), then timed beside ``F.group_norm``
in fp32 (one call, the GroupNorm alone) and ``Tensor.copy_`` of x into a
tensor of its shape (one read and one write of the same bytes: what the
memory moves at this size). One JSON line a row, then one a model with the
sums over one adapter call's launches; each line carries the tree's tag,
the card's name and power limit and the bound from ``ops/roofline.py``.

``--root`` is the directory holding the ``ctrl_adapter_tpu_torch`` package to
time (default: this repository), e.g. an unpacked ``git archive`` of another
commit under ``build/``: its kernels are built from its own ``csrc/``, so two
trees can be timed in one call on one card, in turns. Imports nothing of
JAX.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="also time every ring launch that fits (threads, CTAs an SM) at "
                         "each SVD shape, with and without SiLU")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_fp32_times: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()
    import torch.nn.functional as F

    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import group_norm as gn
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"k1_fp32_times: imported the package from {_build.CSRC_DIR}, "
                         f"not from {root}")
    card = smoke.nvidia_smi_line()
    tag = args.tag or root
    _build.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    flush = torch.empty(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    models = (("svd", smoke.k1_rows(14, 1, 4)), ("i2vgenxl", smoke.k1_rows(16, 1, 4)),
              ("sdxl", smoke.sdxl_k1_rows(batch=1, itemsize=4)))
    for model, rows in models:
        sums = {"launches": 0, "bound_ms": 0.0, "warm_ms": 0.0, "cold_ms": 0.0,
                "group_norm_warm_ms": 0.0, "group_norm_cold_ms": 0.0}
        for (shape, silu), n in rows.items():
            x, w, b = rand(*shape), 1.0 + rand(shape[1], scale=0.1), rand(shape[1], scale=0.1)
            y = torch.empty_like(x)
            kernel = lambda: gn.group_norm_silu(x, w, b, 32, 1e-6, silu)  # noqa: E731
            label = f"({','.join(map(str, shape))})" + (" silu" if silu else "")
            got = kernel()
            err = smoke.compare(f"{tag}: K1 fp32 {label}", got,
                                gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu),
                                atol=1e-4, rtol=1e-4, rel_norm=smoke.FP32_TOL)
            if not torch.equal(got, kernel()):
                raise RuntimeError(f"{tag}: K1 fp32 {label}: two calls differ")
            del got
            library = lambda: F.group_norm(x, 32, w, b, 1e-6)  # noqa: E731
            copy = lambda: y.copy_(x)  # noqa: E731
            cost = rl.group_norm(shape, silu, 4)
            out = {"tree": tag, "model": model, "shape": label, "per_adapter_call": n,
                   "plan": gn.plan(shape, 32, itemsize=4).branch, "max_abs_err": err,
                   "warm_ms": smoke.warm_ms(kernel), "cold_ms": smoke.cold_ms(kernel, flush),
                   "group_norm_warm_ms": smoke.warm_ms(library),
                   "group_norm_cold_ms": smoke.cold_ms(library, flush),
                   "copy_warm_ms": smoke.warm_ms(copy), "copy_cold_ms": smoke.cold_ms(copy, flush),
                   "bound_ms": cost.bound_ms, "bound_by": cost.bound_by}
            out["cold_share"] = cost.bound_ms / out["cold_ms"]
            out["warm_share"] = cost.bound_ms / out["warm_ms"]
            print(json.dumps({**out, "card": card}), flush=True)
            sums["launches"] += n
            for key in ("bound_ms", "warm_ms", "cold_ms", "group_norm_warm_ms",
                        "group_norm_cold_ms"):
                sums[key] += n * out[key]
            del x, w, b, y
        print(json.dumps({"tree": tag, "model": model, "per_adapter_call": sums, "card": card}),
              flush=True)
    if args.sweep:
        sweep(smoke, gn, rl, rand, flush, tag, card,
              sorted({shape for shape, _ in models[0][1]}))
    return 0


def sweep(smoke, gn, rl, rand, flush, tag, card, shapes):
    """Every ring launch that fits at each shape, with and without SiLU
    (``gn.ring_plan``: 128 or 256 threads, 1-4 CTAs an SM), held to the plain version and to itself over two
    calls, then timed warm and cold: one JSON line each."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in shapes:
        x, w, b = rand(*shape), 1.0 + rand(shape[1], scale=0.1), rand(shape[1], scale=0.1)
        for silu in (False, True):
            want = gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu)
            seen = set()
            for threads in (128, 256):
                for ctas in (1, 2, 3, 4):
                    p = gn.ring_plan(shape, 32, threads, ctas, sms)
                    if not gn.ring_fits(p, ctas) or (threads, p.grid) in seen:
                        continue
                    seen.add((threads, p.grid))
                    run = lambda p=p: gn.launch(x, w, b, 32, 1e-6, silu, p)  # noqa: E731
                    got = run()
                    err = smoke.compare(f"{tag}: ring {shape} {threads} x {p.grid}", got, want,
                                        atol=1e-4, rtol=1e-4, rel_norm=smoke.FP32_TOL)
                    if not torch.equal(got, run()):
                        raise RuntimeError(f"{tag}: {shape} {p}: two calls differ")
                    bound = rl.group_norm(shape, silu, 4).bound_ms
                    warm, cold = smoke.warm_ms(run), smoke.cold_ms(run, flush)
                    print(json.dumps({
                        "tree": tag, "sweep": f"({','.join(map(str, shape))})", "silu": silu,
                        "threads": threads, "ctas_per_sm": ctas, "grid": p.grid,
                        "walk": p.groups_per_cta, "smem": p.smem_bytes, "max_abs_err": err,
                        "warm_ms": warm, "cold_ms": cold, "bound_ms": bound,
                        "cold_share": bound / cold, "card": card}), flush=True)
            del want
        del x, w, b

if __name__ == "__main__":
    sys.exit(main())
