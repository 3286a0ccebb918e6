"""Time the port's feed-forward kernels (K3 full, K4, K5), K2's serving
forward (no log-sum-exp) and K2's backward of a package tree on one Hopper
card, at the SVD slice's shapes, on three clocks:

- host-inclusive: CUDA events around 10 back-to-back calls, median of 5
  (``chip_smoke.py:cuda_ms``);
- device, warm L2: the kernels' device times under ``torch.profiler``
  (``chip_smoke.py:kernel_times``);
- device, cold L2: one call at a time behind a 512 MB write that flushes L2
  (``chip_smoke.py:cold_ms``).

    python tools/ff_kernel_times.py [--root DIR] [--tag NAME] [--only "K3 full" K4 K5 K2 "K2 bwd"]

``--root`` is the directory holding the ``ctrl_adapter_tpu_torch`` package to
time (default: this repository), e.g. an unpacked ``git archive`` of another
commit: its kernels are built from its own ``csrc/`` into its own
``build/kernels/``, so two trees can be timed in one run on one card, in
turns. The inputs and tolerances are ``chip_smoke.py``'s (``k3_full_inputs``,
``k4_inputs``, ``k5_inputs``, ``FF_TOL``; K2 at (28, 5, 4096, 64) on head-split
views, as phase 3 times it; K2's backward at the training step's two shapes,
``K2_BWD_SHAPES``, from the timed tree's own forward output and log-sum-exp,
each gradient held as phase 3 holds it): each row is checked against its
plain version first and printed as one JSON line with the tree's tag, the
card's name and power limit, and the bound from the timed tree's
``ops/roofline.py``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This repository's ``chip_smoke.py`` (its timing helpers), loaded by path."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--only", nargs="+", choices=("K3 full", "K4", "K5", "K2", "K2 bwd"),
                    help="time these kernels only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ff_kernel_times: no CUDA device")
    smoke = _smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"ff_kernel_times: imported the package from {_build.CSRC_DIR}, "
                         f"not from {root}")
    card = smoke.nvidia_smi_line()
    tag = args.tag or root
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    flush = torch.empty(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)

    # chip_smoke.py's inputs and tolerances. A tree from before the exact-gelu
    # switch reached the port takes no ``approximate`` in temporal_block_full.
    rows = []
    x, cb, full_args = smoke.k3_full_inputs(rand)
    if "approximate" in inspect.signature(ft.temporal_block_full).parameters:
        full_args += (True,)
    rows.append(("K3 full", "UNet L0 (2,14,4096,320)",
                 lambda: ft.temporal_block_full(x, cb, *full_args),
                 lambda: ft._torch_temporal_block(x, cb, *full_args),
                 smoke.FF_TOL["temporal_block_full"],
                 rl.temporal_block_full(2, 14, 4096, 320, 320, 1280, True)))
    xk4, wk4 = smoke.k4_inputs(rand)
    rows.append(("K4", "(114688,320) inner 1280",
                 lambda: fb.ln_ff_kernel(xk4, *wk4, 1e-5, True, True),
                 lambda: fb._torch_ln_ff_residual(xk4, *wk4, 1e-5, True, True),
                 smoke.FF_TOL["ln_ff_residual"], rl.ln_ff(114688, 320, 1280, 320, True)))
    for m, c in smoke.K5_SHAPES:
        x5, w5, b5 = smoke.k5_inputs(rand, m, c)
        rows.append(("K5", f"({m},{c}) -> 2x{4 * c}",
                     lambda x5=x5, w5=w5, b5=b5: ff.geglu_kernel(x5, w5, b5, True),
                     lambda x5=x5, w5=w5, b5=b5: ff._torch_geglu(x5, w5, b5, True),
                     smoke.FF_TOL["geglu"], rl.geglu(m, c, 4 * c)))
    q, k, v = (rand(28, 4096, 320).to(torch.bfloat16).view(28, 4096, 5, 64).transpose(1, 2)
               for _ in range(3))
    rows.append(("K2", "(28,5,4096,64)", lambda: fa.attention_bnth(q, k, v),
                 lambda: fa._torch_attention(q, k, v), (1e-2, 2e-2, 1e-2),
                 rl.attention(28, 5, 4096, 4096, 64)))
    for b_, n_, t_, h_ in smoke.K2_BWD_SHAPES[:2]:
        qb, kb, vb, dob = (rand(b_, t_, n_ * h_).to(torch.bfloat16).view(b_, t_, n_, h_)
                           .transpose(1, 2) for _ in range(4))
        ob, lb = fa._forward(qb, kb, vb, True)
        # atol None: 5e-2 of the plain gradient's largest magnitude, as phase 3
        rows.append(("K2 bwd", f"({b_},{n_},{t_},{h_})",
                     lambda a=(qb, kb, vb, ob, dob, lb): fa.attention_bnth_bwd(*a),
                     lambda a=(qb, kb, vb, ob, dob, lb): fa._torch_attention_bwd(*a),
                     (None, 5e-2, 2e-2), rl.attention_bwd(b_, n_, t_, h_)))
    if args.only:
        rows = [r for r in rows if r[0] in args.only]

    for name, shape, kernel, plain, (atol, rtol, rel), cost in rows:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs = zip("qkv", got, want) if isinstance(got, tuple) else [("", got, want)]
        err = max(smoke.compare(f"{tag}: {name} {shape}" + (f" d{g}" if g else ""), x, y,
                                5e-2 * y.abs().max().item() if atol is None else atol, rtol, rel)
                  for g, x, y in pairs)
        del got, want, pairs
        host = smoke.cuda_ms(kernel)
        warm, cold = smoke.device_times(kernel, flush)
        print(json.dumps({"tree": tag, "kernel": name, "shape": shape, "host_ms": host,
                          "device_warm_ms": warm, "device_cold_ms": cold,
                          "bound_ms": cost.bound_ms, "bound_by": cost.bound_by,
                          "max_abs_err": err, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
