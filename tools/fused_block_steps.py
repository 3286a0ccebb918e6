"""ms per denoise step of the SVD slice with and without ``CTRL_ADAPTER_FUSED_BLOCK=1``
(kernel K4 on the 320-wide FFs), for one package tree on one Hopper card.

    python tools/fused_block_steps.py [--root DIR] [--tag NAME] [--runs N]

Builds the slice of ``chip_smoke.py`` (full width, bf16, seeded random
weights, 14 frames at 512x512, CFG, latent skipping) from the
``ctrl_adapter_tpu_torch`` package under ``--root`` (default: this
repository; e.g. an unpacked ``git archive`` of another commit, whose kernels
build into its own ``build/kernels/``), then runs ``generate()`` to the
latents for 2 steps (1 controlled, as ``chip_smoke.py`` phase 5), alternately
with and without the switch, ``--runs`` times each after one warm-up of each:

- on the host clock around ``torch.cuda.synchronize()``: ms per step;
- under ``torch.profiler`` (a second set of runs, ``chip_smoke.py:device_activity``):
  the device's busy time per step (the union of its kernels' spans), the
  device idle share between the first and last kernel, and K4's device time
  per step (kernels named ``ln_ff_kernel``).

Prints every run and the medians as one JSON line with the card's name and
power limit. The host clock of this step spreads by more than K4's saving;
the busy time does not see the host. Compare two trees only within one call.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_block_steps: no CUDA device")
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(_REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ctrl_adapter_tpu_torch.ops import _build

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"fused_block_steps: imported the package from {_build.CSRC_DIR}, "
                         f"not from {root}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    pipe, _ = smoke.build_pipeline(dev, bf)
    inputs = smoke.slice_inputs(dev, bf, smoke.FRAMES, smoke.SIZE, smoke.SEED + 1)
    kw = dict(height=smoke.SIZE, width=smoke.SIZE, num_frames=smoke.FRAMES, skip_conv_in=True,
              control_latent_size=smoke.SIZE // 8, device=dev)

    def under(name, fn):
        if name == "fused_block":
            with smoke.env_switch("CTRL_ADAPTER_FUSED_BLOCK"):
                return fn()
        return fn()

    names = ("fused_block", "default")
    runs = {n: [] for n in names}
    device = {n: {"busy_ms_per_step": [], "idle_share": [], "k4_ms_per_step": []}
              for n in names}
    with torch.no_grad():
        for i in range(args.runs + 1):  # the first of each is a warm-up
            for name in names:
                ms, _ = under(name, lambda: smoke.ms_per_step(pipe, inputs, kw, STEPS))
                if i:
                    runs[name].append(ms)
        for _ in range(args.runs):
            for name in names:
                busy, span, per_name = under(name, lambda: smoke.device_activity(
                    lambda: pipe.generate(**inputs, **kw, num_inference_steps=STEPS,
                                          output_type="latent")))
                k4 = sum(us for kname, (us, _) in per_name.items() if "ln_ff_kernel" in kname)
                d = device[name]
                d["busy_ms_per_step"].append(busy / 1000 / STEPS)
                d["idle_share"].append(1 - busy / span)
                d["k4_ms_per_step"].append(k4 / 1000 / STEPS)
    print(json.dumps({"tree": args.tag or root, "steps": STEPS, "runs": runs,
                      "median_ms": {k: statistics.median(v) for k, v in runs.items()},
                      "device": device,
                      "device_median": {n: {k: statistics.median(v) for k, v in d.items()}
                                        for n, d in device.items()},
                      "card": smoke.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
