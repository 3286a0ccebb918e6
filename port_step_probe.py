"""Where a denoise step of the PyTorch port's SVD slice spends its time, on one card.

    python3 port_step_probe.py

Builds the same full-width bf16 pipeline as ``chip_smoke.py`` (random weights
from a seed; 14 frames at 512x512, CFG, latent skipping) and prints:

1. ms per tower call (ControlNet, Ctrl-Adapter, SVD UNet) inside controlled
   steps, from CUDA events recorded by forward hooks;
2. ms per step with the control towers on every step and on none, and the
   temporal-VAE decode seconds (host clock around a synchronize), in the order
   plain norms, K1 on every GroupNorm, K1 on every GroupNorm, plain norms (the
   slice runs K1 only on the adapter's norms that the JAX size rule admits, as
   the TPU did; "every GroupNorm" switches that rule off,
   ``chip_smoke.k1_everywhere``), REPS runs each;
3. how far the latents of the all-K1 run lie from the plain-norm run;
4. for one profiled controlled step (``torch.profiler``): the device idle share
   between the first and last kernel, and the 25 kernels that take the most time.

Every line stands beside the card's name and power limit. Needs a CUDA card of
capability >= 9.0; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import torch

import chip_smoke as cs

REPS = 3  # timed runs per measurement


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        raise SystemExit("port_step_probe: needs a CUDA card of capability >= 9.0")
    from ctrl_adapter_tpu_torch.nn.resnet import GroupNorm

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"card: {card}")
    pipe, _ = cs.build_pipeline(dev, bf)
    inputs = cs.slice_inputs(dev, bf, cs.FRAMES, cs.SIZE, cs.SEED + 1)
    kw = dict(height=cs.SIZE, width=cs.SIZE, num_frames=cs.FRAMES, skip_conv_in=True,
              control_latent_size=cs.SIZE // 8, device=dev, output_type="latent")

    def gen(steps, end=1.0):
        return pipe.generate(**inputs, num_inference_steps=steps, control_guidance_end=end,
                             **kw)

    def ms_per_step(steps, end):
        out = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen(steps, end)
            torch.cuda.synchronize()
            out.append(1000 * (time.perf_counter() - t0) / steps)
        return out

    def decode_s():
        lat = gen(1, 0.0)
        out = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe._decode(lat, 0.18215)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    gen(2)  # warm-up: kernel build, cuDNN and cuBLAS choices
    fmt = lambda vals, f="%.1f": "[" + ", ".join(f % v for v in vals) + "]"  # noqa: E731

    per = cs.tower_ms({n: getattr(pipe, n) for n in ("controlnet", "adapter", "unet")},
                      lambda: gen(4))
    print(f"1. tower ms per call, 4 controlled steps, 1x{cs.FRAMES}x{cs.SIZE}^2, bf16, "
          f"on {card}:")
    for name, vals in per.items():
        print(f"   {name}: median {statistics.median(vals):.1f} {fmt(vals)}")

    norms = [m for tower in (pipe.unet, pipe.controlnet, pipe.vae) for m in tower.modules()
             if isinstance(m, GroupNorm) and m.kernel is None]

    def k1_all(on: bool):
        """K1 on every GroupNorm (the JAX size rule off), or the slice's dispatch."""
        for m in norms:
            m.kernel = "prefer" if on else None
        return cs.k1_everywhere() if on else contextlib.nullcontext()

    print(f"2. step and decode times on {card}; {len(norms)} plain GroupNorms outside "
          f"the adapter; {REPS} runs each:")
    for label in ("plain", "k1-all", "k1-all", "plain"):
        with k1_all(label == "k1-all"):
            gen(1)  # warm the path once
            ctrl, unet, dec = ms_per_step(4, 1.0), ms_per_step(4, 0.0), decode_s()
        print(f"   {label}: controlled step {fmt(ctrl)} ms; UNet-only step {fmt(unet)} ms; "
              f"decode {fmt(dec, '%.3f')} s")

    with k1_all(True):
        a = gen(2).float()
    with k1_all(False):
        b = gen(2).float()
    print(f"3. all-K1 vs plain-norm latents, 2 controlled steps: max|diff|/max|plain| = "
          f"{((a - b).abs().max() / b.abs().max()).item():.3e}")

    cs.print_activity(f"4. profiled controlled step on {card}: ",
                      cs.device_activity(lambda: gen(1)), top=25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
