"""Where a denoise step of the PyTorch port's SVD slice spends its time, on one card.

    python3 port_step_probe.py

Builds the same full-width bf16 pipeline as ``chip_smoke.py`` (random weights
from a seed; 14 frames at 512x512, CFG, latent skipping) and prints:

1. ms per tower call (ControlNet, Ctrl-Adapter, SVD UNet) inside controlled
   steps, from CUDA events recorded by forward hooks;
2. ms per step with the control towers on every step and on none, and the
   temporal-VAE decode seconds (host clock around a synchronize), in the order
   plain norms, K1 on every GroupNorm, K1 on every GroupNorm, plain norms (the
   slice runs K1 only on the adapter's norms, as the TPU did), REPS runs each;
3. how far the latents of the all-K1 run lie from the plain-norm run;
4. for one profiled controlled step (``torch.profiler``): the device idle share
   between the first and last kernel, and the 25 kernels that take the most time.

Every line stands beside the card's name and power limit. Needs a CUDA card of
capability >= 9.0; imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

import chip_smoke as cs

REPS = 3  # timed runs per measurement


def towers_ms(pipe, gen, steps: int):
    """ms of each call of each tower during ``gen(steps)``, from CUDA events."""
    events = {}
    handles = []
    for name in ("controlnet", "adapter", "unet"):
        module = getattr(pipe, name)

        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        gen(steps)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: [s.elapsed_time(e) for s, e in pairs] for name, pairs in events.items()}


def idle_share(gen):
    busy, span, by_name = cs.device_activity(lambda: gen(1))
    n = sum(calls for _, calls in by_name.values())
    return n, busy, span, sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]


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

    per = towers_ms(pipe, gen, 4)
    print(f"1. tower ms per call, 4 controlled steps, 1x{cs.FRAMES}x{cs.SIZE}^2, bf16, "
          f"on {card}:")
    for name, vals in per.items():
        print(f"   {name}: median {statistics.median(vals):.1f} {fmt(vals)}")

    norms = [m for tower in (pipe.unet, pipe.controlnet, pipe.vae) for m in tower.modules()
             if isinstance(m, GroupNorm) and not m.kernel]
    print(f"2. step and decode times on {card}; {len(norms)} plain GroupNorms outside "
          f"the adapter; {REPS} runs each:")
    for label in ("plain", "k1-all", "k1-all", "plain"):
        for m in norms:
            m.kernel = label == "k1-all"
        gen(1)  # warm the path once
        ctrl, unet, dec = ms_per_step(4, 1.0), ms_per_step(4, 0.0), decode_s()
        print(f"   {label}: controlled step {fmt(ctrl)} ms; UNet-only step {fmt(unet)} ms; "
              f"decode {fmt(dec, '%.3f')} s")

    for m in norms:
        m.kernel = True
    a = gen(2).float()
    for m in norms:
        m.kernel = False
    b = gen(2).float()
    print(f"3. all-K1 vs plain-norm latents, 2 controlled steps: max|diff|/max|plain| = "
          f"{((a - b).abs().max() / b.abs().max()).item():.3e}")

    n, busy, span, top = idle_share(gen)
    print(f"4. profiled controlled step on {card}: {n} kernels, busy {busy / 1000:.1f} ms "
          f"over a kernel span of {span / 1000:.1f} ms: device idle share "
          f"{1 - busy / span:.3%}")
    for name, (us, calls) in top:
        print(f"   {us / 1000:8.2f} ms {us / busy:6.1%} x{calls:4d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
