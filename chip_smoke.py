"""Chip smoke test of the PyTorch port: the SVD control path on one Hopper card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero before its last line):
1. check for a CUDA card of capability >= (9, 0) and print its name and power
   limit as nvidia-smi reports them;
2. build the CUDA kernels from ``ctrl_adapter_tpu_torch/csrc`` (nvcc, sm_90a);
3. compare each kernel with its plain PyTorch version on the card, in bf16, at
   the main path's shapes, and time both (CUDA-event medians);
4. run the slice: ``SVDControlNetAdapterPipeline`` at full width (SVD UNet
   320/640/1280/1280, SD-v1.5 ControlNet, the 13-block adapter at A-D + M, the
   temporal VAE) in bf16 with weights drawn from a seeded generator, 14 frames
   at 512x512, a few Euler steps with CFG and latent skipping, then decode;
   check the video and that every kernel was launched; then, on a small input,
   check the kernel path against an fp32 reference of the same weights;
5. print the per-kernel JSON line, the card line, and the result line.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
STEPS = 4
FRAMES = 14
SIZE = 512


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    bound = atol + rtol * want.abs()
    ok = bool((err <= bound).all())
    print(f"  {name}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
          f"(tolerance |err| <= {atol} + {rtol}*|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_err


# ------------------------------------------------------------------ kernels
def check_kernels(dev, card):
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    results = {}

    # K1: the adapter's GroupNorm(+SiLU) shapes; bf16 output, fp32 statistics.
    print(f"K1 group_norm_silu (bf16, G=32, eps 1e-6) on {card}")
    k1 = []
    cases = [("(28,320,64,64) silu", (28, 320, 64, 64), True, False),
             ("(2,320,14,64,64) silu", (2, 320, 14, 64, 64), True, False),
             ("(28,320,64,64) near-constant groups", (28, 320, 64, 64), False, True)]
    for label, shape, silu, flat in cases:
        x = rand(*shape)
        if flat:  # half the groups: 0.1 + 1e-4 noise, variance far below eps
            x[:, : shape[1] // 2] = 0.1 + 1e-4 * x[:, : shape[1] // 2]
        x = x.to(bf)
        w, b = (1.0 + rand(shape[1], scale=0.1)).to(bf), rand(shape[1], scale=0.1).to(bf)
        got = gn.group_norm_silu(x, w, b, 32, 1e-6, silu)
        want = gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu)
        torch.cuda.synchronize()
        err = compare(f"K1 {label}", got, want, atol=1e-2, rtol=1e-2)
        ms = cuda_ms(lambda: gn.group_norm_silu(x, w, b, 32, 1e-6, silu))
        pms = cuda_ms(lambda: gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu))
        print(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
        k1.append((err, ms, pms))
    results["group_norm_silu"] = k1

    # K2: self-attention of the UNet and adapter spatial blocks, H = 64, on
    # head-split views of (B, T, N*H) projections as the Attention module passes.
    print(f"K2 flash attention (bf16, fp32 softmax) on {card}")
    k2 = []
    for b_, n_, t_ in ((28, 5, 4096), (28, 10, 1024)):
        q, k, v = (rand(b_, t_, n_ * 64).to(bf).view(b_, t_, n_, 64).transpose(1, 2)
                   for _ in range(3))
        got = fa.attention_bnth(q, k, v)
        # the plain version runs the batch in chunks of ~1 GiB of fp32 logits
        want = fa._torch_attention(q, k, v)
        torch.cuda.synchronize()
        err = compare(f"K2 ({b_},{n_},{t_},64)", got, want, atol=1e-2, rtol=2e-2)
        ms = cuda_ms(lambda: fa.attention_bnth(q, k, v))
        pms = cuda_ms(lambda: fa._torch_attention(q, k, v), iters=3, warmup=1)
        print(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
        k2.append((err, ms, pms))
    results["flash_attention"] = k2

    # K3: temporal attention sub-block with cross bias.
    print(f"K3 temporal attention block (bf16, f=14, head_dim 64, cross bias) on {card}")
    k3 = []
    for label, (b_, f_, s_, c_, heads) in (("UNet (2,14,4096,320) 5 heads", (2, 14, 4096, 320, 5)),
                                           ("UNet (2,14,64,1280) 20 heads", (2, 14, 64, 1280, 20)),
                                           ("adapter c=512 ia=320 s=4096", (2, 14, 4096, 512, 5))):
        ia = heads * 64
        x = rand(b_, f_, s_, c_).to(bf)
        cb = rand(b_, s_, c_, scale=0.5).to(bf)
        args = ((1.0 + rand(c_, scale=0.1)).to(bf), rand(c_, scale=0.1).to(bf),
                rand(ia, c_, scale=c_ ** -0.5).to(bf), rand(ia, c_, scale=c_ ** -0.5).to(bf),
                rand(ia, c_, scale=c_ ** -0.5).to(bf), rand(c_, ia, scale=ia ** -0.5).to(bf),
                rand(c_, scale=0.1).to(bf), heads, 1e-5)
        got = ft.temporal_block(x, cb, *args)
        want = ft._torch_temporal_block(x, cb, *args)
        torch.cuda.synchronize()
        err = compare(f"K3 {label}", got, want, atol=3e-2, rtol=2e-2)
        ms = cuda_ms(lambda: ft.temporal_block(x, cb, *args))
        pms = cuda_ms(lambda: ft._torch_temporal_block(x, cb, *args))
        print(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
        k3.append((err, ms, pms))
    results["temporal_block"] = k3
    return results


# -------------------------------------------------------------------- slice
def build_pipeline(dev, dtype):
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
    from ctrl_adapter_tpu_torch.models.vae import VAEConfig
    from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

    kw = dict(device=dev, dtype=dtype)
    unet = UNetSpatioTemporalConditionModel(**kw)
    cnet = ControlNetModel(**kw)
    adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                adapter_locations=("A", "B", "C", "D", "M"),
                                add_temporal_resnet=True, add_temporal_transformer=True, **kw)
    vae = AutoencoderKLTemporalDecoder(VAEConfig(), **kw)
    g = torch.Generator(device=dev).manual_seed(SEED)
    n_params = 0
    with torch.no_grad():
        for module in (unet, cnet, adapter, vae):
            module.eval()
            for p in module.parameters():  # random weights at scale 0.02, as bench.py
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
                n_params += p.numel()
    return SVDControlNetAdapterPipeline(unet, cnet, adapter, vae), n_params


def slice_inputs(dev, dtype, frames, size, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = size // 8
    return dict(
        image_embeddings=(torch.randn(1, 1, 1024, generator=g, device=dev) * 0.1).to(dtype),
        image_latent=(torch.randn(1, lat, lat, 4, generator=g, device=dev) * 0.1).to(dtype),
        controlnet_prompt_embeds=(torch.randn(2, 77, 768, generator=g, device=dev)
                                  * 0.02).to(dtype),
        control_images=torch.rand(frames, size, size, 3, generator=g, device=dev).to(dtype),
        latents=torch.randn(1, frames, lat, lat, 4, generator=g, device=dev))


@contextlib.contextmanager
def plain_kernels():
    """Swap each kernel wrapper in its ops module for its plain version (the
    modules call the wrappers through those modules), for the reference runs."""
    import ctrl_adapter_tpu_torch.ops.flash_attention as fa
    import ctrl_adapter_tpu_torch.ops.fused_temporal as ft
    import ctrl_adapter_tpu_torch.ops.group_norm as gn

    saved = (gn.group_norm_silu, fa.attention_bnth, ft.temporal_block)
    gn.group_norm_silu = gn._torch_group_norm_silu
    fa.attention_bnth = fa._torch_attention
    ft.temporal_block = ft._torch_temporal_block
    try:
        yield
    finally:
        gn.group_norm_silu, fa.attention_bnth, ft.temporal_block = saved


def run_slice(dev, card, kernels):
    from ctrl_adapter_tpu_torch.pipelines.common import control_window

    bf = torch.bfloat16
    t0 = time.perf_counter()
    pipe, n_params = build_pipeline(dev, bf)
    torch.cuda.synchronize()
    print(f"slice: built SVD UNet + ControlNet + adapter + temporal VAE, {n_params / 1e9:.3f} B "
          f"params bf16, in {time.perf_counter() - t0:.1f} s")
    inputs = slice_inputs(dev, bf, FRAMES, SIZE, SEED + 1)
    kw = dict(height=SIZE, width=SIZE, num_frames=FRAMES, num_inference_steps=STEPS,
              skip_conv_in=True, control_latent_size=SIZE // 8, device=dev)

    # the main path run: counters from 0, one generate() call to the video
    for k in kernels.values():
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = pipe.generate(**inputs, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"slice: launches during the run {launches}")

    if tuple(video.shape) != (1, FRAMES, SIZE, SIZE, 3):
        raise RuntimeError(f"video shape {tuple(video.shape)}")
    vf = video.float()
    if not torch.isfinite(vf).all():
        raise RuntimeError("video has non-finite values")
    if vf.min().item() < 0.0 or vf.max().item() > 1.0:
        raise RuntimeError("video values outside [0, 1]")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    print(f"slice: video {tuple(video.shape)} finite, range [{vf.min().item():.4f}, "
          f"{vf.max().item():.4f}], std {vf.std().item():.4f}")

    # steady state: the denoise loop and the decode again, timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = pipe.generate(**inputs, output_type="latent", **kw)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe._decode(latents, 0.18215)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    lo, hi = control_window(STEPS, 0.0, 0.8)  # generate()'s default control window
    print(f"slice on {card}: {STEPS} steps, 1x{FRAMES}x{SIZE}x{SIZE}, CFG, skip_conv_in:")
    print(f"  first generate() {t_first:.3f} s (denoise + decode, cold); denoise "
          f"{1000 * t_steady / STEPS:.1f} ms/step second run "
          f"(control window covers {hi - lo} of {STEPS} steps)")
    print(f"  decode {t_decode:.3f} s second run (one chunk of {FRAMES} frames)")
    print(f"  peak device memory {peak_gb:.2f} GiB (first generate())")

    # reference on a small input: the bf16 kernel path and the bf16 plain path,
    # each against the same weights in fp32 through the plain path
    small = slice_inputs(dev, bf, 4, 256, SEED + 2)
    skw = dict(height=256, width=256, num_frames=4, num_inference_steps=2, skip_conv_in=True,
               control_latent_size=32, device=dev, output_type="latent")
    got = pipe.generate(**small, **skw)
    with plain_kernels():
        plain = pipe.generate(**small, **skw)
        ref_pipe = type(pipe)(*(copy.deepcopy(m).float() for m in
                                (pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae)))
        ref = ref_pipe.generate(**small, **skw)
    del ref_pipe
    torch.cuda.synchronize()
    scale = ref.abs().max()
    err_k = ((got - ref).abs().max() / scale).item()
    err_p = ((plain - ref).abs().max() / scale).item()
    err_kp = ((got - plain).abs().max() / scale).item()
    print(f"slice reference (1x4x256x256, 2 steps, latents, errors relative to max|fp32|): "
          f"bf16 kernel path vs fp32 {err_k:.3e}, bf16 plain path vs fp32 {err_p:.3e}, "
          f"kernel vs plain {err_kp:.3e}; tolerance: kernel path within 2x the plain "
          f"path's error + 1e-2")
    if not (torch.isfinite(got).all() and err_k <= 2 * err_p + 1e-2):
        raise RuntimeError("kernel path is farther from the fp32 reference than allowed")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability >= 9.0, got {cap}")
    # before any output: outside a checkout of the repo the script prints nothing
    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    card = nvidia_smi_line()
    print(f"card: {card} (capability {cap[0]}.{cap[1]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    built_before = os.path.exists(_build.library_path())
    t0 = time.perf_counter()
    path = _build.build()
    print(f"build: {path} in {time.perf_counter() - t0:.1f} s"
          + (" (already built)" if built_before else " (nvcc ran)"))
    with open(path[:-3] + ".log") as fh:  # per entry function: name, spills, registers
        for line in fh:
            if any(key in line for key in ("Compiling entry", "bytes stack frame", "registers")):
                print("  ptxas: " + line.strip())

    results = check_kernels(dev, card)
    kernels = {"group_norm_silu": gn.KERNEL, "flash_attention": fa.KERNEL,
               "temporal_block": ft.KERNEL}
    launches = run_slice(dev, card, kernels)

    meta = {
        "group_norm_silu": ("ctrl_adapter_tpu_torch/csrc/group_norm.cu",
                            "ctrl_adapter_tpu/ops/group_norm.py:166"),
        "flash_attention": ("ctrl_adapter_tpu_torch/csrc/flash_attention.cu",
                            "ctrl_adapter_tpu/ops/flash_attention.py:97"),
        "temporal_block": ("ctrl_adapter_tpu_torch/csrc/temporal_attention.cu",
                           "ctrl_adapter_tpu/ops/fused_temporal.py:265"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": max(r[0] for r in results[name]),
         "ms": results[name][0][1], "plain_ms": results[name][0][2]}
        for name in kernels]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
