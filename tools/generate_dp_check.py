"""Data-parallel generation check: ``generate(..., mesh=...)`` over several processes.

    torchrun --nproc_per_node 4 tools/generate_dp_check.py

Every process (one card each, NCCL, ``cuda:LOCAL_RANK``) builds the three
pipelines at full width with weights drawn from a seeded generator on its
card (``chip_smoke.py``'s builders: SVD, I2VGen-XL with 2 ControlNets and an
embedding-conditioned router, SDXL) and runs each on a global batch of 4:
SVD 14 x 512^2, I2VGen-XL 16 x 512^2, SDXL 1024^2, 4 steps, the decode
included, the batch split over the processes. The latents
are drawn for the whole batch from a seeded generator on every rank, as the
one-process run draws them. Rank 0 then runs the whole batch alone and
compares: the sharded output must lie within a tolerance of the
one-process output's norm (bf16 on the card: the two runs' products meet
other batch sizes, whose GEMM and GroupNorm reductions round in another
order; 2e-2 is about ten bf16 roundings; fp32 on the CPU: 2e-4, the JAX
test's tolerance).

Per pipeline and rank it prints ms per denoise step (host clock, card
synchronised, over the denoise loop), peak GiB and videos (images) per
second (the rank's videos over its ``generate`` call, decode included), and
rank 0's one-process numbers beside them; then the card's name and power
limit, and last one JSON object with all of it. It exits non-zero when an
output differs.

``--device cpu --thin`` runs the same on the CPU (gloo) with the thin towers
of ``tests/torch_cli_common.py`` in fp32, as a rehearsal:

    python -m torch.distributed.run --nproc_per_node 4 tools/generate_dp_check.py \\
        --device cpu --thin

Build the kernels once before ``torchrun`` so that the processes do not each
run nvcc: ``python3 -c 'from ctrl_adapter_tpu_torch.ops import _build; _build.build()'``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter  # noqa: E402
from ctrl_adapter_tpu_torch.parallel import mesh as meshes  # noqa: E402

SEED = 7
BATCH = 4             # the global batch: one video (image) a card on four
STEPS = 4
FULL = {"svd": (14, 512), "i2vgenxl": (16, 512), "sdxl": (1, 1024)}  # frames, size
THIN = {"svd": (3, 64), "i2vgenxl": (3, 64), "sdxl": (1, 128)}


def fill(modules, seed, device, scale=0.02):
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for module in modules:
            module.eval().requires_grad_(False)
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=device) * scale)


def build(name, device, dtype, thin):
    """The pipeline ``name`` with seeded weights, the same on every rank."""
    from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline
    from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline

    router = None
    if name == "i2vgenxl":  # its input is the batch mean of the CLIP embeddings
        router = ControlNetRouter(2, "embedding_weights", embedding_dim=1024, device=device)
    if thin:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import torch_cli_common as tc

        control = ["depth", "canny"] if name == "i2vgenxl" else ["depth"]
        pipe = tc.thin_build_modules(argparse.Namespace(model_name=name, control_types=control),
                                     device, dtype)
        pipe.router = router
        fill([m for m in (pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae)], SEED, device)
    elif name == "svd":
        pipe = chip_smoke.build_pipeline(device, dtype)[0]
    elif name == "i2vgenxl":
        unet, nets, adapter, vae, _, _ = chip_smoke.build_i2vgenxl(device, dtype, 2)
        pipe = I2VGenXLControlNetAdapterPipeline(unet, MultiControlNetModel(nets), adapter, vae,
                                                 router=router)
    else:
        pipe = SDXLControlNetAdapterPipeline(*chip_smoke.build_sdxl(device, dtype)[:4])
    if router is not None:
        fill([router], SEED + 1, device, scale=1.0)
    return pipe


def inputs(name, b, frames, size, device, dtype):
    """The global batch's inputs, from a seeded generator on the device."""
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    r = lambda *s, scale: (torch.randn(*s, generator=g, device=device) * scale).to(dtype)  # noqa: E731
    lat = size // 8
    u = lambda *s: torch.rand(*s, generator=g, device=device).to(dtype)  # noqa: E731
    if name == "svd":
        return dict(image_embeddings=r(b, 1, 1024, scale=0.1),
                    image_latent=r(b, lat, lat, 4, scale=0.1),
                    controlnet_prompt_embeds=r(2 * b, 77, 768, scale=0.02),
                    control_images=u(b * frames, size, size, 3)), dict(
            height=size, width=size, num_frames=frames, control_latent_size=lat)
    if name == "i2vgenxl":
        return dict(prompt_embeds=r(2 * b, 77, 1024, scale=0.02),
                    controlnet_prompt_embeds=r(2 * b, 77, 768, scale=0.02),
                    image_embeddings=r(b, 1, 1024, scale=0.1),
                    first_frame_latent=r(b, lat, lat, 4, scale=0.1),
                    control_images=u(2, b * frames, size, size, 3)), dict(
            height=size, width=size, num_frames=frames, control_latent_size=lat)
    control = lat // 2  # the SD-v1.5 ControlNet's latent: 64 at 1024^2
    return dict(prompt_embeds=r(2 * b, 77, 2048, scale=0.02),
                add_text_embeds=r(2 * b, 1280, scale=0.02),
                controlnet_prompt_embeds=r(2 * b, 77, 768, scale=0.02),
                control_image=u(b, 8 * control, 8 * control, 3)), dict(
        height=size, width=size, control_latent_size=control)


def timed_generate(pipe, device, batch, **kwargs):
    """``pipe.generate(**kwargs)`` with its denoise loop timed: (output, ms per
    step, videos per second over the call, peak GiB)."""
    sample = pipe._sample
    loop = {}

    def timed(*args, **kw):
        sync(device)
        t0 = time.perf_counter()
        out = sample(*args, **kw)
        sync(device)
        loop["s"] = time.perf_counter() - t0
        return out

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    pipe._sample = timed
    try:
        sync(device)
        t0 = time.perf_counter()
        out = pipe.generate(num_inference_steps=STEPS, **kwargs)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        del pipe._sample
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None
    return out, 1000 * loop["s"] / STEPS, batch / wall, peak


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device):
    if device.type != "cuda":
        return "CPU"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().replace("\n", "; ")


def fmt(x, spec=".1f"):
    return "n/a" if x is None else format(x, spec)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu for the gloo rehearsal")
    parser.add_argument("--thin", action="store_true")
    args = parser.parse_args()
    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("generate_dp_check: no CUDA device (pass --device cpu)")
        device = torch.device("cuda", meshes.local_rank())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    mesh = meshes.join(device)
    sizes = THIN if args.thin else FULL
    report, ok = {}, True
    try:
        for name in ("svd", "i2vgenxl", "sdxl"):
            frames, size = sizes[name]
            pipe = build(name, device, dtype, args.thin)
            x, kw = inputs(name, BATCH, frames, size, device, dtype)
            gen = lambda: torch.Generator(device=device).manual_seed(SEED + 3)  # noqa: E731
            dist.barrier()
            out, ms, vps, peak = timed_generate(pipe, device, BATCH // mesh.world_size,
                                                mesh=mesh, generator=gen(), **x, **kw)
            ranks = [None] * mesh.world_size
            dist.all_gather_object(ranks, {"ms_per_step": ms, "videos_per_s": vps,
                                           "peak_gib": peak})
            entry = {"batch": BATCH, "frames": frames, "size": size, "steps": STEPS,
                     "ranks": ranks}
            if mesh.rank == 0:
                alone, ams, avps, apeak = timed_generate(pipe, device, BATCH, generator=gen(),
                                                         **x, **kw)
                diff = (out.float() - alone.float())
                rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(
                    alone.float()))
                entry.update(alone={"ms_per_step": ams, "videos_per_s": avps, "peak_gib": apeak},
                             max_abs_err=float(diff.abs().max()), rel_norm_err=rel,
                             bitwise=bool(torch.equal(out, alone)), tolerance=tol,
                             shape=list(out.shape))
                good = math.isfinite(rel) and rel <= tol and tuple(out.shape) == tuple(
                    alone.shape)
                ok &= good
                for r, v in enumerate(ranks):
                    print(f"{name} rank {r}: {fmt(v['ms_per_step'])} ms/step, peak "
                          f"{fmt(v['peak_gib'], '.2f')} GiB, {fmt(v['videos_per_s'], '.3f')} "
                          f"videos/s", flush=True)
                print(f"{name} alone on rank 0 (batch {BATCH}): {fmt(ams)} ms/step, peak "
                      f"{fmt(apeak, '.2f')} GiB, {fmt(avps, '.3f')} videos/s; sharded output "
                      f"{tuple(out.shape)} against it: max abs {entry['max_abs_err']:.3e}, "
                      f"relative norm {rel:.3e} (tolerance {tol:g}), "
                      f"{'equal to the bit' if entry['bitwise'] else 'not bitwise'}"
                      f" -> {'OK' if good else 'DIFFERS'}", flush=True)
                del alone
            report[name] = entry
            del pipe, out
            if device.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
        flag = torch.tensor([int(ok)], device=device)
        dist.broadcast(flag, src=0)
        ok = bool(flag.item())
        if mesh.rank == 0:
            card = card_line(device)
            print(card)
            print(json.dumps({"processes": mesh.world_size, "outputs_equal": ok,
                              "cards": card, "pipelines": report}))
    finally:
        meshes.leave(mesh)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
