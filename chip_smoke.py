"""Chip smoke test of the PyTorch port on one Hopper card: the SVD, I2VGen-XL and SDXL paths.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero before its last line):
1. check for a CUDA card of capability >= (9, 0) and print its name and power
   limit as nvidia-smi reports them;
2. build the CUDA kernels from ``ctrl_adapter_tpu_torch/csrc`` (nvcc, sm_90a);
3. compare each kernel with its plain PyTorch version on the card, in bf16, at
   the main path's shapes, and time both (CUDA events around runs of 10
   calls, medians) beside the one PyTorch call that computes the same
   function where there is one (``F.group_norm``;
   ``F.scaled_dot_product_attention``, its default backend named, then its
   flash and cuDNN backends forced) and the kernel's roofline bound on the
   H100 (``ops/roofline.py``); these library calls are yardsticks only, no
   module of the port calls them. K1 and K3 hybrid run at every shape the
   slice gives them (``k1_rows``, ``hybrid_rows``, from the model configs),
   with the per-step sums of launches x time against launches x bound, and
   K3 hybrid's two launches timed apart under ``torch.profiler``; K1, K3
   hybrid, K3 full, K4 and K5 also on device time apart from the host's,
   with their inputs left in L2 (``torch.profiler``) and with L2 flushed
   before each call (``cold_ms``), K1 beside its yardstick's device time, K5
   beside the time of the (M, 2D) product ``F.linear`` alone; K3 full and K4
   also with exact (erf) gelu; K3 full, K4 and K5 on inputs that tell the two
   gelu forms apart (``gelu_form_check``); K2's forward with the rows'
   log-sum-exp and K2's backward at the training path's shapes and at H = 128
   (``check_flash_bwd``: dQ, dK and dV equal to the bit over two calls and
   dQ's run-to-run max difference printed; time, device time warm and cold, each of its three
   launches, bound, SDPA's backward, the per-training-step sums; the forward
   with and without the log-sum-exp, in turns), and the gradients of K1, K3 hybrid, K3
   full, K4 and K5 under grad against plain autograd (``check_kernel_grads``);
4. run the slice: ``SVDControlNetAdapterPipeline`` at full width (SVD UNet
   320/640/1280/1280, SD-v1.5 ControlNet, the 13-block adapter at A-D + M, the
   temporal VAE) in bf16 with weights drawn from a seeded generator, 14 frames
   at 512x512, a few Euler steps with CFG and latent skipping, then decode;
   check the video, that every kernel of the path was launched and that the
   temporal blocks took the JAX dispatch (K3 "full" at UNet level 0, K3
   "hybrid" at level 1 and in the adapter) and K1 where the JAX rule admits
   the norm (47 adapter norms per controlled step); time the denoise loop
   with K1 at every adapter norm (the dispatch before the repair) beside
   the JAX rule, one run each; then, on a small input, check the kernel path against
   an fp32 reference of the same weights, and measure the JAX pipelines'
   promotion of the residuals to fp32 (``promotion_check``: the bf16 path and
   the promoted one, each against fp32);
5. the same pipeline in the fused-block configuration
   (``CTRL_ADAPTER_FUSED_BLOCK=1``, a switch of the JAX package) for 2 steps:
   the same checks, and K4 must launch; ms/step beside the default's; K4's
   launches counted per step give its per-step sums (launches x time against
   launches x bound);
6. the exact-gelu switch (``CTRL_ADAPTER_EXACT_GELU=1``, a switch of the JAX
   package): a UNet level-0 temporal block still runs K3 full, now with erf
   gelu, and agrees with its plain version, and on weights that tell the
   forms apart its output follows the switch; a 320-wide spatial transformer
   block under ``CTRL_ADAPTER_FUSED_BLOCK=1`` launches K4 without the switch
   and not with it (the JAX rule keeps erf off its kernel);
7. K5, which no model path reaches: the port's ``FeedForward`` under
   ``CTRL_ADAPTER_FUSED_FF=1`` at the level-0 shape, against its plain run;
8. the SVD training step (``train/trainer.py``) at the full width of
   ``configs/svd_train_depth.yaml``: 1 x 14 x 512 x 512, skip_conv_in, bf16
   towers, fp32 adapter masters, gradient checkpointing, 3 steps on a batch
   drawn from a seeded generator; checks finite losses and gradient norms, a
   nonzero gradient on every adapter tensor the forward reads, that every
   master moved, K2's backward 12 times a step and K1, K2, K3 full and K3
   hybrid forward in every step (its checkpoint round trip is phase 14's);
   prints ms/step (steps 2-3), peak memory, a fourth step split
   into forward, backward and optimizer, and, from a fifth under
   ``torch.profiler``, the device's idle share; then, on
   2 frames at 128x128, the kernel path's loss and adapter gradient against an
   fp32 run of the plain path;
9. the I2VGen-XL control path (``I2VGenXLControlNetAdapterPipeline``) at the
   full width of the JAX bench's ``i2vgenxl_depth`` and ``i2vgenxl_multi``
   (I2VGen-XL UNet 320/640/1280/1280, SD-v1.5 ControlNets, the 13-block
   adapter, the 2D VAE), bf16, 16 frames at 512x512, CFG 9.0 (its shapes
   get their phase 3 rows right after the SVD ones, before phase 8's long
   profiled run, after which ``torch.profiler`` was seen to drop events: K1
   at the adapter's norms at b*f = 32, K2 at (32, 5, 4096, 64) and
   (32, 10, 1024, 64), K3 hybrid at the adapter's f = 16 blocks and at 4 key
   frames; ``check_i2vgenxl_kernels``): the depth configuration (one ControlNet, 4 DDIM steps, 3 in the control
   window, the decode in chunks of 2) and the multi-condition one (7
   ControlNets loaded, 2 active, a simple-weights router, 2 steps): the
   video, each kernel's launches per controlled and per UNet-only step
   against the JAX dispatch (``i2v_launches``), that only the active experts
   ran and the masked ones have router weight 0; ms per controlled and per
   UNet-only step with the device's busy time and idle share, ms per tower
   call, decode seconds, peak memory; and on a small input, for both
   configurations, the first controlled step's adapter outputs, UNet output
   and CFG-combined noise prediction from the kernel path against an fp32
   run of the plain path (max and norm errors), with faulty kernels (K1 without its SiLU, K2 without a
   head, K3 hybrid returning its input) as controls that must fail;
10. the SDXL control path (``SDXLControlNetAdapterPipeline``) at the full
   width of the JAX bench's ``sdxl_depth`` (SDXL UNet 320/640/1280 with 1/2/10
   transformer layers and cross 2048, the SD-v1.5 ControlNet at a 64x64
   latent and a 512x512 control image, the adapter at A-C with the x2
   upsample, the SDXL VAE), bf16, batch 1 at 1024x1024, CFG 7.5, 4 Euler
   steps with the control window ending at 0.6 (2 controlled, 2 UNet-only),
   then the decode (its shapes get their phase 3 rows after the I2VGen-XL
   ones: K1 at the adapter's admitted norms at N = 2, K2 at (2, 5, 16384, 64)
   and the other UNet and adapter shapes; ``check_sdxl_kernels``): the
   image, each kernel's launches per controlled and per UNet-only step
   against the JAX dispatch (``sdxl_launches``); ms per controlled and per
   UNet-only step with the device's busy time and idle share, ms per tower
   call, decode seconds, peak memory; and at 512x512 the first controlled
   step's adapter outputs, UNet output and rescaled-CFG noise prediction
   against an fp32 run of the plain path, with K1 without its SiLU and K2
   without a head as controls that must fail;
11. the I2VGen-XL and SDXL training branches (``train/trainer.py``) at the
   full width of ``configs/i2vgenxl_train_depth.yaml``,
   ``configs/i2vgenxl_train_multi_condition.yaml`` and
   ``configs/sdxl_train_depth.yaml`` (bf16 towers from a seeded generator,
   fp32 masters, gradient checkpointing; ``run_train_branches``; their K1,
   K2, K2 backward and K3 hybrid shapes at batch 1 get phase 3 rows after
   the I2VGen-XL and SDXL ones, ``train_rows``): I2VGen-XL depth (1 x 16 x
   512^2, one ControlNet, 3 steps), multi-condition (7 ControlNets, all run
   every step as in the JAX loop, a simple-weights router in the adapter's
   optimizer, 1-4 active experts drawn per step, 2 steps) and SDXL (1 x
   1024^2, min-SNR gamma 5, 3 steps): finite losses and gradient norms,
   every read adapter tensor a nonzero gradient, every master (the
   router's) moved, each kernel's launches per step against
   ``i2v_train_launches`` / ``sdxl_train_launches`` (the forward kernels in
   the forward and the recompute, K2's backward once per attention
   downstream of the adapter), the masked experts' router weights and
   gradients exactly 0; ms/step, peak memory, a step in parts and the idle
   share of a profiled step (the checkpoint round trip is phase 14's); and
   on small inputs (I2VGen-XL multi-condition at 4 x
   256^2, SDXL at 512^2) the loss and every gradient tensor against an fp32
   run of the plain path (``train_reference_check``), with faulty kernels
   as controls that must fail (``training_faults``);
12. print the per-kernel JSON line (with each kernel's launches on the
   I2VGen-XL, SDXL, training and both CLIs' runs and phase 15's, and the
   fp32 kernels' from phase 16), the card line, and the result line;
13. (run before 12) the serving CLI, ``inference_torch.main``, at the main
   path's full width (SVD, depth, skip_conv_in, 14 frames at 512x512, 4 steps
   cut from 25) on a fixture of 512^2 PNG frames written by the port's
   encoder: (a) with ``--fake_weights`` (its towers drawn on the card,
   ``fill_on_card``, not from host numpy); (b) from diffusers-layout folders
   written by ``convert/release.py`` into a temporary directory (bf16 UNet,
   temporal VAE, SD-v1.5 ControlNet and adapter; fp16 CLIP-L text tower with
   a small BPE tokenizer and CLIP-H vision tower). Checks the status line,
   both gifs (14 frames), the video, K1, K2, K3 full and K3 hybrid launched per
   step as in phase 4, every loaded tensor bit for bit as written, and the
   encoders (no kernel launched, finite, within 1e-3 of CPU fp32 copies);
   prints load seconds, encoder ms, ms per step, decode seconds and peak GiB;
14. (run before 12, after 13) the training CLI, ``train_torch.main``, at full
   width from ``configs/*.yaml`` read by the port's YAML reader
   (``run_train_cli``): (a) SVD depth (1 x 14 x 512^2, skip_conv_in,
   ``--fake_weights``), 3 steps under a one-rank NCCL group (``--multihost``
   with torchrun's variables for a world of one), checkpoints at
   steps 2 and 3, a validation gif at step 3: finite losses, the log's
   records, K1, K2, K2 backward, K3 hybrid and K3 full per step as phase 8,
   the gif's 14 frames, checkpoint-3 read back bit for bit, each step's
   all-reduce returning its gradient unchanged and the 3 updates replayed
   without a group from the same gradients equal to the bit; then the same
   3 steps without a group (step 1's loss equal to the bit; the gap between
   the two runs' updates printed and held to 0, as every gradient of the
   step repeats its bits; where it is not 0, the ungrouped steps run once
   more under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
   which prints the ops PyTorch names as not repeatable, before the phase
   fails); (b) a resume from
   checkpoint-2 for step 3: masters and optimizer state restored bit for
   bit, step 3's loss (a)'s; (c) ``inference_torch.main`` serving (a)'s
   ``adapter_3`` (the other towers drawn on the card), 2 steps (one
   controlled, one UNet-only): the video and launches per step as phase 4; (d) SDXL
   depth at 1024^2, 2 steps: launches per step as phase 11 (the I2VGen-XL
   multi-condition CLI run is phase 15 (4)); after each run the card holds
   no more than before it. Prints per run the build seconds, ms per step
   after the first and peak GiB, and the phase's seconds.
15. (run before 12, after 14) condition extraction and the dataset path
   (``run_conditions``), from checkpoints fabricated at the published
   widths (seeded, scale 0.02, the depth heads' last bias 1): transformers
   ``Intel/dpt-large`` (ViT-L/16, 384^2), MiDaS ``dpt_swin2_large_384``,
   SegFormer-b5 ADE 640, and the five lllyasviel/Annotators files in their
   released layouts (``write_annotators``: PiDiNet table 5, ControlNetHED,
   the lineart generator, NormalBAE's NNET, the OpenPose body). (1) DPT-L,
   MiDaS SwinV2-L, SegFormer, canny, shuffle, PiDiNet, HED (soft edges and
   scribbles), lineart, NormalBAE and OpenPose in fp32 on phase 13's 14
   frames of 512^2: ms a call (median of 3 after a warm one), peak GiB, no
   port kernel, and one frame against a CPU copy (``extractor_check``:
   scribbles and OpenPose canvases equal); OpenPose's peaks and people,
   and its decoding and drawing on the host over ``pose_fields()`` held to
   the JAX package's canvas (``pose_report``); (2) ``inference_torch.main
   --extract_control_conditions`` (SVD depth, ``--fake_weights``, 4 steps)
   from a working directory that holds ``Intel/dpt-large``: conditions equal
   ``DepthDPT``'s, launches per step as phase 4's; (3) ``train_torch.main``
   on real data (two PNG-frame clips of 20 frames at 512^2, two 1024^2
   images, captions csvs, ``CTRL_ADAPTER_ANNOTATORS`` naming all seven
   checkpoints) from phase 13's diffusers folders: SVD depth 2 steps with
   validation on the real batch (its ``_concat.gif``), launches per step as
   phase 8's; ``svd_train_mixed.yaml`` as it stands (seven types, one
   ControlNet folder each) 2 steps, each step on its batch type's
   ControlNet; SDXL depth 2 steps at 1024^2 from freshly written SDXL
   folders, launches as phase 11's; (4) ``i2vgenxl_train_multi_condition.yaml``
   on the clips (16 frames at 512^2, all seven conditions extracted for
   every clip by the prefetcher on the card; 7 ControlNets, a simple-weights
   router, 1-4 active; 2 steps) from freshly written I2VGen-XL folders:
   launches per step as phase 11's multi-condition run, masked experts'
   router weights exactly 0, every type extracted for every item,
   ``checkpoint-2/router_2`` read back equal to the router. Prints the
   prefetcher's waits, peak GiB, what each run left on the card and the
   phase's seconds.
16. (run before 12, after 15) fp32 towers and data-parallel generation
   (``run_phase16``): (1) K1 fp32, K2 fp32 and K2 bwd fp32 at the fp32
   training paths' shapes (K1 at the adapter norms JAX admits at itemsize 4
   for SVD at 1 x 14 x 512^2, I2VGen-XL at 1 x 16 x 512^2 and SDXL at 1 x
   1024^2, ``k1_fp32_row``, one launch each on K1 fp32's counter and the same
   bits over two calls, with each model's sums over one adapter call; K2 at
   (14, 5, 4096, 64), (14, 10, 1024, 64) and ``SDXL_FP32_SHAPES``) against
   their plain versions with TF32 off (within 1e-5 of the norm), the
   backward's dQ, dK and dV equal to the bit over two calls, timed beside
   their bounds (K1 at 67 TFLOP/s on the CUDA cores, K2 at the 3xTF32 rate)
   on the host clock and on the card's (``warm_ms``: back-to-back calls
   behind a sleep, no profiler; ``cold_ms``), beside ``F.group_norm`` in
   fp32 and SDPA's memory-efficient backend, forward and backward, on the
   same clocks, and each K2 launch's device ms; (2)
   ``train_torch.main --mixed_precision no`` at the full width of
   ``configs/svd_train_depth.yaml``, 2 steps and a validation sample: finite
   losses, K1 fp32, K2 fp32 and K2 bwd fp32 launched per step as the fp32
   rules and phase 8's attention counts give them and no bf16 kernel, the
   gif; ms per step, the validation's seconds and peak GiB; then on
   ``configs/sdxl_train_depth.yaml`` (1 x 1024^2) and
   ``configs/i2vgenxl_train_depth.yaml`` (1 x 16 x 512^2), 2 steps each, the
   fp32 kernels per step as ``sdxl_fp32_train_launches`` and
   ``i2v_fp32_train_launches`` give them and no bf16 kernel, ms per step and
   peak GiB (``run_fp32_branch``); (3) SVD ``generate(mesh=...)`` at full
   width under a one-rank NCCL group, batch 2, 2 steps, latents drawn from a
   seeded generator: equal to the bit to the run without a mesh. The kernels
   line lists the fp32 kernels with their launches in (2), the SVD run's,
   the SDXL run's and the I2VGen-XL run's.

Device busy times and idle shares come from ``device_activity``, which
refuses a trace that holds fewer events of a port kernel than the kernel's
counter saw launched (the profiler was seen to drop events late in a long
run): it traces again, up to three times, then prints "not measured". A
call's warm device time comes from ``torch.profiler`` (``kernel_times``), or
where it keeps too few events, and throughout phase 16, from ``warm_ms``:
CUDA events around back-to-back calls enqueued behind ``torch.cuda._sleep``,
so that they read the card's clock, not the host's.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
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


def cuda_ms(fn, iters: int = 5, reps: int = 10, warmup: int = 2) -> float:
    """Time per call of ``fn()`` in ms: the median over ``iters`` runs of
    ``reps`` calls back to back, CUDA events around each run. The host enqueues
    ahead of the card, so a call shows its device time, or its host time where
    that is the longer."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


FLUSH_BYTES = 512 << 20  # ten times the H100's 50 MB L2


def cold_ms(fn, flush, iters: int = 20, warmup: int = 2) -> float:
    """Device time per call of ``fn()`` in ms with a cold L2: the median over
    ``iters`` single calls, each enqueued behind a write of ``flush`` (a
    buffer far larger than L2), CUDA events around the call alone. The write
    keeps the card busy for longer than the host takes to enqueue the call, so
    the events read the call's device time, not its host time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """The cycles ``torch.cuda._sleep`` spins for a millisecond on this card:
    the median of three 2-million-cycle sleeps timed with CUDA events,
    measured once."""
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return 2_000_000 / statistics.median(times)


def warm_ms(fn, reps: int = 20, iters: int = 5, warmup: int = 2) -> float:
    """Device time per call of ``fn()`` in ms, inputs left in L2, without the
    profiler: the median over ``iters`` runs of ``reps`` calls back to back,
    CUDA events around each run, every run enqueued behind a
    ``torch.cuda._sleep`` that lasts twice the host's enqueue of the run
    (measured in the warm-up) plus 0.2 ms. The card starts the first call
    only once the host has enqueued the last, so the events read the card's
    time, not the host's. A run whose start event had passed before the last
    call was enqueued is made again with twice the sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sleep_ms = 2000 * (time.perf_counter() - t0) + 0.2
    torch.cuda.synchronize()
    times = []
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end) / reps)
        elif sleep_ms > 1000:
            raise RuntimeError(f"warm_ms: the host took over {sleep_ms:.0f} ms to enqueue "
                               f"{reps} calls")
        else:
            sleep_ms *= 2
    return statistics.median(times)


def device_times(fn, flush, profiler=True, heavy=False):
    """(warm, cold) device ms per call of ``fn()``: the sum of its kernels'
    device times under ``torch.profiler`` (back-to-back calls, inputs left in
    L2), or without ``profiler``, or where the profiler keeps too few events,
    ``warm_ms`` (the same calls timed with CUDA events behind a sleep); and
    ``cold_ms``. ``heavy``: fewer calls, for calls of milliseconds."""
    split = kernel_times(fn) if profiler else None
    runs = dict(reps=3, iters=3, warmup=1) if heavy else {}
    warm = warm_ms(fn, **runs) if split is None else sum(split.values())
    return warm, cold_ms(fn, flush, **(dict(iters=5, warmup=1) if heavy else {}))


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def device_line(row, fn, flush, library=None, profiler=True, heavy=False) -> None:
    """Time ``fn()`` on device, warm and cold L2 (``device_times``), print both
    beside the row's bound and its share of them, and add them to the row;
    with ``library`` (name, fn), that call's device times too
    (``library_device_ms``, ``library_cold_ms``; ``warm_ms``, ``cold_ms``)."""
    warm, cold = device_times(fn, flush, profiler, heavy)
    bound = row["bound_ms"]
    shares = ", ".join(f"{what} {100 * bound / t:.1f} %" for what, t in (("warm", warm),
                                                                         ("cold", cold)) if t)
    print(f"    device: kernel {fmt_ms(warm)} warm L2, {fmt_ms(cold)} cold L2; bound "
          f"{bound:.4f} ms, kernel at {shares} of it")
    row.update(device_ms=warm, cold_ms=cold)
    if library is not None:  # the yardstick on the profiler-free clocks
        name, lib = library
        lwarm, lcold = device_times(lib, flush, False, heavy)
        print(f"    device: {name} {fmt_ms(lwarm)} warm L2, {fmt_ms(lcold)} cold L2")
        row.update(library_device_ms=lwarm, library_cold_ms=lcold)


def compare(name, got, want, atol, rtol, rel_norm=None):
    """Elementwise ``|err| <= atol + rtol*|plain|``; with ``rel_norm``, also
    ``||err|| <= rel_norm * ||plain||`` (outputs much smaller than atol)."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    err = (got - want).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    bound = atol + rtol * want.abs()
    ok = bool((err <= bound).all())
    tol = f"|err| <= {atol} + {rtol}*|plain|"
    rel = ""
    if rel_norm is not None:
        r = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
        ok = ok and r <= rel_norm
        rel = f" rel_norm_err {r:.3e}"
        tol += f", ||err|| <= {rel_norm}*||plain||"
    print(f"  {name}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e}{rel} "
          f"(tolerance {tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_err


def update_check(name, got, want, x, cb, limit=2e-2):
    """A residual block's update, ``out - x - cross_bias`` in fp32, held to
    ``||kernel - plain|| <= limit * ||plain||``; its elements sit far below the
    output's bf16 steps, so no elementwise bound is taken on it."""
    upd_k, upd_p = (t.float() - x.float() - cb.float()[:, None] for t in (got, want))
    r = (torch.linalg.vector_norm(upd_k - upd_p) / torch.linalg.vector_norm(upd_p)).item()
    ok = r <= limit
    print(f"  {name} update: rel_norm_err {r:.3e} (tolerance ||err|| <= {limit}*||plain||) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: the kernel's update disagrees with its plain version")
    return r


def to_fp32(a):
    """A kernel's arguments in fp32 (tensors; tuples of them; other values as they are)."""
    if isinstance(a, tuple):
        return tuple(map(to_fp32, a))
    return a.float() if torch.is_tensor(a) else a


def fp32_check(name, got, want, ref):
    """The bf16 kernel no farther from the fp32 run ``ref`` of the plain version
    than 1.25x the bf16 plain version's distance + 1e-2 (max abs)."""
    err_k, err_p = ((t.float() - ref).abs().max().item() for t in (got, want))
    print(f"    vs fp32: kernel {err_k:.3e}, plain {err_p:.3e} (tolerance: kernel within "
          f"1.25x the plain version's error + 1e-2)")
    if err_k > 1.25 * err_p + 1e-2:
        raise RuntimeError(f"{name}: farther from the fp32 reference than its plain version")


def gelu_form_check(name, run):
    """The kernel computed the gelu form it was asked for. ``run(approximate,
    kernel)`` gives the kernel's output (``kernel`` true) or its plain
    version's, on inputs where the two forms differ by far more than the
    kernel's rounding (``gelu_form_ff``). For each form, the kernel's mean |err|
    against the plain version of that form must be below half its mean |err|
    against the plain version of the other: a flag that does not reach the
    kernel fails one of the two."""
    plain = {a: run(a, False).float() for a in (True, False)}
    for approximate, form in ((True, "tanh"), (False, "erf")):
        got = run(approximate, True).float()
        same = (got - plain[approximate]).abs().mean().item()
        other = (got - plain[not approximate]).abs().mean().item()
        ok = same <= 0.5 * other
        print(f"  {name}, {form} gelu: mean |err| {same:.3e} against plain {form}, {other:.3e} "
              f"against the other form (tolerance: below half of it) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{name}: the kernel did not compute {form} gelu")


# ----------------------------------------------- the feed-forward kernels' rows
# (atol, rtol, relative norm or None) of each kernel against its plain version
FF_TOL = {"temporal_block_full": (1e-1, 2e-2, None), "ln_ff_residual": (3e-2, 2e-2, None),
          "geglu": (2e-2, 2e-2, 1e-2)}
K5_SHAPES = ((114688, 320), (28672, 640))  # (rows, c): UNet levels 0 and 1, inner 4c


def ff_weights(rand, c, inner, cout):
    """(ln_w, ln_b, wg, bg, w2, b2) of a GEGLU FF, bf16, nn.Linear layout."""
    bf = torch.bfloat16
    return ((1.0 + rand(c, scale=0.1)).to(bf), rand(c, scale=0.1).to(bf),
            rand(2 * inner, c, scale=c ** -0.5).to(bf), rand(2 * inner, scale=0.1).to(bf),
            rand(cout, inner, scale=inner ** -0.5).to(bf), rand(cout, scale=0.1).to(bf))


def k3_full_inputs(rand):
    """K3 full's main-path inputs: the UNet level-0 temporal block, (2, 14, 4096,
    320), 5 heads, cross bias; (x, cross bias, the arguments up to ``approximate``)."""
    bf = torch.bfloat16
    x = rand(2, 14, 4096, 320).to(bf)
    cb = rand(2, 4096, 320, scale=0.5).to(bf)
    args = ((1.0 + rand(320, scale=0.1)).to(bf), rand(320, scale=0.1).to(bf),
            *(rand(320, 320, scale=320 ** -0.5).to(bf) for _ in range(4)),
            rand(320, scale=0.1).to(bf), 5, 1e-5, ff_weights(rand, 320, 1280, 320),
            ff_weights(rand, 320, 1280, 320))
    return x, cb, args


def k4_inputs(rand):
    """K4's main-path inputs: the level-0 spatial transformer FF, 28 x 4096 rows
    of 320, inner 1280; (x, FF weights)."""
    return rand(114688, 320).to(torch.bfloat16), ff_weights(rand, 320, 1280, 320)


def k5_inputs(rand, m, c):
    """K5's inputs at (m, c) -> 2 x 4c: (x, W, b)."""
    bf = torch.bfloat16
    return (rand(m, c).to(bf), rand(8 * c, c, scale=c ** -0.5).to(bf),
            rand(8 * c, scale=0.1).to(bf))


def gelu_form_ff(rand, c, inner, cout):
    """(ln_w, ln_b, wg, bg, w2, b2), bf16, of a GEGLU FF whose two gelu forms give
    clearly different outputs: the products add ~1e-2 to a value bias of 1 and
    a gate bias of -3, where tanh-gelu lies 10 % (4.1e-4) above erf-gelu, and
    W2 (positive, ~1/inner) averages h over the inner width, so the gap reaches
    every output whole."""
    bf = torch.bfloat16
    dev = rand(1).device
    bg = torch.cat([torch.ones(inner, device=dev), torch.full((inner,), -3.0, device=dev)])
    return (torch.ones(c, device=dev, dtype=bf), torch.zeros(c, device=dev, dtype=bf),
            rand(2 * inner, c, scale=0.01 * c ** -0.5).to(bf), bg.to(bf),
            ((1.0 + rand(cout, inner, scale=0.1)) / inner).to(bf),
            torch.zeros(cout, device=dev, dtype=bf))


# ------------------------------------------------------- main-path shapes
def slice_temporal_blocks(latent: int = SIZE // 8, frames: int = FRAMES, batch: int = 2):
    """Every temporal transformer block of one UNet call and of one adapter
    call of the slice, from the model configs: (tower, where, (b, f, s, c, ia,
    iff)). The UNet's blocks sit in its cross-attention down and up blocks and
    its mid block, at c = ia = the level's width; the adapter's (bug-compatible)
    at c = 512 with ia = the block's channels, one per adapted residual slot."""
    from ctrl_adapter_tpu_torch.models import adapter as ad
    from ctrl_adapter_tpu_torch.models.unet_svd import SVDUNetConfig

    cfg = SVDUNetConfig()
    n = len(cfg.block_out_channels)
    blocks = []

    def unet(level, count, where):
        c = cfg.block_out_channels[level]
        shape = (batch, frames, (latent >> level) ** 2, c, cfg.num_attention_heads[level] * 64,
                 4 * c)
        blocks.extend([("unet", f"{where} L{level}", shape)] * count)

    for i, kind in enumerate(cfg.down_block_types):
        if kind.startswith("CrossAttn"):
            unet(i, cfg.layers_per_block * cfg.transformer_layers_per_block[i], "down")
    unet(n - 1, cfg.transformer_layers_per_block[-1], "mid")
    for j, kind in enumerate(cfg.up_block_types):
        if kind.startswith("CrossAttn"):
            unet(n - 1 - j, (cfg.layers_per_block + 1) * cfg.transformer_layers_per_block[::-1][j],
                 "up")
    inner = ad._INNER_HEADS * 64
    for c, h in adapter_blocks(latent):
        blocks.append(("adapter", f"c={c} {h}x{h}", (batch, frames, h * h, inner, c, 4 * inner)))
    return blocks


def adapter_blocks(latent: int = SIZE // 8):
    """(channels, spatial size) of the slice's 13 adapter blocks: A-D with 3
    adapters per location, and M, at the ControlNet's residual slots."""
    from ctrl_adapter_tpu_torch.models import adapter as ad
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetConfig

    cfg = ControlNetConfig()
    n = len(cfg.block_out_channels)
    sizes = [latent]  # conv_in, then each down block's layers and its downsample
    for i in range(n):
        sizes += [latent >> i] * cfg.layers_per_block + ([latent >> (i + 1)] if i < n - 1 else [])
    locations = ("A", "B", "C", "D", "M")
    ids = ad.get_down_block_ids(locations, 3)
    channels = ad.get_down_block_channels(locations, 3)
    return [(c, sizes[i]) for i, c in zip(ids, channels)] + [
        (ad.MID_BLOCK_CHANNELS, latent >> (n - 1))]


def hybrid_rows():
    """The K3 hybrid shapes of the slice with their launches per controlled
    step (UNet + adapter) and per UNet-only step: every temporal block that
    ``dispatch_mode`` sends to "hybrid", grouped by shape."""
    from ctrl_adapter_tpu_torch.ops.fused_temporal import dispatch_mode

    rows = {}
    for tower, where, (b, f, s, c, ia, iff) in slice_temporal_blocks():
        if dispatch_mode(b, f, s, c, ia, iff, torch.bfloat16) != "hybrid":
            continue
        key = (b, f, s, c, ia)
        row = rows.setdefault(key, {"where": f"UNet {where.split()[-1]}" if tower == "unet"
                                    else "adapter",
                                    "controlled": 0, "unet_only": 0})
        row["controlled"] += 1
        row["unet_only"] += tower == "unet"
    return rows


def k1_rows(frames: int = FRAMES, batch: int = 2, itemsize: int = 2):
    """K1's calls in one adapter call, by (shape, silu): per block the spatial
    ResNet's two norms (SiLU) on (batch f, c, h, h), the temporal ResNet's two
    (SiLU) on (batch, c, f, h, h) and the transformer's input norm (no SiLU) on
    (batch f, c, h, h), where the JAX rule (``group_norm.eligible``, per
    sample) admits them: 47 of the 65 at f = 14 (SVD) and at f = 16
    (I2VGen-XL), batch 2 (CFG) or 1 (training). The temporal ResNet's norms at
    16x16 to 64x64 exceed its 12 MiB budget and run plain, as in the JAX
    package. ``itemsize`` 4: the fp32 towers' (K1 fp32), which the budget
    admits fewer of."""
    from ctrl_adapter_tpu_torch.ops.group_norm import eligible

    rows = {}
    for c, h in adapter_blocks():
        for shape, silu, n in (((batch * frames, c, h, h), False, 1),
                               ((batch * frames, c, h, h), True, 2),
                               ((batch, c, frames, h, h), True, 2)):
            if eligible(shape, 32, itemsize):
                rows[(shape, silu)] = rows.get((shape, silu), 0) + n
    return rows


I2V_FRAMES = 16


def i2v_hybrid_rows(frames: int = I2V_FRAMES, batch: int = 2):
    """The K3 hybrid shapes of the I2VGen-XL path with their launches per
    controlled and per UNet-only step: the adapter's 13 temporal blocks
    (b = 2 after CFG, 1 in training; c = 512, ia = the block's channels), each
    of which ``dispatch_mode`` sends to "hybrid"; the I2VGen-XL UNet has no
    ``TemporalBasicTransformerBlock``."""
    from ctrl_adapter_tpu_torch.models import adapter as ad
    from ctrl_adapter_tpu_torch.ops.fused_temporal import dispatch_mode

    inner = ad._INNER_HEADS * 64
    rows = {}
    for c, h in adapter_blocks():
        key = (batch, frames, h * h, inner, c)
        if dispatch_mode(*key, 4 * inner, torch.bfloat16) == "hybrid":
            rows.setdefault(key, {"where": "I2VGen-XL adapter", "controlled": 0,
                                  "unet_only": 0})["controlled"] += 1
    return rows


def i2v_flash_rows(latent: int = SIZE // 8, frames: int = I2V_FRAMES, batch: int = 2):
    """The K2 shapes (B, N, T, H) of the I2VGen-XL path with their launches
    per controlled and per UNet-only step: the flash-eligible spatial
    self-attentions of the UNet's cross-attention down and up blocks (heads =
    channels // 64) and of the adapter's spatial transformers (heads = the
    block's channels // 64), at B = batch x frames (batch 2 after CFG, 1 in
    training). "train_bwd" counts K2's backward per training step: the
    adapter's attentions and the UNet's up blocks', the ones downstream of
    the adapter's residuals (injected at the skips and after the mid block)."""
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNetConfig
    from ctrl_adapter_tpu_torch.ops.flash_attention import flash_eligible

    cfg = I2VGenXLUNetConfig()
    hd, n = cfg.attention_head_dim, len(cfg.block_out_channels)
    rows = {}

    def add(channels, size, count, unet, grad):
        t = size * size
        if flash_eligible(t, t, hd):
            row = rows.setdefault((batch * frames, channels // hd, t, hd),
                                  {"controlled": 0, "unet_only": 0, "train_bwd": 0})
            row["controlled"] += count
            row["unet_only"] += count if unet else 0
            row["train_bwd"] += count if grad else 0

    for i in range(n - 1):  # CrossAttnDownBlock3D at levels 0 .. n-2
        add(cfg.block_out_channels[i], latent >> i, cfg.layers_per_block, True, False)
    rev = cfg.block_out_channels[::-1]
    for j in range(1, n):  # CrossAttnUpBlock3D after the first up block
        add(rev[j], latent >> (n - 1 - j), cfg.layers_per_block + 1, True, True)
    for c, h in adapter_blocks(latent):
        add(c, h, 1, False, True)
    return rows


SDXL_SIZE = 1024   # bench_sdxl's resolution: 128x128 latents
SDXL_CONTROL = 64  # the SD-v1.5 ControlNet's latent size (a 512x512 control image)
SDXL_STEPS = 4     # Euler steps of the run: 2 inside the control window (end 0.6)


def sdxl_adapter_blocks(control: int = SDXL_CONTROL):
    """(channels, input size) of the SDXL adapter's 9 blocks: A-C with 3
    adapters per location, at the ControlNet's residual slots; each block
    upsamples x2 in its spatial ResNet."""
    return adapter_blocks(control)[:9]


def sdxl_k1_rows(control: int = SDXL_CONTROL, batch: int = 2, itemsize: int = 2):
    """K1's calls in one SDXL adapter call (batch 2, the CFG pair; 1 in
    training), by (shape, silu): per block the spatial ResNet's norm1 (SiLU)
    at the input size, its norm2 (SiLU) and the transformer's input norm (no
    SiLU) after the x2 upsample, where the JAX rule admits them: 17 of the 27
    (at 128x128 and at 64x64 with 640 channels they exceed its 12 MiB
    budget). ``itemsize`` 4: the fp32 towers' (K1 fp32)."""
    from ctrl_adapter_tpu_torch.ops.group_norm import eligible

    rows = {}
    for c, h in sdxl_adapter_blocks(control):
        for shape, silu in (((batch, c, h, h), True), ((batch, c, 2 * h, 2 * h), True),
                            ((batch, c, 2 * h, 2 * h), False)):
            if eligible(shape, 32, itemsize):
                rows[(shape, silu)] = rows.get((shape, silu), 0) + 1
    return rows


def sdxl_flash_rows(latent: int = SDXL_SIZE // 8, control: int = SDXL_CONTROL, batch: int = 2):
    """The K2 shapes (B, N, T, H) of the SDXL path, B = 2 after CFG (1 in
    training), with their launches per controlled and per UNet-only step: the
    self-attentions of the SDXL UNet's transformer layers (its
    cross-attention down, mid and up blocks; heads from ``SDXL_CONFIG``) and
    of the adapter's spatial transformers after the x2 upsample (heads = the
    block's channels // 64), where the JAX rule admits them. "train_bwd"
    counts K2's backward per training step: the adapter's attentions and the
    UNet's up blocks' (the residuals enter at the skips only)."""
    from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG as cfg
    from ctrl_adapter_tpu_torch.ops.flash_attention import flash_eligible

    n = len(cfg.block_out_channels)
    rows = {}

    def add(channels, heads, size, count, unet, grad):
        t, hd = size * size, channels // heads
        if flash_eligible(t, t, hd):
            row = rows.setdefault((batch, heads, t, hd),
                                  {"controlled": 0, "unet_only": 0, "train_bwd": 0})
            row["controlled"] += count
            row["unet_only"] += count if unet else 0
            row["train_bwd"] += count if grad else 0

    def level(i, count, grad):
        add(cfg.block_out_channels[i], cfg.num_attention_heads[i], latent >> i,
            count * cfg.transformer_layers_per_block[i], True, grad)

    for i, kind in enumerate(cfg.down_block_types):
        if kind.startswith("CrossAttn"):
            level(i, cfg.layers_per_block, False)
    level(n - 1, 1, False)  # the mid block
    for j, kind in enumerate(cfg.up_block_types):
        if kind.startswith("CrossAttn"):
            level(n - 1 - j, cfg.layers_per_block + 1, True)
    for c, h in sdxl_adapter_blocks(control):
        add(c, c // 64, 2 * h, 1, False, True)
    return rows


def sdxl_launches(controlled: int, unet_only: int):
    """Each kernel's launches in a run of the SDXL path at full width with
    ``controlled`` and ``unet_only`` steps, from the model configs and the JAX
    dispatch (``sdxl_k1_rows``, ``sdxl_flash_rows``): the UNet's and the
    ControlNet's norms stay plain, as in the JAX package by default."""
    k2 = sdxl_flash_rows().values()
    return dict(group_norm_silu=sum(sdxl_k1_rows().values()) * controlled,
                flash_attention=sum(r["controlled"] for r in k2) * controlled
                + sum(r["unet_only"] for r in k2) * unet_only,
                temporal_block=0, temporal_block_full=0, ln_ff_residual=0, geglu=0,
                flash_attention_bwd=0)


def train_launches(k1, k2, k3=None):
    """Each kernel's launches in one training step from one pass's K1 rows,
    K2 rows and K3 hybrid rows (batch 1): the adapter and the UNet run under
    gradient checkpointing, so each forward kernel launches in the forward
    and again in the backward's recompute; K2's backward once per attention
    downstream of the adapter (``train_bwd``). The other kernels' gradients
    take their plain versions (``mirror_vjp``) and launch nothing."""
    return dict(group_norm_silu=2 * sum(k1.values()),
                flash_attention=2 * sum(r["controlled"] for r in k2.values()),
                temporal_block=2 * sum(r["controlled"] for r in (k3 or {}).values()),
                temporal_block_full=0, ln_ff_residual=0, geglu=0,
                flash_attention_bwd=sum(r["train_bwd"] for r in k2.values()))


def i2v_train_launches():
    """Launches per I2VGen-XL training step at 1 x 16 x 512^2, whatever the
    number of experts (the ControlNets launch no kernel)."""
    return train_launches(k1_rows(I2V_FRAMES, 1), i2v_flash_rows(batch=1),
                          i2v_hybrid_rows(I2V_FRAMES, 1))


def sdxl_train_launches():
    """Launches per SDXL training step at 1 x 1024^2."""
    return train_launches(sdxl_k1_rows(batch=1), sdxl_flash_rows(batch=1))


def per_step_total(name, rows, key):
    """Print the sum of launches x kernel ms against launches x bound over
    ``rows``: host-inclusive (``ms``), then on device time, warm and cold L2."""
    n = sum(r[key] for r in rows)
    bound = sum(r[key] * r["bound_ms"] for r in rows)
    step = "training" if key.startswith("train") else key.replace("_", " ")
    for field, what in (("ms", "host-inclusive"), ("device_ms", "device, warm L2"),
                        ("cold_ms", "device, cold L2")):
        if any(r[key] and r[field] is None for r in rows):
            print(f"  {name} per {step} step ({what}): not measured")
            continue
        ms = sum(r[key] * r[field] for r in rows if r[key])
        print(f"  {name} per {step} step ({what}): {n} launches, {ms:.3f} ms "
              f"of kernel against {bound:.3f} ms of bound ({100 * bound / ms:.1f} %)")


def kernel_times(fn, iters: int = 5, attempts: int = 3):
    """Device ms per call of each CUDA kernel ``fn()`` launches, from
    ``torch.profiler``. One profiled call gives each kernel's launches per
    call; a run of ``iters`` calls counts only if the profiler recorded
    exactly ``iters`` times as many launches of every kernel, and each
    kernel's time per call is then its total over ``iters``. The profiler was
    seen to record no device time for a short run, and late in a long one to
    keep the events of only some of the calls: such a run is made again, up
    to ``attempts`` times in all, then None."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(n):
        """{kernel name: [µs, launches]} of ``n`` calls."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.self_device_time_total > 0:
                name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
                t = out.setdefault(name, [0.0, 0])
                t[0] += ev.self_device_time_total
                t[1] += ev.count
        return out

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        once, run = profiled(1), profiled(iters)
        if once and run.keys() == once.keys() and all(
                run[name][1] == iters * once[name][1] for name in run):
            return {name: us / 1000 / iters for name, (us, _) in run.items()}
    return None


# The device function that each kernel's wrapper launches exactly once per
# counted launch (K1: its one-launch kernel or its two-pass apply; K2 bwd: its
# main pass; K3 hybrid: its QKV + attention kernel)
TRACE_NAMES = {"group_norm_silu": ("gn_fused_kernel", "gn_apply_kernel"),
               "flash_attention": ("flash_fwd_kernel",),
               "flash_attention_bwd": ("flash_bwd_kernel",),
               "temporal_block": ("hybrid_qkv_attn_kernel",),
               "temporal_block_full": ("temporal_full_kernel",),
               "ln_ff_residual": ("ln_ff_kernel",), "geglu": ("geglu_kernel",)}


def kernel_counters():
    """The launch counter of each kernel (name: ``Kernel``)."""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    return {"group_norm_silu": gn.KERNEL, "flash_attention": fa.KERNEL,
            "temporal_block": ft.KERNEL, "temporal_block_full": ft.KERNEL_FULL,
            "ln_ff_residual": fb.KERNEL, "geglu": ff.KERNEL,
            "flash_attention_bwd": fa.KERNEL_BWD}


def traced_launches(names, kernels):
    """{kernel: events of its traced device function among ``names``}, for
    each of ``kernels``."""
    import re

    out = {}
    for kernel in kernels:
        pattern = re.compile(r"\b(" + "|".join(TRACE_NAMES[kernel]) + r")\b")
        out[kernel] = sum(1 for name in names if pattern.search(name))
    return out


_DeviceEvent = collections.namedtuple("_DeviceEvent", "name start end")  # µs
PROFILER_COST = {"traces": 0, "traced_s": 0.0, "read_s": 0.0}


def device_activity(run, attempts: int = 3):
    """``run()`` under ``torch.profiler``: (busy, span, per_name) of the CUDA
    kernels it launched, in µs. busy is the union of their spans, span the
    time from the first one's start to the last one's end (1 - busy / span is
    the device's idle share), per_name {kernel name: [µs, calls]}.

    The profiler was seen to drop events late in a long run. A trace counts
    only if it holds an event of each port kernel's traced function for every
    launch its counter saw during the run; else ``run()`` is made again, up
    to ``attempts`` times in all, and then the result is None ("not
    measured"). A partial trace is never scaled up.

    The device events are read off the profiler's raw kineto results, with
    the names and times ``prof.events()`` gives them (``_rewrite_name``,
    microseconds from the trace's start): ``prof.events()`` builds a Python
    event for every host-side launch record as well, seconds a trace at the
    main path's sizes. ``PROFILER_COST`` adds up the traces' seconds."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    counters = kernel_counters()
    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = {name: k.launches for name, k in counters.items()}
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        launched = {name: k.launches - before[name] for name, k in counters.items()}
        result = prof.profiler.kineto_results
        start, names, kern = result.trace_start_ns(), {}, []
        for e in result.events():
            if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
                raw = e.name()
                if raw not in names:
                    names[raw] = _rewrite_name(name=raw, with_wildcard=True)
                kern.append(_DeviceEvent(names[raw], (e.start_ns() - start) / 1000,
                                         (e.end_ns() - start) / 1000))
        PROFILER_COST["traces"] += 1
        PROFILER_COST["traced_s"] += t1 - t0
        PROFILER_COST["read_s"] += time.perf_counter() - t1
        traced = traced_launches([e.name for e in kern], counters)
        short = {name: (traced[name], n) for name, n in launched.items() if traced[name] < n}
        if kern and not short:
            break
        print(f"  device_activity: trace {attempt + 1} of {attempts} is partial ("
              + (", ".join(f"{name} {t} events of {n} launches" for name, (t, n) in short.items())
                 if short else "no device kernels") + ")")
    else:
        print("  device_activity: not measured (every trace was partial)")
        return None
    spans = sorted((e.start, e.end) for e in kern)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    per_name = {}
    for e in kern:
        t = per_name.setdefault(e.name, [0.0, 0])
        t[0] += e.end - e.start
        t[1] += 1
    return busy, spans[-1][1] - spans[0][0], per_name


def print_activity(prefix, activity, per: int = 1, unit: str = "step", top: int = 8):
    """Print ``device_activity``'s busy time and kernel span per ``unit`` (over
    ``per`` of them), the idle share and the ``top`` kernels, or that they were
    not measured."""
    if activity is None:
        print(f"{prefix}device busy time and idle share not measured (torch.profiler "
              f"dropped events in every trace)")
        return
    busy, span, per_name = activity
    print(f"{prefix}device busy {busy / 1000 / per:.1f} ms/{unit} of a {span / 1000 / per:.1f} "
          f"ms/{unit} kernel span, idle share {1 - busy / span:.3%}; its top kernels:")
    for name, (us, calls) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {us / 1000 / per:8.2f} ms/{unit} {us / busy:6.1%} x{calls // per:5d}/{unit} "
              f"{name[:90]}")


# ------------------------------------------------------------------ kernels
def report(label, err, ms, pms, cost, library=None, single_call=True):
    """One checked row: print the kernel's time beside its plain version's, the
    PyTorch library calls' (``library``: name -> ms or None) and its roofline
    bound; return the row for the JSON line (``library_ms``: the first call,
    None unless it alone computes the same function, ``single_call``)."""
    lib = "".join(f", {name} {'n/a' if t is None else f'{t:.3f} ms'}"
                  for name, t in (library or {}).items())
    print(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms{lib}; bound {cost.bound_ms:.4f} ms "
          f"({cost.bound_by}), kernel at {100 * cost.bound_ms / ms:.1f} % of it")
    return {"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "library_ms": next(iter(library.values())) if library and single_call else None,
            "bound_ms": cost.bound_ms, "bound_by": cost.bound_by}


def sdpa_times(q, k, v):
    """``F.scaled_dot_product_attention`` on the kernel's inputs: the backend
    PyTorch picks by default, then the flash and cuDNN backends forced one at a
    time (None where PyTorch refuses the inputs). Yardsticks only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    default = SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    times = {f"SDPA default ({default})": cuda_ms(sdpa)}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                times[f"SDPA {backend.name}"] = cuda_ms(sdpa)
        except RuntimeError:
            times[f"SDPA {backend.name}"] = None
    return times


K2_BWD_SHAPES = ((14, 5, 4096, 64), (14, 10, 1024, 64), (2, 4, 1024, 128))
# K2 backward's calls per training step at each shape: the UNet's 6 up-block
# spatial attentions at 64x64 (T = 4096, 5 heads) and the adapter's 6 at 32x32
# (T = 1024, 10 heads); H = 128 is a check row off the path
K2_BWD_PER_STEP = (6, 6, 0)


def sdpa_bwd_times(q, k, v, do):
    """The backward of ``F.scaled_dot_product_attention`` on the kernel's
    inputs, its flash and cuDNN backends forced one at a time: forward +
    backward, minus the forward (None where PyTorch refuses the inputs).
    Yardsticks only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg))
                both = cuda_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do))
            times[f"SDPA {backend.name} backward"] = both - fwd
        except RuntimeError:
            times[f"SDPA {backend.name} backward"] = None
    return times


def k2_bwd_row(rand, flush, shape):
    """K2's forward with its log-sum-exp and K2's backward against their
    plain versions at ``shape`` = (B, N, T, H), in bf16; two backward calls on
    the same inputs (dQ, dK and dV equal to the bit, dQ's run-to-run max
    difference printed); the backward timed beside its bound and SDPA's backward, on
    device time (warm and cold L2) and per launch of its three
    (``kernel_times``)."""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    bf = torch.bfloat16
    b_, n_, t_, h_ = shape
    label = f"({b_},{n_},{t_},{h_})"
    q, k, v = (rand(b_, t_, n_ * h_).to(bf).view(b_, t_, n_, h_).transpose(1, 2)
               for _ in range(3))
    do = rand(b_, t_, n_ * h_).to(bf).view(b_, t_, n_, h_).transpose(1, 2)
    out, lse = fa._forward(q, k, v, True)
    want_out, want_lse = fa._torch_attention(q, k, v, True)
    torch.cuda.synchronize()
    compare(f"K2 forward {label} output", out, want_out, atol=1e-2, rtol=2e-2, rel_norm=1e-2)
    compare(f"K2 forward {label} log-sum-exp", lse, want_lse, atol=1e-3, rtol=1e-4)
    got = fa.attention_bnth_bwd(q, k, v, out, do, lse)
    want = fa._torch_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    # P and dS are rounded to bf16 before their products (as the TPU kernel
    # does); the plain version keeps them in fp32: ~0.5 % in norm
    err = max(compare(f"K2 backward {label} d{name}", g, w, atol=5e-2 * w.abs().max().item(),
                      rtol=5e-2, rel_norm=2e-2)
              for name, g, w in zip("qkv", got, want))
    # dK and dV: each CTA owns its keys; dQ: each query tile's partials added
    # across the key blocks in a turn order fixed by the indices
    again = fa.attention_bnth_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(got, again)]
    ddq = (got[0].float() - again[0].float()).abs().max().item()
    print(f"  K2 backward {label}, two calls: " + ", ".join(
        f"d{name} {'equal' if ok else 'DIFFER'}" for name, ok in zip("QKV", same))
        + f" to the bit; run-to-run max |dQ1 - dQ2| {ddq:.3e}")
    if not all(same):
        raise RuntimeError(f"K2 backward {label}: dQ, dK or dV differs between two calls")
    del got, want, again, want_out, want_lse
    bwd = lambda: fa.attention_bnth_bwd(q, k, v, out, do, lse)  # noqa: E731
    ms = cuda_ms(bwd)
    pms = cuda_ms(lambda: fa._torch_attention_bwd(q, k, v, out, do, lse), iters=3, reps=3,
                  warmup=1)
    row = report(label, err, ms, pms, rl.attention_bwd(b_, n_, t_, h_),
                 sdpa_bwd_times(q, k, v, do))
    split = kernel_times(bwd)
    print("    the launches of one call (device, warm L2): " + (
        "not measured" if split is None else
        "; ".join(f"{name} {t:.4f} ms" for name, t in split.items())))
    device_line(row, bwd, flush)
    row.update(dq_run_to_run=ddq)
    return row


def check_flash_bwd(dev, card, rand, flush):
    """K2's backward (``k2_bwd_row``) at the SVD training path's shapes (B =
    14 frames, no CFG) and at H = 128, with the per-training-step sums; the
    forward with and without the log-sum-exp at (28, 5, 4096, 64), in turns."""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    print(f"K2 backward (bf16 in and out, fp32 accumulation) on {card}")
    rows = []
    for shape, per_step in zip(K2_BWD_SHAPES, K2_BWD_PER_STEP):
        row = k2_bwd_row(rand, flush, shape)
        row.update(training=per_step)
        rows.append(row)
    per_step_total("K2 backward", rows, "training")
    # the serving path's forward: no log-sum-exp written
    q, k, v = (rand(28, 4096, 320).to(bf).view(28, 4096, 5, 64).transpose(1, 2)
               for _ in range(3))
    times = {False: [], True: []}
    for with_lse in (False, True, True, False):  # in turns
        times[with_lse].append(cuda_ms(lambda: fa._forward(q, k, v, with_lse)))
    print(f"  K2 forward (28,5,4096,64), in turns: without the log-sum-exp "
          f"{', '.join(f'{t:.4f}' for t in times[False])} ms; with it "
          f"{', '.join(f'{t:.4f}' for t in times[True])} ms")
    rows[0].update(fwd_ms=times[False], fwd_lse_ms=times[True])
    return rows


def check_kernel_grads(dev, card, rand):
    """Under grad, K1, K3 hybrid, K3 full, K4 and K5 run forward once and take
    their gradient from autograd of the plain version (``mirror_vjp``): at the
    training path's shapes (batch 1, 14 frames, no CFG), their gradients
    against those of the plain version run under autograd, in bf16."""
    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    bf = torch.bfloat16
    print(f"kernel gradients (bf16, the plain version's VJP on the saved inputs) on {card}")
    r = lambda *s, scale=1.0: rand(*s, scale=scale).to(bf)  # noqa: E731

    def attn_args(c, ia, heads, s_):
        return (r(1, 14, s_, c), r(1, s_, c, scale=0.5), 1.0 + r(c, scale=0.1), r(c, scale=0.1),
                *(r(ia, c, scale=c ** -0.5) for _ in range(3)), r(c, ia, scale=ia ** -0.5),
                r(c, scale=0.1), heads, 1e-5)

    cases = [
        ("K1 (14,320,64,64) silu", gn.KERNEL, gn.group_norm_silu, gn._torch_group_norm_silu,
         (r(14, 320, 64, 64), 1.0 + r(320, scale=0.1), r(320, scale=0.1), 32, 1e-6, True)),
        ("K3 hybrid UNet L1 (1,14,1024,640)", ft.KERNEL, ft.temporal_block,
         ft._torch_temporal_block, attn_args(640, 640, 10, 1024)),
        ("K3 full UNet L0 (1,14,4096,320)", ft.KERNEL_FULL, ft.temporal_block_full,
         ft._torch_temporal_block, attn_args(320, 320, 5, 4096)
         + (ff_weights(rand, 320, 1280, 320), ff_weights(rand, 320, 1280, 320), True)),
        ("K4 (57344,320) inner 1280", fb.KERNEL, fb.ln_ff_kernel, fb._torch_ln_ff_residual,
         (r(57344, 320), *ff_weights(rand, 320, 1280, 320), 1e-5, True, True)),
        ("K5 (57344,320) -> 2x1280", ff.KERNEL, ff.geglu_kernel, ff._torch_geglu,
         (r(57344, 320), r(2560, 320, scale=320 ** -0.5), r(2560, scale=0.1), True)),
    ]

    def run(fn, args, cotangent=None):
        leaves = [a.detach().requires_grad_() if torch.is_tensor(a) else
                  tuple(t.detach().requires_grad_() for t in a) if isinstance(a, tuple) else a
                  for a in args]
        out = fn(*leaves)
        flat = [t for a in leaves for t in (a if isinstance(a, tuple) else (a,))
                if torch.is_tensor(t)]
        if cotangent is None:
            cotangent = rand(*out.shape, scale=0.01).to(out.dtype)
        return torch.autograd.grad(out, flat, cotangent), cotangent

    for label, kernel, wrapper, plain, args in cases:
        before = kernel.launches
        got, cot = run(wrapper, args)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise RuntimeError(f"{label}: {kernel.launches - before} launches under grad, want 1")
        want, _ = run(plain, args, cot)
        # the same plain VJP on the same saved inputs: equal up to the order of
        # the library's sums
        for i, (x, y) in enumerate(zip(got, want)):
            compare(f"{label} grad[{i}]", x, y, atol=1e-2 * y.abs().max().item() + 1e-6,
                    rtol=1e-2, rel_norm=1e-2)


def k1_row(rand, flush, shape, silu, n, flat=False):
    """K1 against its plain version at ``shape`` (bf16, G = 32, eps 1e-6; with
    ``flat`` half the groups near-constant), timed beside its bound, its plain
    version and the PyTorch call(s) for the same function, on host and device
    time; ``n`` launches per controlled step."""
    import torch.nn.functional as F

    from ctrl_adapter_tpu_torch.ops import group_norm as gn
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    label = (f"({','.join(map(str, shape))})" + (" silu" if silu else "")
             + (" near-constant groups" if flat else ""))
    x = rand(*shape)
    if flat:  # half the groups: 0.1 + 1e-4 noise, variance far below eps
        x[:, : shape[1] // 2] = 0.1 + 1e-4 * x[:, : shape[1] // 2]
    x = x.to(torch.bfloat16)
    w = (1.0 + rand(shape[1], scale=0.1)).to(torch.bfloat16)
    b = rand(shape[1], scale=0.1).to(torch.bfloat16)
    got = gn.group_norm_silu(x, w, b, 32, 1e-6, silu)
    want = gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu)
    torch.cuda.synchronize()
    err = compare(f"K1 {label} ({n} per adapter call)", got, want, atol=1e-2, rtol=1e-2)
    ms = cuda_ms(lambda: gn.group_norm_silu(x, w, b, 32, 1e-6, silu))
    pms = cuda_ms(lambda: gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu))
    library = {"F.group_norm": cuda_ms(lambda: F.group_norm(x, 32, w, b, 1e-6))}
    if silu:  # two calls: no single PyTorch call computes GroupNorm + SiLU
        library["F.silu(F.group_norm)"] = cuda_ms(
            lambda: F.silu(F.group_norm(x, 32, w, b, 1e-6)))
    row = report(label, err, ms, pms, rl.group_norm(shape, silu), library, not silu)
    # device time apart from the host's: the kernel against the yardstick
    # it must not lose to (F.group_norm; with SiLU, F.silu(F.group_norm))
    kernel_dev = device_times(lambda: gn.group_norm_silu(x, w, b, 32, 1e-6, silu), flush)
    yard = list(library)[-1]
    yard_dev = device_times(
        (lambda: F.silu(F.group_norm(x, 32, w, b, 1e-6))) if silu
        else (lambda: F.group_norm(x, 32, w, b, 1e-6)), flush)
    bound = row["bound_ms"]
    for what, k, y in zip(("warm L2", "cold L2"), kernel_dev, yard_dev):
        share = "" if k is None else f", kernel at {100 * bound / k:.1f} % of the bound"
        verdict = ("" if k is None or y is None
                   else "; no slower: met" if k <= y else "; no slower: NOT met")
        print(f"    device, {what}: kernel {fmt_ms(k)}, {yard} {fmt_ms(y)}{share}{verdict}")
    row.update(controlled=n, device_ms=kernel_dev[0], cold_ms=kernel_dev[1],
               library_device_ms=yard_dev[0], library_cold_ms=yard_dev[1])
    return row


def k2_row(rand, shape, flush=None, library_device=False):
    """K2 against its plain version at (B, N, T, 64) on head-split views of
    (B, T, N*H) projections, as the Attention module passes them, timed beside
    its bound, its plain version and SDPA; with ``flush``, also on device
    time, warm and with L2 cold, and with ``library_device`` SDPA's default
    backend on the same clocks."""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    b_, n_, t_, h_ = shape
    q, k, v = (rand(b_, t_, n_ * h_).to(torch.bfloat16).view(b_, t_, n_, h_).transpose(1, 2)
               for _ in range(3))
    got = fa.attention_bnth(q, k, v)
    # the plain version runs the batch in chunks of ~1 GiB of fp32 logits
    want = fa._torch_attention(q, k, v)
    torch.cuda.synchronize()
    # the outputs average T keys (std ~0.03 here), far below atol: the norm
    # check catches a K/V tile that is skipped or read from the wrong slot
    label = f"({b_},{n_},{t_},{h_})"
    err = compare(f"K2 {label}", got, want, atol=1e-2, rtol=2e-2, rel_norm=1e-2)
    ms = cuda_ms(lambda: fa.attention_bnth(q, k, v))
    pms = cuda_ms(lambda: fa._torch_attention(q, k, v), iters=3, reps=3, warmup=1)
    library = sdpa_times(q, k, v)
    row = report(label, err, ms, pms, rl.attention(b_, n_, t_, t_, h_), library)
    if flush is not None:  # the yardstick: the first library call, SDPA's default backend
        import torch.nn.functional as F

        device_line(row, lambda: fa.attention_bnth(q, k, v), flush,
                    (next(iter(library)), lambda: F.scaled_dot_product_attention(q, k, v))
                    if library_device else None)
    return row


def hybrid_row(rand, flush, label, dims, n_ctrl, n_unet):
    """K3 hybrid against its plain version at dims = (b, f, s, c, heads), with a
    cross bias (the output, the block's update and both against an fp32 run),
    timed beside its bound and its plain version, its two launches apart on
    device time, warm and with L2 cold; ``n_ctrl`` and ``n_unet`` launches per
    controlled and per UNet-only step."""
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    bf = torch.bfloat16
    b_, f_, s_, c_, heads = dims
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
    err = compare(f"K3 {label} ({n_ctrl} per controlled step, {n_unet} per UNet-only step)",
                  got, want, atol=3e-2, rtol=2e-2)
    # the residual x dominates the output, so a skipped head could hide under
    # the atol: the update alone is held to a relative norm
    update_check(f"K3 {label}", got, want, x, cb)
    fp32_check(f"K3 {label}", got, want, ft._torch_temporal_block(x.float(), cb.float(),
                                                                 *to_fp32(args)))
    ms = cuda_ms(lambda: ft.temporal_block(x, cb, *args))
    pms = cuda_ms(lambda: ft._torch_temporal_block(x, cb, *args))
    split = kernel_times(lambda: ft.temporal_block(x, cb, *args))
    print("    launches: " + ("not measured (no device time from torch.profiler)" if split is None
                              else ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())))
    row = report(label, err, ms, pms, rl.temporal_block(b_, f_, s_, c_, ia, True))
    warm = None if split is None else sum(split.values())
    cold = cold_ms(lambda: ft.temporal_block(x, cb, *args), flush)
    print(f"    device: kernel {fmt_ms(warm)} warm L2, {fmt_ms(cold)} cold L2, at "
          f"{100 * row['bound_ms'] / cold:.1f} % of the bound (cold)")
    row.update(controlled=n_ctrl, unet_only=n_unet, split=split, device_ms=warm, cold_ms=cold)
    return row


def check_i2vgenxl_kernels(dev, card):
    """Phase 3 at the I2VGen-XL path's shapes (16 frames, b*f = 32): K1 at the
    adapter's norms the JAX rule admits, K2 at the UNet's and the adapter's
    flash-eligible self-attentions, K3 hybrid at the adapter's 13 temporal
    blocks (f = 16: the tiles hold no padded frame row), and at 4 key frames
    of a sparse-frame run; per-step sums of each; then at the I2VGen-XL
    training step's shapes (b*f = 16), K2's backward included
    (``train_rows``). Returns the rows by kernel."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    print(f"I2VGen-XL shapes: K1 group_norm_silu (bf16, G=32, eps 1e-6) on {card}")
    k1 = [k1_row(rand, flush, shape, silu, n)
          for (shape, silu), n in k1_rows(I2V_FRAMES).items()]
    per_step_total("K1 (I2VGen-XL)", k1, "controlled")
    print(f"I2VGen-XL shapes: K2 flash attention (bf16, fp32 softmax) on {card}")
    k2 = []
    for shape, r in i2v_flash_rows().items():
        row = k2_row(rand, shape, flush)
        row.update(controlled=r["controlled"], unet_only=r["unet_only"])
        print(f"    {r['controlled']} per controlled step, {r['unet_only']} per UNet-only step")
        k2.append(row)
    per_step_total("K2 (I2VGen-XL)", k2, "controlled")
    per_step_total("K2 (I2VGen-XL)", k2, "unet_only")
    print(f"I2VGen-XL shapes: K3 temporal attention block (bf16, head_dim 64, cross bias) "
          f"on {card}")
    k3 = [hybrid_row(rand, flush, f"{r['where']} ({b_},{f_},{s_},{c_}) ia={ia}",
                     (b_, f_, s_, c_, ia // 64), r["controlled"], 0)
          for (b_, f_, s_, c_, ia), r in i2v_hybrid_rows().items()]
    per_step_total("K3 hybrid (I2VGen-XL)", k3, "controlled")
    # sparse frames: the adapter runs at the key frames' count
    k3 += [hybrid_row(rand, flush, f"sparse f=4 ({b_},4,{s_},{c_}) ia={ia}",
                      (b_, 4, s_, c_, ia // 64), 0, 0)
           for (b_, _, s_, c_, ia) in list(i2v_hybrid_rows(4))[:3]]
    rows = {"group_norm_silu": k1, "flash_attention": k2, "temporal_block": k3}
    train = train_rows(rand, flush, card, "I2VGen-XL", "train_i2vgenxl",
                       k1_rows(I2V_FRAMES, 1), i2v_flash_rows(batch=1),
                       i2v_hybrid_rows(I2V_FRAMES, 1))
    return {name: rows.get(name, []) + train.get(name, []) for name in {*rows, *train}}


def train_rows(rand, flush, card, model, key, k1, k2, k3=None):
    """Phase 3 at a training path's shapes (batch 1, no CFG): K1, K2 forward
    and backward and K3 hybrid at the rows of one pass, each with its
    launches per training step under ``key`` (``train_launches``: the
    forward kernels twice, K2's backward once per attention downstream of
    the adapter), and their per-step sums. Returns the rows by kernel."""
    print(f"{model} training shapes: K1 group_norm_silu (bf16, G=32, eps 1e-6) on {card}")
    out = {"group_norm_silu": [], "flash_attention": [], "flash_attention_bwd": [],
           "temporal_block": []}
    for (shape, silu), n in k1.items():
        out["group_norm_silu"].append(dict(k1_row(rand, flush, shape, silu, n),
                                           controlled=0, **{key: 2 * n}))
    print(f"{model} training shapes: K2 flash attention, forward and backward, on {card}")
    for shape, r in k2.items():
        row = k2_row(rand, shape, flush)
        row.update(controlled=0, unet_only=0, **{key: 2 * r["controlled"]})
        out["flash_attention"].append(row)
        if r["train_bwd"]:
            row = k2_bwd_row(rand, flush, shape)
            row.update(**{key: r["train_bwd"]})
            out["flash_attention_bwd"].append(row)
        print(f"    {2 * r['controlled']} forward and {r['train_bwd']} backward launches per "
              f"training step")
    for (b_, f_, s_, c_, ia), r in (k3 or {}).items():
        out["temporal_block"].append(dict(hybrid_row(
            rand, flush, f"{model} training ({b_},{f_},{s_},{c_}) ia={ia}",
            (b_, f_, s_, c_, ia // 64), 0, 0), **{key: 2 * r["controlled"]}))
    for name, label in (("group_norm_silu", "K1"), ("flash_attention", "K2"),
                        ("flash_attention_bwd", "K2 backward"), ("temporal_block", "K3 hybrid")):
        if out[name]:
            per_step_total(f"{label} ({model} training)", out[name], key)
    return {name: rows for name, rows in out.items() if rows}


def check_sdxl_kernels(dev, card):
    """Phase 3 at the SDXL path's shapes (batch 2, the CFG pair): K1 at the
    adapter's norms the JAX rule admits, K2 at the SDXL UNet's self-attentions
    (T = 4096 and 1024) and the adapter's after its x2 upsample (T = 16384 in
    the A blocks); per-step sums of each; then at the SDXL training step's
    shapes (batch 1), K2's backward included (``train_rows``). Returns the
    rows by kernel."""
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    print(f"SDXL shapes: K1 group_norm_silu (bf16, G=32, eps 1e-6) on {card}")
    k1 = [k1_row(rand, flush, shape, silu, n) for (shape, silu), n in sdxl_k1_rows().items()]
    per_step_total("K1 (SDXL)", k1, "controlled")
    print(f"SDXL shapes: K2 flash attention (bf16, fp32 softmax) on {card}")
    k2 = []
    for shape, r in sdxl_flash_rows().items():
        row = k2_row(rand, shape, flush)
        row.update(controlled=r["controlled"], unet_only=r["unet_only"])
        print(f"    {r['controlled']} per controlled step, {r['unet_only']} per UNet-only step")
        k2.append(row)
    per_step_total("K2 (SDXL)", k2, "controlled")
    per_step_total("K2 (SDXL)", k2, "unet_only")
    rows = {"group_norm_silu": k1, "flash_attention": k2}
    train = train_rows(rand, flush, card, "SDXL", "train_sdxl", sdxl_k1_rows(batch=1),
                       sdxl_flash_rows(batch=1))
    return {name: rows.get(name, []) + train.get(name, []) for name in {*rows, *train}}


def check_kernels(dev, card):
    import torch.nn.functional as F

    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    results = {}

    # K1: every GroupNorm(+SiLU) shape of one adapter call (k1_rows), and a
    # check row of near-constant groups; bf16 output, fp32 statistics. The
    # first row (no SiLU, the transformer-input norm) is the one with a single
    # PyTorch call for the same function.
    print(f"K1 group_norm_silu (bf16, G=32, eps 1e-6) on {card}")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cases = [(shape, silu, n, False) for (shape, silu), n in k1_rows().items()]
    cases.append(((28, 320, 64, 64), False, 0, True))
    k1 = [k1_row(rand, flush, *case) for case in cases]
    per_step_total("K1", k1, "controlled")
    results["group_norm_silu"] = k1

    # K2: self-attention of the UNet and adapter spatial blocks, H = 64, on
    # head-split views of (B, T, N*H) projections as the Attention module passes.
    print(f"K2 flash attention (bf16, fp32 softmax) on {card}")
    k2 = [k2_row(rand, (b_, n_, t_, 64), flush, True)
          for b_, n_, t_ in ((28, 5, 4096), (28, 10, 1024))]
    results["flash_attention"] = k2
    results["flash_attention_bwd"] = check_flash_bwd(dev, card, rand, flush)
    check_kernel_grads(dev, card, rand)

    # K3 hybrid: the temporal attention sub-block with cross bias at every
    # shape the dispatch sends it on the slice (hybrid_rows), and two check
    # rows the wrapper takes but the dispatch sends elsewhere (UNet level 0,
    # c = 1280)
    print(f"K3 temporal attention block (bf16, f=14, head_dim 64, cross bias) on {card}")
    cases = [(f"{r['where']} ({b_},{f_},{s_},{c_}) ia={ia}", (b_, f_, s_, c_, ia // 64),
              r["controlled"], r["unet_only"])
             for (b_, f_, s_, c_, ia), r in hybrid_rows().items()]
    cases += [("check L0 (2,14,4096,320) ia=320", (2, 14, 4096, 320, 5), 0, 0),
              ("check (2,14,64,1280) ia=1280", (2, 14, 64, 1280, 20), 0, 0)]
    k3 = [hybrid_row(rand, flush, *case) for case in cases]
    per_step_total("K3 hybrid", k3, "controlled")
    per_step_total("K3 hybrid", k3, "unet_only")
    results["temporal_block"] = k3

    # K3 "full": the whole UNet level-0 temporal block in one launch; then,
    # on a small input, with erf gelu (what CTRL_ADAPTER_EXACT_GELU=1 asks for),
    # and both forms told apart
    print(f"K3 full temporal block (bf16, (2,14,4096,320), 5 heads, cross bias) on {card}")
    atol, rtol, _ = FF_TOL["temporal_block_full"]
    x, cb, args = k3_full_inputs(rand)
    args += (True,)
    got = ft.temporal_block_full(x, cb, *args)
    want = ft._torch_temporal_block(x, cb, *args)
    torch.cuda.synchronize()
    # three residual sub-blocks, each rounding the bf16 stream at other points
    # in the two versions; both are also held against an fp32 run of the plain version
    err = compare("K3 full UNet (2,14,4096,320)", got, want, atol=atol, rtol=rtol)
    fp32_check("K3 full", got, want, ft._torch_temporal_block(x.float(), cb.float(),
                                                              *to_fp32(args)))
    ms = cuda_ms(lambda: ft.temporal_block_full(x, cb, *args))
    pms = cuda_ms(lambda: ft._torch_temporal_block(x, cb, *args))
    row = report("UNet L0 (2,14,4096,320) 5 heads", err, ms, pms,
                 rl.temporal_block_full(2, 14, 4096, 320, 320, 1280, True))
    device_line(row, lambda: ft.temporal_block_full(x, cb, *args), flush)
    erf_args = args[:-1] + (False,)
    xs, cbs = x[:, :, :256].contiguous(), cb[:, :256].contiguous()
    got = ft.temporal_block_full(xs, cbs, *erf_args)
    want = ft._torch_temporal_block(xs, cbs, *erf_args)
    torch.cuda.synchronize()
    err_erf = compare("K3 full (2,14,256,320), erf gelu", got, want, atol=atol, rtol=rtol)
    fp32_check("K3 full, erf gelu", got, want, ft._torch_temporal_block(
        xs.float(), cbs.float(), *to_fp32(erf_args)))
    # the forms differ by less than the atol at these inputs: tell them apart
    # on a residual stream of ~1e-2 through FFs that expose the gap
    xf, cbf = rand(2, 14, 256, 320, scale=1e-2).to(bf), rand(2, 256, 320, scale=2e-3).to(bf)
    form = (torch.ones(320, device=dev, dtype=bf), torch.zeros(320, device=dev, dtype=bf),
            *(rand(320, 320, scale=2e-3).to(bf) for _ in range(4)),
            rand(320, scale=2e-3).to(bf), 5, 1e-5, gelu_form_ff(rand, 320, 1280, 320),
            gelu_form_ff(rand, 320, 1280, 320))
    gelu_form_check("K3 full (2,14,256,320)", lambda a, k: (
        ft.temporal_block_full if k else ft._torch_temporal_block)(xf, cbf, *form, a))
    row["max_abs_err"] = max(err, err_erf)
    results["temporal_block_full"] = [row]

    # K4: the level-0 spatial transformer FF, 28 x 4096 rows (launches per step
    # in the fused-block configuration: phase 5); then with erf gelu on a
    # 4,160-row slice, and both forms told apart
    print(f"K4 ln_ff_residual (bf16, tanh gelu, residual) on {card}")
    atol, rtol, _ = FF_TOL["ln_ff_residual"]
    x, w = k4_inputs(rand)
    got = fb.ln_ff_kernel(x, *w, 1e-5, True, True)
    want = fb._torch_ln_ff_residual(x, *w, 1e-5, True, True)
    torch.cuda.synchronize()
    err = compare("K4 (114688,320) inner 1280", got, want, atol=atol, rtol=rtol)
    ms = cuda_ms(lambda: fb.ln_ff_kernel(x, *w, 1e-5, True, True))
    pms = cuda_ms(lambda: fb._torch_ln_ff_residual(x, *w, 1e-5, True, True))
    row = report("(114688,320) inner 1280", err, ms, pms, rl.ln_ff(114688, 320, 1280, 320, True))
    device_line(row, lambda: fb.ln_ff_kernel(x, *w, 1e-5, True, True), flush)
    xs = x[:4160]
    got = fb.ln_ff_kernel(xs, *w, 1e-5, False, True)
    want = fb._torch_ln_ff_residual(xs, *w, 1e-5, False, True)
    torch.cuda.synchronize()
    row["max_abs_err"] = max(err, compare("K4 (4160,320) inner 1280, erf gelu", got, want,
                                          atol=atol, rtol=rtol))
    xf, form = rand(4160, 320, scale=1e-2).to(bf), gelu_form_ff(rand, 320, 1280, 320)
    gelu_form_check("K4 (4160,320)", lambda a, k: (
        fb.ln_ff_kernel if k else fb._torch_ln_ff_residual)(xf, *form, 1e-5, a, True))
    results["ln_ff_residual"] = [row]

    # K5: GEGLU projection at the level-0 and level-1 widths. Its outputs at
    # c = 640 (std ~0.1) sit far below the atol: a norm check as K2's. Then
    # both gelu forms told apart.
    print(f"K5 geglu (bf16, tanh gelu) on {card}")
    atol, rtol, rel_norm = FF_TOL["geglu"]
    k5 = []
    for m_, c_ in K5_SHAPES:
        x, w, b_ = k5_inputs(rand, m_, c_)
        got = ff.geglu_kernel(x, w, b_, True)
        want = ff._torch_geglu(x, w, b_, True)
        torch.cuda.synchronize()
        err = compare(f"K5 ({m_},{c_}) -> 2x{4 * c_}", got, want, atol=atol, rtol=rtol,
                      rel_norm=rel_norm)
        ms = cuda_ms(lambda: ff.geglu_kernel(x, w, b_, True))
        pms = cuda_ms(lambda: ff._torch_geglu(x, w, b_, True))
        row = report(f"({m_},{c_}) -> 2x{4 * c_}", err, ms, pms, rl.geglu(m_, c_, 4 * c_))
        device_line(row, lambda: ff.geglu_kernel(x, w, b_, True), flush)
        # the (M, 2D) product K5 fuses, alone: it writes twice K5's output, so
        # it is a reference for the product, not a yardstick of the same function
        linear = cuda_ms(lambda: F.linear(x, w, b_))
        print(f"    reference for the product: F.linear(x, w, b) alone {linear:.3f} ms "
              f"(host-inclusive), writing the (M, 2D) pre-activation")
        row["linear_ms"] = linear
        k5.append(row)
    xf, (_, _, wf, bf_, _, _) = rand(4096, 320).to(bf), gelu_form_ff(rand, 320, 1280, 320)
    gelu_form_check("K5 (4096,320)", lambda a, k: (
        ff.geglu_kernel if k else ff._torch_geglu)(xf, wf, bf_, a))
    results["geglu"] = k5
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
def swapped(module, name, make):
    """``module.name`` replaced by ``make(module.name)`` inside the block."""
    wrapper = getattr(module, name)
    setattr(module, name, make(wrapper))
    try:
        yield
    finally:
        setattr(module, name, wrapper)


@contextlib.contextmanager
def plain_kernels():
    """Swap each kernel wrapper in its ops module for its plain version (the
    modules call the wrappers through those modules), for the reference runs."""
    import ctrl_adapter_tpu_torch.ops.flash_attention as fa
    import ctrl_adapter_tpu_torch.ops.fused_block as fb
    import ctrl_adapter_tpu_torch.ops.fused_ff as ff
    import ctrl_adapter_tpu_torch.ops.fused_temporal as ft
    import ctrl_adapter_tpu_torch.ops.group_norm as gn

    swaps = [(gn, "group_norm_silu", gn._torch_group_norm_silu),
             (fa, "attention_bnth", fa._torch_attention),
             (ft, "temporal_block", ft._torch_temporal_block),
             (ft, "temporal_block_full", ft._torch_temporal_block),
             (fb, "ln_ff_kernel", fb._torch_ln_ff_residual),
             (ff, "geglu_kernel", ff._torch_geglu)]
    with contextlib.ExitStack() as stack:
        for module, name, plain in swaps:
            stack.enter_context(swapped(module, name, lambda _, plain=plain: plain))
        yield


def k1_everywhere():
    """The K1 dispatch before the repair: every norm that asks for K1 takes it,
    whatever its size (the JAX shape rule switched off)."""
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    return swapped(gn, "eligible", lambda _: lambda *args: True)


@contextlib.contextmanager
def environ(values: dict):
    """Set the environment variables ``values`` inside the block, and restore them."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value


def env_switch(name: str):
    """Set an opt-in switch of the JAX package (``name=1``) and restore it."""
    return environ({name: "1"})


def check_video(video, label, frames=FRAMES):
    if tuple(video.shape) != (1, frames, SIZE, SIZE, 3):
        raise RuntimeError(f"{label}: video shape {tuple(video.shape)}")
    vf = video.float()
    if not torch.isfinite(vf).all():
        raise RuntimeError(f"{label}: video has non-finite values")
    if vf.min().item() < 0.0 or vf.max().item() > 1.0:
        raise RuntimeError(f"{label}: video values outside [0, 1]")
    print(f"{label}: video {tuple(video.shape)} finite, range [{vf.min().item():.4f}, "
          f"{vf.max().item():.4f}], std {vf.std().item():.4f}")


def drive(pipe, inputs, kw, kernels, steps):
    """One generate() to the video with every launch count from 0 just before
    it; returns the video, the counts read just after, and the seconds."""
    for k in kernels.values():
        k.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = pipe.generate(**inputs, **kw, num_inference_steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return video, {name: k.launches for name, k in kernels.items()}, seconds


@contextlib.contextmanager
def launches_per_step(pipe, kernels, ms=None):
    """Count the launches of each of ``kernels`` (name: counter) in each
    denoise step of the runs inside: yields a list that gets, per step,
    (whether the step ran the ControlNet, {name: launches in the step}). A
    step starts at the first tower call after the previous step's UNet call
    and ends with its own. Given a list ``ms``, each step also appends its
    host-clock ms to it, the card synchronised at both ends."""
    steps, state = [], {"mark": None, "controlled": False, "t0": None}

    def start(*_):
        if state["mark"] is None:
            if ms is not None:
                torch.cuda.synchronize()
                state["t0"] = time.perf_counter()
            state.update(mark={n: k.launches for n, k in kernels.items()}, controlled=False)

    def controlnet(*_):
        start()
        state["controlled"] = True

    def unet_done(*_):
        if ms is not None:
            torch.cuda.synchronize()
            ms.append(1000 * (time.perf_counter() - state["t0"]))
        steps.append((state["controlled"],
                      {n: k.launches - state["mark"][n] for n, k in kernels.items()}))
        state["mark"] = None

    handles = [pipe.controlnet.register_forward_pre_hook(controlnet),
               pipe.unet.register_forward_pre_hook(start),
               pipe.unet.register_forward_hook(unet_done)]
    try:
        yield steps
    finally:
        for h in handles:
            h.remove()


def ms_per_step(pipe, inputs, kw, steps):
    """Host-clock ms per denoise step of a generate() to the latents, and the latents."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = pipe.generate(**inputs, **kw, num_inference_steps=steps, output_type="latent")
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / steps, latents


def fp32_copy(pipe):
    """A copy of ``pipe`` whose towers are float32 copies of its own."""
    ref = copy.copy(pipe)
    for name in ("unet", "controlnet", "adapter", "vae", "router"):
        if getattr(pipe, name, None) is not None:
            setattr(ref, name, copy.deepcopy(getattr(pipe, name)).float())
    return ref


def reference_check(pipe, label, small, skw):
    """On a small input (``small``, ``skw``: 4 frames at 256x256, 2 steps, the
    latents), the bf16 kernel path and the bf16 plain path, each against an
    fp32 run of the plain path with the same weights."""
    got = pipe.generate(**small, **skw)
    with plain_kernels():
        plain = pipe.generate(**small, **skw)
        ref = fp32_copy(pipe).generate(**small, **skw)
    torch.cuda.synchronize()
    scale = ref.abs().max()
    err_k = ((got - ref).abs().max() / scale).item()
    err_p = ((plain - ref).abs().max() / scale).item()
    err_kp = ((got - plain).abs().max() / scale).item()
    print(f"{label} reference (1x4x256x256, 2 steps, latents, errors relative to max|fp32|): "
          f"bf16 kernel path vs fp32 {err_k:.3e}, bf16 plain path vs fp32 {err_p:.3e}, "
          f"kernel vs plain {err_kp:.3e}; tolerance: kernel path within 2x the plain "
          f"path's error + 1e-2")
    if not (torch.isfinite(got).all() and err_k <= 2 * err_p + 1e-2):
        raise RuntimeError(f"{label}: kernel path is farther from the fp32 reference than allowed")


def promotion_check(pipe, small, skw):
    """The JAX pipelines multiply the ControlNet's bf16 residuals by an fp32
    conditioning scale (``ctrl_adapter_tpu/pipelines/svd.py:300``), which
    promotes them, and the adapter's work on them, to fp32; the port keeps
    bf16. On the small input, with the plain kernels on both sides, the port's
    bf16 path and the same path with the residuals promoted (the ControlNet's
    outputs upcast to fp32 and the adapter run in fp32, on a float32 copy of its
    bf16 weights; the UNet adds the adapter's outputs in its bf16), each against
    an fp32 run. Prints the distances and the verdict: a fault where the bf16
    path is farther from fp32 than twice the promoted path."""
    promoted = copy.copy(pipe)
    adapter32 = copy.deepcopy(pipe.adapter).float()

    def controlnet32(*args, **kwargs):
        downs, mid = pipe.controlnet(*args, **kwargs)
        return [d.float() for d in downs], mid.float()

    promoted.controlnet, promoted.adapter = controlnet32, adapter32
    with plain_kernels():
        bf16 = pipe.generate(**small, **skw).float()
        prom = promoted.generate(**small, **skw).float()
        ref = fp32_copy(pipe).generate(**small, **skw).float()
    torch.cuda.synchronize()
    del adapter32
    scale, norm = ref.abs().max(), ref.norm()
    errs = {}
    for label, x in (("bf16", bf16), ("promoted", prom)):
        errs[label] = (((x - ref).abs().max() / scale).item(), ((x - ref).norm() / norm).item())
    verdict = ("fault: the bf16 residuals are farther from fp32 than twice the promoted ones"
               if errs["bf16"][0] > 2 * errs["promoted"][0] else
               "known difference: within twice the promoted path's distance")
    print(f"fp32 promotion (1x4x256x256, 2 steps, latents, plain kernels; max error relative to "
          f"max|fp32|, norm error relative to |fp32|): bf16 residuals {errs['bf16'][0]:.4e} "
          f"max, {errs['bf16'][1]:.4e} norm; promoted residuals {errs['promoted'][0]:.4e} max, "
          f"{errs['promoted'][1]:.4e} norm; ratio {errs['bf16'][0] / errs['promoted'][0]:.3f} "
          f"(max), {errs['bf16'][1] / errs['promoted'][1]:.3f} (norm): {verdict}")
    return errs


def per_kind(label, steps):
    """{"controlled" / "unet_only": {kernel: launches}} from ``launches_per_step``'s
    list; raises when two steps of a kind differ."""
    out = {}
    for controlled, counts in steps:
        kind = "controlled" if controlled else "unet_only"
        if out.setdefault(kind, counts) != counts:
            raise RuntimeError(f"{label}: launches differ between {kind} steps: {steps}")
    return out


def run_slices(dev, card, kernels):
    """Phases 4 and 5; returns the launch counts of the default and the
    fused-block runs, and K4's launches per controlled and per UNet-only step
    of the latter."""
    from ctrl_adapter_tpu_torch.pipelines.common import control_window

    bf = torch.bfloat16
    t0 = time.perf_counter()
    pipe, n_params = build_pipeline(dev, bf)
    torch.cuda.synchronize()
    print(f"slice: built SVD UNet + ControlNet + adapter + temporal VAE, {n_params / 1e9:.3f} B "
          f"params bf16, in {time.perf_counter() - t0:.1f} s")
    inputs = slice_inputs(dev, bf, FRAMES, SIZE, SEED + 1)
    kw = dict(height=SIZE, width=SIZE, num_frames=FRAMES, skip_conv_in=True,
              control_latent_size=SIZE // 8, device=dev)

    # phase 4, the default configuration: the main path run
    torch.cuda.reset_peak_memory_stats()
    with launches_per_step(pipe, kernels) as steps:
        video, launches, t_first = drive(pipe, inputs, kw, kernels, STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = per_kind("slice", steps)
    print(f"slice: launches during the run {launches}; per step {per_step}")
    check_video(video, "slice")
    on_path = ("group_norm_silu", "flash_attention", "temporal_block", "temporal_block_full")
    missing = [name for name in on_path if launches[name] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    # the JAX dispatch: per UNet call (one per step) K3 "full" at level 0 (down 2 +
    # up 3 blocks) and K3 "hybrid" at level 1 (5 blocks), the module path at level 2
    # and mid; K3 "hybrid" in the 13 adapter blocks of each controlled step; K4
    # and K5 only under their switches
    lo, hi = control_window(STEPS, 0.0, 0.8)  # generate()'s default control window
    want = dict(temporal_block_full=5 * STEPS, temporal_block=5 * STEPS + 13 * (hi - lo),
                ln_ff_residual=0, geglu=0)
    wrong = {name: (launches[name], n) for name, n in want.items() if launches[name] != n}
    if wrong:
        raise RuntimeError(f"temporal dispatch differs from the JAX rule (got, want): {wrong}")
    print(f"slice: dispatch as JAX: K3 full {want['temporal_block_full']} "
          f"(5 per UNet call), K3 hybrid {want['temporal_block']} (5 per UNet call + 13 per "
          f"adapter call), K4 and K5 none")
    # steady state: the denoise loop three times (the host clock moves by up
    # to tens of ms between runs; the median is the slice's ms/step), then the
    # decode
    runs = []
    for _ in range(3):
        ms, latents = ms_per_step(pipe, inputs, kw, STEPS)
        runs.append(ms)
    steady = statistics.median(runs)
    t0 = time.perf_counter()
    pipe._decode(latents, 0.18215)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    print(f"slice on {card}: {STEPS} steps, 1x{FRAMES}x{SIZE}x{SIZE}, CFG, skip_conv_in:")
    print(f"  first generate() {t_first:.3f} s (denoise + decode, cold); denoise "
          f"{steady:.1f} ms/step, median of runs 2-4 ({', '.join(f'{r:.1f}' for r in runs)}; "
          f"control window covers {hi - lo} of {STEPS} steps)")
    print(f"  decode {t_decode:.3f} s second run (one chunk of {FRAMES} frames)")
    print(f"  peak device memory {peak_gb:.2f} GiB (first generate())")
    # K1 where the JAX rule admits the norm: 47 of the adapter's 65 per
    # controlled step; the 18 temporal-ResNet norms at 16x16..64x64 run plain.
    # Against the dispatch before the repair (K1 at all 65), one run each.
    k1_want = sum(k1_rows().values()) * (hi - lo)
    if launches["group_norm_silu"] != k1_want:
        raise RuntimeError(f"K1 launched {launches['group_norm_silu']} times, want {k1_want} "
                           f"(the JAX rule's 47 adapter norms per controlled step)")
    # The host clock spreads by more than the ~10 ms at stake, so each turn
    # also reads the device's busy time over one more profiled run.
    rule_ms = {"JAX rule": [], "K1 at every adapter norm": []}
    for rule in ("JAX rule", "K1 at every adapter norm"):
        with k1_everywhere() if rule != "JAX rule" else contextlib.nullcontext():
            before = kernels["group_norm_silu"].launches
            ms, _ = ms_per_step(pipe, inputs, kw, STEPS)
            n_k1 = kernels["group_norm_silu"].launches - before
            activity = device_activity(lambda: ms_per_step(pipe, inputs, kw, STEPS))
        busy = None if activity is None else activity[0] / 1000 / STEPS
        rule_ms[rule].append((ms, busy))
        print(f"  K1 dispatch, {rule}: {n_k1} K1 launches, denoise {ms:.1f} ms/step (host), "
              f"{fmt_ms(busy)}/step device busy")
    print(f"slice on {card}: the K1 repair's cost, {STEPS} steps each (host; device busy): "
          + "; ".join(f"{rule} " + ", ".join(f"{h:.1f}; {fmt_ms(d)}" for h, d in ts) + "/step"
                      for rule, ts in rule_ms.items()))
    small = slice_inputs(dev, bf, 4, 256, SEED + 2)
    skw = dict(height=256, width=256, num_frames=4, num_inference_steps=2, skip_conv_in=True,
               control_latent_size=32, device=dev, output_type="latent")
    reference_check(pipe, "slice", small, skw)
    promotion_check(pipe, small, skw)

    # phase 5, the fused-block configuration (K4 on the 320-wide FFs)
    fb_steps = 2
    with env_switch("CTRL_ADAPTER_FUSED_BLOCK"):
        with launches_per_step(pipe, {"ln_ff_residual": kernels["ln_ff_residual"]}) as steps:
            video, launches_fb, t_fb = drive(pipe, inputs, kw, kernels, fb_steps)
        k4_steps = [(controlled, n["ln_ff_residual"]) for controlled, n in steps]
        print(f"fused-block slice: launches during the run {launches_fb}; K4's per step "
              f"(controlled, launches) {k4_steps}")
        k4_per_step = {}
        for controlled, n in k4_steps:
            k4_per_step.setdefault("controlled" if controlled else "unet_only", set()).add(n)
        if len(k4_steps) != fb_steps or any(len(v) != 1 for v in k4_per_step.values()):
            raise RuntimeError(f"K4's launches per step differ between steps of a kind: "
                               f"{k4_steps}")
        k4_per_step = {kind: ns.pop() for kind, ns in k4_per_step.items()}
        check_video(video, "fused-block slice")
        missing = [name for name in (*on_path, "ln_ff_residual") if launches_fb[name] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the fused-block path: {missing}")
        # K4 on the 320-wide spatial blocks: UNet level 0 (down 2 + up 3) per
        # step, ControlNet level 0 (2) per controlled step
        lo, hi = control_window(fb_steps, 0.0, 0.8)
        if launches_fb["ln_ff_residual"] != 5 * fb_steps + 2 * (hi - lo):
            raise RuntimeError(f"K4 launched {launches_fb['ln_ff_residual']} times, want "
                               f"{5 * fb_steps + 2 * (hi - lo)} (the JAX rule's 320-wide FFs)")
        fused_ms, _ = ms_per_step(pipe, inputs, kw, fb_steps)
        reference_check(pipe, "fused-block slice", small, skw)
    default_ms, _ = ms_per_step(pipe, inputs, kw, fb_steps)
    print(f"fused-block slice on {card}: {fb_steps} steps (control window covers {hi - lo}), "
          f"first generate() {t_fb:.3f} s; denoise {fused_ms:.1f} ms/step with "
          f"CTRL_ADAPTER_FUSED_BLOCK=1, {default_ms:.1f} ms/step default (same steps, run "
          f"right after)")
    del pipe
    return launches, launches_fb, k4_per_step, per_step


TRAIN_STEPS = 3
# the single-key cross-attentions (one CLIP image token) read only to_v and
# to_out: their norm2, to_q and to_k get no gradient, as in the JAX package
UNREAD_BY_SINGLE_KEY = (".norm2.", ".attn2.to_q.", ".attn2.to_k.")


def train_batch(dev, frames, size, seed):
    """One video of ``frames`` frames at size x size from a seeded generator:
    frames in [-1, 1], a depth map (one channel repeated to three) as the
    ControlNet condition, the CLIP image embedding and the ControlNet text."""
    g = torch.Generator(device=dev).manual_seed(seed)
    depth = torch.rand(1, frames, size, size, 1, generator=g, device=dev).expand(-1, -1, -1, -1, 3)
    return {"frames": torch.rand(1, frames, size, size, 3, generator=g, device=dev) * 2 - 1,
            "controlnet_cond": depth.contiguous(),
            "image_embeddings": torch.randn(1, 1, 1024, generator=g, device=dev) * 0.1,
            "controlnet_text_emb": torch.randn(1, 77, 768, generator=g, device=dev) * 0.02}


def _loss_and_grads(trainer, batch, draws):
    """The step's loss and the adapter's (and router's) gradient, one fp32
    tensor per parameter."""
    params = trainer.optimizer.params
    for p in params:
        p.grad = None
    loss = trainer.loss(batch, draws)
    loss.backward()
    grads = [(torch.zeros_like(p) if p.grad is None else p.grad).float() for p in params]
    for p in params:
        p.grad = None
    return loss.detach().float(), grads


def training_faults():
    """Faults of the training path's kernels that its reference check must
    see (label: context manager): K1 that drops its SiLU, K2's backward that
    leaves head 0 out (dQ, dK and dV zeroed there), K3 hybrid that returns
    its input. (dQ alone zeroed in a head passes the check at these random
    weights: their nearly flat attention logits give dQ and dK a negligible
    share of the gradient, and dV carries it.)"""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa

    def no_head_0(bwd):
        def run(*args):
            grads = [g.clone() for g in bwd(*args)]
            for g in grads:
                g[:, 0] = 0
            return tuple(grads)
        return run

    faults = faulty_kernels()
    return {"K1 without its SiLU": faults["K1 without its SiLU"],
            "K2 backward without head 0": swapped(fa, "attention_bnth_bwd", no_head_0),
            "K3 hybrid returning its input": faults["K3 hybrid returning its input"]}


def train_reference_check(trainer, dev, label, batch, draws, cfg, faults=()):
    """On a small input (``batch``, ``draws``, ``cfg``), the bf16 kernel
    path's loss and gradients and the bf16 plain path's, each against an fp32
    run of the plain path with the same weights and draws. Two rules: the
    loss and the whole adapter (and router) gradient within 2x the plain
    path's relative error + 1e-2; and each tensor's gradient error within 2x
    the plain path's + 1e-3 of the fp32 gradient's global norm, which sees a
    fault that only a few tensors carry. Then each of ``faults``
    (``training_faults``) must fail one of them."""
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer

    full_cfg = trainer.config
    trainer.config = cfg
    try:
        got = _loss_and_grads(trainer, batch, draws)
        with plain_kernels():
            plain = _loss_and_grads(trainer, batch, draws)
            fp32 = lambda m: None if m is None else copy.deepcopy(m).float()  # noqa: E731
            ref_trainer = CtrlAdapterTrainer(
                cfg, *(fp32(m) for m in (
                    trainer.unet, trainer.controlnet, trainer.adapter, trainer.vae)),
                router=fp32(trainer.router), device=dev)
            ref = _loss_and_grads(ref_trainer, batch, draws)
        del ref_trainer
        norm = torch.linalg.vector_norm
        n = len(trainer.names)
        parts = {"loss": lambda x: [x[0]], "adapter gradient": lambda x: x[1][:n]}
        if trainer.router is not None:
            parts["router gradient"] = lambda x: x[1][n:]
        g_ref = norm(torch.cat([g.flatten() for g in ref[1]])).item()
        err_p = [norm(a - b).item() for a, b in zip(plain[1], ref[1])]

        def judge(run, verbose):
            """(whole-vector errors ok, the largest per-tensor error over its
            allowance, with the tensor's name)."""
            ok = True
            for what, pick in parts.items():
                flat = lambda x: torch.cat([t.flatten() for t in pick(x)])  # noqa: E731
                r = flat(ref)
                e_k = (norm(flat(run) - r) / norm(r)).item()
                e_p = (norm(flat(plain) - r) / norm(r)).item()
                good = e_k <= 2 * e_p + 1e-2 and bool(torch.isfinite(flat(run)).all())
                ok = ok and good
                if verbose:
                    print(f"  {what}: bf16 kernel path vs fp32 {e_k:.3e}, bf16 plain path vs "
                          f"fp32 {e_p:.3e} (relative norm; tolerance 2x the plain path's + "
                          f"1e-2) {'ok' if good else 'FAIL'}")
            names = trainer.names + trainer.router_names
            worst = max(((norm(a - b).item() / (2 * p + 1e-3 * g_ref), name)
                         for a, b, p, name in zip(run[1], ref[1], err_p, names)))
            return ok, worst

        print(f"{label} training reference ({cfg.n_sample_frames} frames of "
              f"{tuple(batch['frames'].shape[2:4])}, the loss and every gradient tensor):")
        ok, (ratio, where) = judge(got, True)
        print(f"  per tensor: largest kernel-path error / (2 x plain + 1e-3 of the fp32 "
              f"gradient's norm) {ratio:.3f} ({where}; tolerance 1)")
        if not ok or ratio > 1.0:
            raise RuntimeError(f"{label} training: the kernel path is farther from the fp32 "
                               f"reference than allowed")
        for fault in faults:
            with training_faults()[fault]:
                ok, (ratio, where) = judge(_loss_and_grads(trainer, batch, draws), False)
            fails = not ok or ratio > 1.0
            print(f"  control, {fault}: whole-vector rules {'met' if ok else 'failed'}, largest "
                  f"per-tensor ratio {ratio:.3f} ({where}): {'fails' if fails else 'PASSES'} "
                  f"the check")
            if not fails:
                raise RuntimeError(f"{label} training: the reference check passes a kernel "
                                   f"path with {fault}")
    finally:
        trainer.config = full_cfg


def check_read_grads(label, trainer, single_key=True):
    """After a step: every adapter parameter the forward reads has a nonzero
    gradient; with ``single_key`` (one CLIP image token as the adapter's
    encoder states) the single-key cross-attentions' norm2, to_q and to_k are
    unread, as in the JAX package."""
    params = trainer.optimizer.params[:len(trainer.names)]
    unread = [n for n, p in zip(trainer.names, params) if p.grad is None]
    zero = [n for n, p in zip(trainer.names, params) if p.grad is not None and not p.grad.any()]
    odd = [n for n in unread if not (single_key and any(k in n for k in UNREAD_BY_SINGLE_KEY))]
    print(f"{label}: {len(params) - len(unread)} of {len(params)} adapter tensors have a "
          f"gradient, {len(zero)} of them zero; {len(unread)} unread"
          + (" (the single-key cross-attentions' norm2, to_q, to_k)" if single_key else ""))
    if zero or odd:
        raise RuntimeError(f"{label}: zero gradients {zero[:5]}, unread {odd[:5]}")


def step_parts(trainer, batch, draws):
    """One more step in its three parts, each on the host clock around a
    synchronize: {part: seconds}."""
    params, masters = trainer.optimizer.params, trainer.optimizer.masters
    parts = {}
    for p in params:
        p.grad = None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = trainer.loss(batch, draws)
    torch.cuda.synchronize()
    parts["forward (VAE encode, ControlNet, adapter, UNet, loss)"] = time.perf_counter() - t1
    loss.backward()
    torch.cuda.synchronize()
    parts["backward (with the adapter's and the UNet's recompute)"] = (
        time.perf_counter() - t1 - sum(parts.values()))
    trainer.optimizer.step([torch.zeros_like(m) if p.grad is None else p.grad.float()
                            for p, m in zip(params, masters)])
    torch.cuda.synchronize()
    parts["optimizer (clip, AdamW, masters to bf16)"] = (
        time.perf_counter() - t1 - sum(parts.values()))
    return parts


def run_training(dev, card, kernels):
    """Phase 8: the SVD training step at the full width of
    ``configs/svd_train_depth.yaml`` (1 x 14 x 512 x 512, skip_conv_in, bf16
    towers, fp32 adapter masters, gradient checkpointing) for 3 steps; returns
    the launch counts of the 3 steps."""
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

    bf = torch.bfloat16
    t0 = time.perf_counter()
    pipe, n_params = build_pipeline(dev, bf)
    cfg = TrainConfig(model_name="svd", n_sample_frames=FRAMES, output_fps=14,
                      control_latent_size=SIZE // 8, skip_conv_in=True,
                      gradient_checkpointing=True)
    trainer = CtrlAdapterTrainer(cfg, pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae,
                                 device=dev)
    del pipe
    params, masters = trainer.optimizer.params, trainer.optimizer.masters
    n_adapter = sum(p.numel() for p in params)
    torch.cuda.synchronize()
    print(f"training: built the SVD UNet, ControlNet, adapter and temporal VAE ({n_params / 1e9:.3f}"
          f" B params, bf16; the adapter's {n_adapter / 1e6:.1f} M with fp32 masters) in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(dev, FRAMES, SIZE, SEED + 5)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    start = [m.clone() for m in masters]

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset()
    step_ms, per_step = [], []
    for step in range(TRAIN_STEPS):
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        step_ms.append(1000 * (time.perf_counter() - t1))
        per_step.append({name: k.launches - before[name] for name, k in kernels.items()})
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        print(f"training step {step + 1}: loss {loss:.6f}, grad_norm {norm:.6e}, "
              f"{step_ms[-1]:.1f} ms, launches {per_step[-1]}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise RuntimeError(f"training step {step + 1}: non-finite loss or grad_norm")
        if step == 0:
            check_read_grads("training", trainer)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: sum(s[name] for s in per_step) for name in kernels}
    # where a step's time goes: one more step in its three parts
    parts = step_parts(trainer, batch, trainer.draw(gen, 1, FRAMES, SIZE // 8, SIZE // 8))
    print("training step in parts: " + "; ".join(f"{k} {1000 * v:.1f} ms"
                                                  for k, v in parts.items()))
    # one more step under torch.profiler (which slows the host several-fold,
    # so it is not timed) for the device's busy time and idle share
    activity = device_activity(lambda: trainer.train_step(batch, generator=gen))
    moved = sum(not torch.equal(a, b) for a, b in zip(start, masters))
    print(f"training: {moved} of {len(masters)} master tensors moved in "
          f"{trainer.optimizer.update_count} updates")
    if moved != len(masters):
        raise RuntimeError("training: some masters did not move")
    del start

    # the path's kernels: K2's backward 12 times a step (the UNet's 6 up-block
    # and the adapter's 6 spatial attentions at 64x64 and 32x32), K1, K2, K3
    # full and K3 hybrid forward
    for s in per_step:
        if s["flash_attention_bwd"] != 12:
            raise RuntimeError(f"training: K2 backward launched {s['flash_attention_bwd']} "
                               f"times in a step, want 12")
    missing = [n for n in ("group_norm_silu", "flash_attention", "temporal_block",
                           "temporal_block_full") if not all(s[n] for s in per_step)]
    if missing:
        raise RuntimeError(f"training: kernels not launched in every step: {missing}")
    print(f"training: K2 forward {per_step[0]['flash_attention']} launches a step: the "
          f"forward's 16 (the UNet's 10 spatial attentions at 64x64 and 32x32, the 4 of its "
          f"down blocks without the log-sum-exp, as nothing there needs a gradient; the "
          f"adapter's 6), and the checkpointed recompute of the adapter and the UNet in the "
          f"backward runs them again; K1 {per_step[0]['group_norm_silu']} (47 adapter norms, "
          f"forward and recompute)")
    print(f"training on {card}: 1x{FRAMES}x{SIZE}x{SIZE}, skip_conv_in, bf16 towers, fp32 "
          f"masters, gradient checkpointing: step 1 {step_ms[0]:.1f} ms (cold); "
          f"{statistics.mean(step_ms[1:]):.1f} ms/step over steps 2-{TRAIN_STEPS} "
          f"({', '.join(f'{t:.1f}' for t in step_ms[1:])}); peak device memory {peak_gb:.2f} "
          f"GiB")
    print_activity("  a step under torch.profiler: ", activity)
    if activity is not None:
        k2_bwd = [v for name, v in activity[2].items() if "flash_bwd" in name]
        print(f"training: K2 backward in the profiled step: "
              f"{sum(us for us, _ in k2_bwd) / 1000:.2f} ms of device time over "
              f"{sum(n for _, n in k2_bwd)} launches (3 a call)")
    # (the checkpoint round trip of masters and AdamW state is phase 14's:
    # checkpoint-3 read back, the resume from checkpoint-2)
    # on 2 frames at 128x128
    train_reference_check(
        trainer, dev, "svd", train_batch(dev, 2, 128, SEED + 7),
        trainer.draw(torch.Generator(device=dev).manual_seed(SEED + 8), 1, 2, 16, 16),
        dataclasses.replace(cfg, n_sample_frames=2, control_latent_size=16))
    return launches, per_step


I2V_STEPS = 4        # DDIM steps of the depth run: 3 inside the control window (end 0.8)
I2V_MULTI_STEPS = 2  # of the multi-condition run (end 1.0: both controlled)
I2V_EXPERTS, I2V_ACTIVE = 7, 2


def build_i2vgenxl(dev, dtype, num_experts):
    """The I2VGen-XL towers at the full width of the JAX bench's
    ``i2vgenxl_depth`` / ``i2vgenxl_multi`` (``bench.py:349-424``): the UNet
    (320/640/1280/1280, cross 1024), ``num_experts`` SD-v1.5 ControlNets, the
    13-block adapter (A-D + M, one block each, temporal ResNet and
    transformer), the 2D VAE, in ``dtype``, and a simple-weights router
    (float32), all with weights drawn on the card from a seeded generator:
    scale 0.02 for the towers, 1 for the router's gates (their init)."""
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
    from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL

    kw = dict(device=dev, dtype=dtype)
    unet = I2VGenXLUNet(**kw)
    nets = [ControlNetModel(**kw) for _ in range(num_experts)]
    adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                adapter_locations=("A", "B", "C", "D", "M"),
                                add_temporal_resnet=True, add_temporal_transformer=True, **kw)
    vae = AutoencoderKL(**kw)
    router = ControlNetRouter(num_experts, "simple_weights", device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    n_params = 0
    with torch.no_grad():
        for module, scale in ((unet, 0.02), *((n, 0.02) for n in nets), (adapter, 0.02),
                              (vae, 0.02), (router, 1.0)):
            module.eval()
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * scale)
                n_params += p.numel()
    return unet, nets, adapter, vae, router, n_params


def i2v_inputs(dev, dtype, experts, frames, size, seed):
    """Prompt (2, 77, 1024), ControlNet prompt (2, 77, 768), CLIP image
    embedding (1, 1, 1024), first-frame latent, ``experts`` condition videos
    in [0, 1] and the initial latents, from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale: (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)  # noqa: E731
    lat = size // 8
    return dict(prompt_embeds=r(2, 77, 1024, scale=0.02),
                controlnet_prompt_embeds=r(2, 77, 768, scale=0.02),
                image_embeddings=r(1, 1, 1024, scale=0.1),
                first_frame_latent=r(1, lat, lat, 4, scale=0.1),
                control_images=torch.rand(experts, frames, size, size, 3, generator=g,
                                          device=dev).to(dtype),
                latents=torch.randn(1, frames, lat, lat, 4, generator=g, device=dev))


def i2v_launches(controlled: int, unet_only: int):
    """Each kernel's launches in a run of the I2VGen-XL path at full width with
    ``controlled`` and ``unet_only`` steps, from the model configs and the
    JAX dispatch (``k1_rows``, ``i2v_flash_rows``, ``i2v_hybrid_rows``): one
    adapter call per controlled step whatever the number of experts."""
    k2 = i2v_flash_rows().values()
    return dict(group_norm_silu=sum(k1_rows(I2V_FRAMES).values()) * controlled,
                flash_attention=sum(r["controlled"] for r in k2) * controlled
                + sum(r["unet_only"] for r in k2) * unet_only,
                temporal_block=sum(r["controlled"] for r in i2v_hybrid_rows().values())
                * controlled, temporal_block_full=0, ln_ff_residual=0, geglu=0,
                flash_attention_bwd=0)


def tower_ms(modules, run):
    """ms of each call of each module (name: module) during ``run()``, from
    CUDA events recorded by forward hooks."""
    events, handles = {}, []
    for name, module in modules.items():
        def pre(*_, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])

        def post(*_, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: [a.elapsed_time(b) for a, b in evs] for name, evs in events.items()}


def check_steps(label, steps, want_steps, launches=None):
    """Each step's launches against ``launches`` (``i2v_launches`` by default)
    of one step of its kind."""
    launches = launches or i2v_launches
    if len(steps) != want_steps:
        raise RuntimeError(f"{label}: {len(steps)} steps seen, want {want_steps}")
    for controlled, counts in steps:
        want = launches(1, 0) if controlled else launches(0, 1)
        if counts != want:
            raise RuntimeError(f"{label}: launches in a {'controlled' if controlled else 'UNet-only'}"
                               f" step {counts}, want (JAX dispatch) {want}")
    kinds = sorted({c for c, _ in steps}, reverse=True)
    print(f"{label}: launches per step as the JAX dispatch gives them: "
          + "; ".join(f"{'controlled' if c else 'UNet-only'} step "
                      f"{ {k: v for k, v in launches(int(c), int(not c)).items() if v} }"
                      for c in kinds))


def faulty_kernels():
    """Faults of the video and SDXL paths' kernels that their reference checks
    must see, each a wrapper around the kernel's own (label: context manager): K1
    that drops its SiLU, K2 that leaves head 0 out, K3 hybrid that returns
    its input."""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    def no_silu(k1):
        return lambda x, w, b, groups, eps, silu: k1(x, w, b, groups, eps, False)

    def no_head_0(k2):
        def run(q, k, v):
            out = k2(q, k, v).clone()
            out[:, 0] = 0
            return out
        return run

    return {"K1 without its SiLU": swapped(gn, "group_norm_silu", no_silu),
            "K2 without head 0": swapped(fa, "attention_bnth", no_head_0),
            "K3 hybrid returning its input":
                swapped(ft, "temporal_block", lambda k3: lambda x, *_: x.clone())}


def step_outputs(pipe, kwargs, combine=None):
    """``pipe.generate(**kwargs)`` with forward hooks that keep the first
    controlled step's adapter outputs (its down residuals, then the mid), the
    UNet's output (both CFG halves) and the CFG-combined noise prediction
    (``combine`` of the UNet's output; by default CFG with
    ``kwargs["guidance_scale"]``), as float32. The combination alone would
    hide a fault: a change common to both halves passes it once, while their
    independent rounding errors pass ~12 times (8 and 9 in quadrature at
    guidance 9)."""
    from ctrl_adapter_tpu_torch.pipelines.common import classifier_free_guidance

    if combine is None:
        combine = lambda out: classifier_free_guidance(out, kwargs["guidance_scale"])  # noqa: E731
    kept = {}

    def adapter(_module, _args, out):
        if "adapter" not in kept:
            down, mid = out
            kept["adapter"] = [d.float() for d in down] + ([] if mid is None else [mid.float()])

    def unet(_module, _args, out):
        if "adapter" in kept and "unet" not in kept:
            kept["unet"] = out.float()
            kept["noise"] = combine(kept["unet"])

    handles = [pipe.adapter.register_forward_hook(adapter),
               pipe.unet.register_forward_hook(unet)]
    try:
        pipe.generate(**kwargs)
    finally:
        for h in handles:
            h.remove()
    return kept["adapter"] + [kept["unet"], kept["noise"]]


def step_reference_check(pipe, label, kwargs, combine=None, faults=None):
    """The first controlled step of ``pipe.generate(**kwargs)`` on a small
    input: its adapter outputs, UNet output and CFG-combined noise prediction
    (``combine``, as ``step_outputs``) from the bf16 kernel path and from the
    bf16 plain path, each against an fp32 run of the plain path with the same
    weights. Per tensor, two errors:
    the max abs difference over the fp32 tensor's max abs, and the norm of
    the difference over the fp32 tensor's norm (which sees a fault spread
    over many values that rounding's largest error hides); the kernel path's
    must be within 2x the plain path's, each. Then each fault of
    ``faulty_kernels`` (those named in ``faults``, all by default: the faults
    of kernels the path runs) must fail that rule."""
    got = step_outputs(pipe, kwargs, combine)
    with plain_kernels():
        plain = step_outputs(pipe, kwargs, combine)
        ref = step_outputs(fp32_copy(pipe), kwargs, combine)
    torch.cuda.synchronize()
    names = [f"adapter output {i}" for i in range(len(ref) - 2)] + ["UNet output", "noise"]
    metrics = {"max": lambda d, r: d.abs().max() / r.abs().max(),
               "norm": lambda d, r: torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r)}

    def errors(outs):
        """{metric: [error per tensor]}."""
        return {m: [fn(o - r, r).item() for o, r in zip(outs, ref)] for m, fn in metrics.items()}

    err_p = errors(plain)

    def worst(outs):
        """The largest ratio of an error to 2x the plain path's, with its
        metric and tensor."""
        return max((e / max(2 * p, 1e-12), f"{m}, {n}") for m, errs in errors(outs).items()
                   for e, p, n in zip(errs, err_p[m], names))

    err_k, (ratio, _) = errors(got), worst(got)
    print(f"{label} reference ({kwargs.get('num_frames', 1)} frames at {kwargs['height']}x"
          f"{kwargs['width']}, the first controlled step's {len(ref) - 2} adapter outputs, UNet "
          f"output and CFG-combined noise prediction, errors relative to the fp32 tensor's):")
    for m in metrics:
        print(f"  {m}: bf16 kernel path {min(err_k[m]):.3e}..{max(err_k[m]):.3e}, bf16 plain "
              f"path {min(err_p[m]):.3e}..{max(err_p[m]):.3e}; UNet {err_k[m][-2]:.3e} against "
              f"{err_p[m][-2]:.3e}, noise {err_k[m][-1]:.3e} against {err_p[m][-1]:.3e}")
    print(f"  largest kernel error / (2 x plain) {ratio:.3f} (tolerance 1)")
    if not (all(torch.isfinite(o).all() for o in got) and ratio <= 1.0):
        raise RuntimeError(f"{label}: kernel path is farther from the fp32 reference than allowed")
    for fault, swap in faulty_kernels().items():
        if faults is not None and fault not in faults:
            continue
        with swap:
            bad, where = worst(step_outputs(pipe, kwargs, combine))
        print(f"  control, {fault}: largest error / (2 x plain) {bad:.3f} ({where}), "
              f"{'fails' if bad > 1.0 else 'PASSES'} the check")
        if bad <= 1.0:
            raise RuntimeError(f"{label}: the reference check passes a kernel path with {fault}")


def run_i2vgenxl(dev, card, kernels):
    """Phase 9: the I2VGen-XL control path at full width: the depth
    configuration (one ControlNet, I2V_STEPS DDIM steps, control window end
    0.8, then the decode in chunks of 2) and the multi-condition one
    (I2V_EXPERTS loaded, I2V_ACTIVE active by ``inference_expert_masks``, a
    simple-weights router, end 1.0); returns the launch counts of both runs."""
    from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
    from ctrl_adapter_tpu_torch.pipelines.common import control_window
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline

    bf = torch.bfloat16
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unet, nets, adapter, vae, router, n_params = build_i2vgenxl(dev, bf, I2V_EXPERTS)
    torch.cuda.synchronize()
    print(f"i2vgenxl: built the I2VGen-XL UNet, {I2V_EXPERTS} ControlNets, the adapter and the "
          f"2D VAE, {n_params / 1e9:.3f} B params bf16 (UNet "
          f"{sum(p.numel() for p in unet.parameters()) / 1e9:.3f} B), in "
          f"{time.perf_counter() - t0:.1f} s")
    depth = I2VGenXLControlNetAdapterPipeline(unet, nets[0], adapter, vae)
    inputs = i2v_inputs(dev, bf, 1, I2V_FRAMES, SIZE, SEED + 11)
    kw = dict(height=SIZE, width=SIZE, num_frames=I2V_FRAMES, guidance_scale=9.0,
              control_guidance_end=0.8, control_latent_size=SIZE // 8)

    # the depth configuration: the main path run, launches counted per step
    torch.cuda.reset_peak_memory_stats()
    with launches_per_step(depth, kernels) as steps:
        video, launches, t_first = drive(depth, inputs, kw, kernels, I2V_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"i2vgenxl depth: launches during the run {launches}")
    check_video(video, "i2vgenxl depth", I2V_FRAMES)
    lo, hi = control_window(I2V_STEPS, 0.0, 0.8)
    want = i2v_launches(hi - lo, I2V_STEPS - (hi - lo))
    if launches != want:
        raise RuntimeError(f"i2vgenxl depth: launches {launches}, want (JAX dispatch) {want}")
    check_steps("i2vgenxl depth", steps, I2V_STEPS)

    def steps_ms(end, n=I2V_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        latents = depth.generate(**inputs, **{**kw, "control_guidance_end": end},
                                 num_inference_steps=n, output_type="latent")
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t1) / n, latents

    per_kind = {"controlled": [], "UNet-only": []}
    for kind in ("controlled", "UNet-only", "UNet-only", "controlled"):  # in turns
        per_kind[kind].append(steps_ms(1.0 if kind == "controlled" else 0.0)[0])
    activity = {kind: device_activity(lambda end=end: steps_ms(end, 2))
                for kind, end in (("controlled", 1.0), ("UNet-only", 0.0))}
    towers = tower_ms({"ControlNet": depth.controlnet, "adapter": adapter, "UNet": unet},
                      lambda: steps_ms(1.0, 2))
    _, latents = steps_ms(0.8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    depth._decode(latents, 0.18215, 2)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t1
    print(f"i2vgenxl depth on {card}: 1x{I2V_FRAMES}x{SIZE}x{SIZE}, CFG 9.0, DDIM "
          f"{I2V_STEPS} steps ({hi - lo} in the control window):")
    print(f"  first generate() {t_first:.3f} s (denoise + decode, cold); peak device memory "
          f"{peak_gb:.2f} GiB")
    for kind, ms in per_kind.items():
        print(f"  {kind} step: {', '.join(f'{t:.1f}' for t in ms)} ms (host clock, "
              f"{I2V_STEPS}-step runs in turns)")
        print_activity("    profiled 2-step run: ", activity[kind], 2)
    print("  tower calls in a controlled step (CUDA events, median of 2): " + "; ".join(
        f"{name} {statistics.median(ts):.1f} ms" for name, ts in towers.items()))
    print(f"  decode {t_decode:.3f} s (second run; {I2V_FRAMES} frames in chunks of 2)")
    # 256x256 puts the UNet's level-0 attention at T = 1024, so K2 runs too
    small = dict(height=256, width=256, num_frames=4, num_inference_steps=2,
                 guidance_scale=9.0, control_latent_size=32, output_type="latent")
    step_reference_check(depth, "i2vgenxl depth", dict(
        i2v_inputs(dev, bf, 1, 4, 256, SEED + 12), **small, control_guidance_end=0.8))
    del depth, video, latents

    # the multi-condition configuration: only the active experts run, and
    # the router gives the masked ones weight 0
    multi = I2VGenXLControlNetAdapterPipeline(unet, MultiControlNetModel(nets), adapter, vae,
                                              router=router)
    masks = [True] * I2V_ACTIVE + [False] * (I2V_EXPERTS - I2V_ACTIVE)
    minputs = i2v_inputs(dev, bf, I2V_EXPERTS, I2V_FRAMES, SIZE, SEED + 13)
    mkw = dict(kw, control_guidance_end=1.0, inference_expert_masks=masks)
    calls = [0] * I2V_EXPERTS
    hooks = [net.register_forward_hook(lambda *_, e=e: calls.__setitem__(e, calls[e] + 1))
             for e, net in enumerate(nets)]
    for k in kernels.values():
        k.reset()
    with launches_per_step(multi, kernels) as msteps:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        video, trace_down, trace_mid = multi.generate(
            **minputs, **mkw, num_inference_steps=I2V_MULTI_STEPS, return_router_weights=True)
        torch.cuda.synchronize()
        t_multi = time.perf_counter() - t1
    launches_multi = {name: k.launches for name, k in kernels.items()}
    for h in hooks:
        h.remove()
    print(f"i2vgenxl multi: launches during the run {launches_multi}; ControlNet calls per "
          f"expert {calls}")
    check_video(video, "i2vgenxl multi", I2V_FRAMES)
    if calls != [I2V_MULTI_STEPS] * I2V_ACTIVE + [0] * (I2V_EXPERTS - I2V_ACTIVE):
        raise RuntimeError(f"i2vgenxl multi: ControlNet calls per expert {calls}: only the "
                           f"{I2V_ACTIVE} active experts may run, once a step")
    if launches_multi != i2v_launches(I2V_MULTI_STEPS, 0):
        raise RuntimeError(f"i2vgenxl multi: launches {launches_multi}, want "
                           f"{i2v_launches(I2V_MULTI_STEPS, 0)}")
    check_steps("i2vgenxl multi", msteps, I2V_MULTI_STEPS)
    off = range(I2V_ACTIVE, I2V_EXPERTS)
    masked = [row[e] for step in trace_down for row in step for e in off]
    masked += [step[e] for step in trace_mid for e in off]
    active_sum = [sum(row) for step in trace_down for row in step]
    print(f"i2vgenxl multi: router weights of the masked experts: max {max(masked)} over "
          f"{len(masked)}; each down row sums to {min(active_sum):.6f}..{max(active_sum):.6f}")
    if any(w != 0.0 for w in masked) or len(trace_down) != I2V_MULTI_STEPS:
        raise RuntimeError("i2vgenxl multi: a masked expert has a nonzero router weight")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    multi.generate(**minputs, **mkw, num_inference_steps=I2V_MULTI_STEPS, output_type="latent")
    torch.cuda.synchronize()
    multi_ms = 1000 * (time.perf_counter() - t1) / I2V_MULTI_STEPS
    print(f"i2vgenxl multi on {card}: {I2V_ACTIVE} of {I2V_EXPERTS} experts, "
          f"{I2V_MULTI_STEPS} steps, first generate() {t_multi:.3f} s (denoise + decode, "
          f"cold); controlled step {multi_ms:.1f} ms (host clock, second run)")
    step_reference_check(multi, "i2vgenxl multi", dict(
        i2v_inputs(dev, bf, I2V_EXPERTS, 4, 256, SEED + 12), **small, control_guidance_end=1.0,
        inference_expert_masks=masks))
    del multi, unet, nets, adapter, vae, router
    torch.cuda.empty_cache()
    return launches, launches_multi


def build_sdxl(dev, dtype):
    """The SDXL towers at the full width of the JAX bench's ``sdxl_depth``
    (``bench.py:426-490``): the SDXL UNet (``SDXL_CONFIG``: 320/640/1280, 1/2/10
    transformer layers, cross 2048), the SD-v1.5 ControlNet, the adapter
    (backbone "sdxl", cross 2048, one block at each of A-C's 3 slots, spatial
    ResNet and transformer) and the SDXL VAE, in ``dtype``, with weights drawn
    on the card from a seeded generator at scale 0.02."""
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG, UNet2DConditionModel
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    kw = dict(device=dev, dtype=dtype)
    unet = UNet2DConditionModel(SDXL_CONFIG, **kw)
    cnet = ControlNetModel(**kw)
    adapter = ControlNetAdapter(backbone_model_name="sdxl", cross_attention_dim=2048,
                                num_blocks=1, adapter_locations=("A", "B", "C"), **kw)
    vae = AutoencoderKL(VAEConfig(scaling_factor=0.13025), **kw)
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    n_params = 0
    with torch.no_grad():
        for module in (unet, cnet, adapter, vae):
            module.eval()
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
                n_params += p.numel()
    return unet, cnet, adapter, vae, n_params


def sdxl_inputs(dev, dtype, size, control, seed):
    """Prompt (2, 77, 2048), pooled text (2, 1280), ControlNet prompt (2, 77,
    768), a control image of 8 x ``control`` square in [0, 1] and the initial
    latents, from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale: (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)  # noqa: E731
    return dict(prompt_embeds=r(2, 77, 2048, scale=0.02), add_text_embeds=r(2, 1280, scale=0.02),
                controlnet_prompt_embeds=r(2, 77, 768, scale=0.02),
                control_image=torch.rand(1, 8 * control, 8 * control, 3, generator=g,
                                         device=dev).to(dtype),
                latents=torch.randn(1, size // 8, size // 8, 4, generator=g, device=dev))


def run_sdxl(dev, card, kernels):
    """Phase 10: the SDXL control path at the full width of ``bench_sdxl``:
    batch 1 at 1024x1024, CFG 7.5, SDXL_STEPS Euler steps with the control
    window ending at 0.6, then the decode; returns the launch counts."""
    from ctrl_adapter_tpu_torch.pipelines.common import (classifier_free_guidance_rescaled,
                                                         control_window)
    from ctrl_adapter_tpu_torch.pipelines.sdxl import SDXLControlNetAdapterPipeline

    bf = torch.bfloat16
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unet, cnet, adapter, vae, n_params = build_sdxl(dev, bf)
    torch.cuda.synchronize()
    print(f"sdxl: built the SDXL UNet, the SD-v1.5 ControlNet, the adapter and the SDXL VAE, "
          f"{n_params / 1e9:.3f} B params bf16 (UNet "
          f"{sum(p.numel() for p in unet.parameters()) / 1e9:.3f} B), in "
          f"{time.perf_counter() - t0:.1f} s")
    pipe = SDXLControlNetAdapterPipeline(unet, cnet, adapter, vae)
    inputs = sdxl_inputs(dev, bf, SDXL_SIZE, SDXL_CONTROL, SEED + 16)
    kw = dict(height=SDXL_SIZE, width=SDXL_SIZE, guidance_scale=7.5, control_guidance_end=0.6,
              control_latent_size=SDXL_CONTROL)

    torch.cuda.reset_peak_memory_stats()
    with launches_per_step(pipe, kernels) as steps:
        image, launches, t_first = drive(pipe, inputs, kw, kernels, SDXL_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"sdxl: launches during the run {launches}")
    if tuple(image.shape) != (1, SDXL_SIZE, SDXL_SIZE, 3):
        raise RuntimeError(f"sdxl: image shape {tuple(image.shape)}")
    im = image.float()
    if not torch.isfinite(im).all() or im.min().item() < 0.0 or im.max().item() > 1.0:
        raise RuntimeError("sdxl: image not finite or outside [0, 1]")
    print(f"sdxl: image {tuple(image.shape)} finite, range [{im.min().item():.4f}, "
          f"{im.max().item():.4f}], std {im.std().item():.4f}")
    lo, hi = control_window(SDXL_STEPS, 0.0, 0.6)
    want = sdxl_launches(hi - lo, SDXL_STEPS - (hi - lo))
    if launches != want:
        raise RuntimeError(f"sdxl: launches {launches}, want (JAX dispatch) {want}")
    check_steps("sdxl", steps, SDXL_STEPS, sdxl_launches)

    def steps_ms(end, n=SDXL_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        latents = pipe.generate(**inputs, **{**kw, "control_guidance_end": end},
                                num_inference_steps=n, output_type="latent")
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t1) / n, latents

    per_kind = {"controlled": [], "UNet-only": []}
    for kind in ("controlled", "UNet-only", "UNet-only", "controlled"):  # in turns
        per_kind[kind].append(steps_ms(1.0 if kind == "controlled" else 0.0)[0])
    activity = {kind: device_activity(lambda end=end: steps_ms(end, 2))
                for kind, end in (("controlled", 1.0), ("UNet-only", 0.0))}
    towers = tower_ms({"ControlNet": cnet, "adapter": adapter, "UNet": unet},
                      lambda: steps_ms(1.0, 2))
    _, latents = steps_ms(0.6)
    decode_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe._decode(latents, 0.13025)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t1)
    print(f"sdxl on {card}: 1x{SDXL_SIZE}x{SDXL_SIZE}, CFG 7.5, Euler {SDXL_STEPS} steps "
          f"({hi - lo} in the control window):")
    print(f"  first generate() {t_first:.3f} s (denoise + decode, cold); peak device memory "
          f"{peak_gb:.2f} GiB")
    for kind, ms in per_kind.items():
        print(f"  {kind} step: {', '.join(f'{t:.1f}' for t in ms)} ms (host clock, "
              f"{SDXL_STEPS}-step runs in turns)")
        print_activity("    profiled 2-step run: ", activity[kind], 2)
    print("  tower calls in a controlled step (CUDA events, median of 2): " + "; ".join(
        f"{name} {statistics.median(ts):.1f} ms" for name, ts in towers.items()))
    print(f"  decode {decode_s[1]:.3f} s (second run; first {decode_s[0]:.3f} s)")
    # 512x512: the UNet's level-1 attention at T = 1024, the adapter's A blocks
    # at T = 4096, so K2 runs in both towers; K1 in the adapter
    small = dict(height=512, width=512, num_inference_steps=2, guidance_scale=7.5,
                 guidance_rescale=0.7, control_latent_size=32, control_guidance_end=1.0,
                 output_type="latent")
    step_reference_check(
        pipe, "sdxl", dict(sdxl_inputs(dev, bf, 512, 32, SEED + 17), **small),
        combine=lambda out: classifier_free_guidance_rescaled(out, 7.5, 0.7),
        faults=("K1 without its SiLU", "K2 without head 0"))
    del pipe, unet, cnet, adapter, vae, image, latents
    torch.cuda.empty_cache()
    return launches


BRANCH_STEPS = 3      # training steps of the I2VGen-XL depth and SDXL runs
BRANCH_MULTI_STEPS = 2  # of the multi-condition run
MAX_ACTIVE = 4         # max_num_multi_source_train (configs/i2vgenxl_train_multi_condition.yaml)


def branch_batch(dev, model, experts, frames, size, control, seed, mask=None):
    """One training batch of ``model`` ("i2vgenxl" or "sdxl") from a seeded
    generator, in the JAX layouts: frames in [-1, 1] (one for SDXL), one
    depth-like condition per expert at 8 x ``control`` square, the ControlNet
    text, and I2VGen-XL's CLIP image embedding and prompt (1024 wide) or
    SDXL's prompt (2048 wide), pooled text and time ids; ``mask`` the
    expert mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    c8 = 8 * control
    depth = torch.rand(experts, frames, c8, c8, 1, generator=g, device=dev)
    batch = {"frames": torch.rand(1, frames, size, size, 3, generator=g, device=dev) * 2 - 1,
             "controlnet_cond": depth.expand(-1, -1, -1, -1, 3).contiguous(),
             "controlnet_text_emb": r(1, 77, 768, scale=0.02)}
    if model == "i2vgenxl":
        batch.update(image_embeddings=r(1, 1, 1024, scale=0.1),
                     prompt_embeds=r(1, 77, 1024, scale=0.02))
    else:
        batch.update(prompt_embeds=r(1, 77, 2048, scale=0.02),
                     pooled_prompt_embeds=r(1, 1280, scale=0.02),
                     additional_time_ids=torch.tensor([[size, size, 0, 0, size, size]],
                                                      dtype=torch.float32, device=dev))
    if mask is not None:
        batch["expert_mask"] = torch.tensor(mask, dtype=torch.float32, device=dev)
    return batch


def draw_mask(g, experts, max_active=MAX_ACTIVE):
    """An expert mask with 1 to ``max_active`` active experts, drawn from the
    host generator ``g`` as train.py draws it per batch."""
    k = int(torch.randint(1, max_active + 1, (1,), generator=g))
    on = torch.randperm(experts, generator=g)[:k].tolist()
    return [float(e in on) for e in range(experts)]


def run_branch(label, trainer, batches, kernels, want, single_key=True, gen=None):
    """``len(batches)`` training steps of ``trainer`` with draws from
    ``gen``: their losses, gradient norms, ms and launches against ``want``
    (one step's, from the helpers); after the first step every adapter tensor
    the forward reads has a nonzero gradient. Returns (ms per step, metrics
    per step, peak GiB)."""
    gen = gen or torch.Generator(device=trainer.device).manual_seed(SEED + 20)
    torch.cuda.reset_peak_memory_stats()
    step_ms, steps = [], []
    for i, batch in enumerate(batches):
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        step_ms.append(1000 * (time.perf_counter() - t1))
        launches = {name: k.launches - before[name] for name, k in kernels.items()}
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        print(f"{label} step {i + 1}: loss {loss:.6f}, grad_norm {norm:.6e}, "
              f"{step_ms[-1]:.1f} ms, launches {launches}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise RuntimeError(f"{label} step {i + 1}: non-finite loss or grad_norm")
        if launches != want:
            raise RuntimeError(f"{label} step {i + 1}: launches {launches}, want (the JAX "
                               f"dispatch, forward and recompute) {want}")
        if i == 0:
            check_read_grads(label, trainer, single_key)
        steps.append(metrics)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: launches per step as the helpers give them "
          f"{ {k: v for k, v in want.items() if v} }")
    return step_ms, steps, peak_gb


def print_branch(label, card, shape, step_ms, peak_gb, parts=None, activity=None):
    print(f"{label} on {card}: {shape}, bf16 towers, fp32 masters, gradient checkpointing: "
          f"step 1 {step_ms[0]:.1f} ms (cold); {statistics.mean(step_ms[1:]):.1f} ms/step over "
          f"steps 2-{len(step_ms)} ({', '.join(f'{t:.1f}' for t in step_ms[1:])}); peak device "
          f"memory {peak_gb:.2f} GiB")
    if parts is not None:
        print(f"  a step in parts: " + "; ".join(f"{k} {1000 * v:.1f} ms"
                                                  for k, v in parts.items()))
    if activity is not None or parts is not None:
        print_activity("  a step under torch.profiler: ", activity)


def masters_moved(label, masters, start, what="master"):
    moved = sum(not torch.equal(a, b) for a, b in zip(start, masters))
    print(f"{label}: {moved} of {len(masters)} {what} tensors moved")
    if moved != len(masters):
        raise RuntimeError(f"{label}: some {what} tensors did not move")


def run_train_branches(dev, card, kernels):
    """Phase 11: the I2VGen-XL and SDXL training branches and router training
    at full width (bf16 towers from a seeded generator, fp32 masters,
    gradient checkpointing): I2VGen-XL depth (``configs/i2vgenxl_train_depth.yaml``,
    1 x 16 x 512^2, one ControlNet, 3 steps), I2VGen-XL multi-condition
    (``configs/i2vgenxl_train_multi_condition.yaml``: 7 ControlNets, a
    simple-weights router, 1-4 active experts drawn per step, 2 steps, a
    checkpoint round trip), SDXL depth (``configs/sdxl_train_depth.yaml``,
    1 x 1024^2, min-SNR gamma 5, 3 steps); launches per step against
    ``i2v_train_launches`` / ``sdxl_train_launches``; the small-input checks
    against an fp32 run of the plain path with faulty kernels as controls.
    Returns the launch counts of the three runs."""
    from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig

    bf = torch.bfloat16
    counts = {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unet, nets, adapter, vae, router, n_params = build_i2vgenxl(dev, bf, I2V_EXPERTS)
    torch.cuda.synchronize()
    print(f"i2vgenxl training: built the I2VGen-XL UNet, {I2V_EXPERTS} ControlNets, the adapter "
          f"({sum(p.numel() for p in adapter.parameters()) / 1e6:.1f} M, fp32 masters) and the "
          f"2D VAE, {n_params / 1e9:.3f} B params bf16, in {time.perf_counter() - t0:.1f} s")
    lat = SIZE // 8
    cfg = TrainConfig(model_name="i2vgenxl", n_sample_frames=I2V_FRAMES, output_fps=16,
                      control_latent_size=lat, gradient_checkpointing=True)
    want = i2v_train_launches()

    # I2VGen-XL depth: one ControlNet, no router
    label = "i2vgenxl depth training"
    trainer = CtrlAdapterTrainer(cfg, unet, nets[0], adapter, vae, device=dev)
    start = [m.clone() for m in trainer.optimizer.masters]
    batch = branch_batch(dev, "i2vgenxl", 1, I2V_FRAMES, SIZE, lat, SEED + 21)
    for k in kernels.values():
        k.reset()
    step_ms, _, peak_gb = run_branch(label, trainer, [batch] * BRANCH_STEPS, kernels, want)
    counts["train_i2vgenxl"] = {name: k.launches for name, k in kernels.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    parts = step_parts(trainer, batch, trainer.draw(gen, 1, I2V_FRAMES, lat, lat))
    activity = device_activity(lambda: trainer.train_step(batch, generator=gen))
    masters_moved(label, trainer.optimizer.masters, start)
    print_branch(label, card, f"1x{I2V_FRAMES}x{SIZE}x{SIZE}", step_ms, peak_gb, parts, activity)
    del trainer, start, batch
    torch.cuda.empty_cache()

    # I2VGen-XL multi-condition: 7 ControlNets, all run every step as in the
    # JAX loop, a simple-weights router in the adapter's optimizer
    label = "i2vgenxl multi-condition training"
    mcfg = dataclasses.replace(cfg, num_experts=I2V_EXPERTS, train_router=True)
    trainer = CtrlAdapterTrainer(mcfg, unet, MultiControlNetModel(nets), adapter, vae,
                                 router=router, device=dev)
    n = len(trainer.names)
    start = [m.clone() for m in trainer.optimizer.masters[n:]]
    host = torch.Generator().manual_seed(SEED + 23)
    masks = [draw_mask(host, I2V_EXPERTS) for _ in range(BRANCH_MULTI_STEPS)]
    calls = [0] * I2V_EXPERTS
    hooks = [net.register_forward_hook(lambda *_, e=e: calls.__setitem__(e, calls[e] + 1))
             for e, net in enumerate(nets)]
    for k in kernels.values():
        k.reset()
    batches = [branch_batch(dev, "i2vgenxl", I2V_EXPERTS, I2V_FRAMES, SIZE, lat, SEED + 24 + i,
                            mask) for i, mask in enumerate(masks)]
    seen, peaks, step_ms, steps = [], [], [], []
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    try:
        for i, (batch, mask) in enumerate(zip(batches, masks)):
            ms, metrics, peak = run_branch(f"{label} (mask {mask})", trainer, [batch], kernels,
                                           want, gen=gen)
            step_ms, steps, peaks = step_ms + ms, steps + metrics, peaks + [peak]
            off = [e for e in range(I2V_EXPERTS) if not mask[e]]
            grads = [p.grad for p in trainer.optimizer.params[n:]]
            dw, mw = metrics[0]["down_block_weights"], metrics[0]["mid_block_weights"]
            zero_w = bool((dw[:, off] == 0).all() and (mw[off] == 0).all())
            zero_g = all(g is not None and bool((g[off] == 0).all()) for g in grads)
            rows = dw.sum(-1)
            active = torch.linalg.vector_norm(torch.cat([g.flatten() for g in grads])).item()
            print(f"{label} step {i + 1}: {len(off)} masked experts {off}: router weights "
                  f"{'exactly 0' if zero_w else 'NONZERO'}, router gradients "
                  f"{'exactly 0' if zero_g else 'NONZERO'}; each down row sums to "
                  f"{rows.min().item():.6f}..{rows.max().item():.6f}; the router gradient's "
                  f"norm {active:.3e}")
            seen.append((zero_w, zero_g))
    finally:
        for h in hooks:
            h.remove()
    peak_gb = max(peaks)
    counts["train_i2vgenxl_multi"] = {name: k.launches for name, k in kernels.items()}
    print(f"{label}: ControlNet calls per expert {calls} (forward only: none is checkpointed)")
    if calls != [BRANCH_MULTI_STEPS] * I2V_EXPERTS:
        raise RuntimeError(f"{label}: ControlNet calls per expert {calls}: all "
                           f"{I2V_EXPERTS} run once a step, as in the JAX loop")
    if not all(w and g for w, g in seen):
        raise RuntimeError(f"{label}: a masked expert has a nonzero router weight or gradient")
    if any({"down_block_weights", "mid_block_weights"} - set(m) for m in steps):
        raise RuntimeError(f"{label}: the router's weights are missing from the step's metrics")
    masters_moved(label, trainer.optimizer.masters[n:], start, "router master")
    print_branch(label, card, f"1x{I2V_FRAMES}x{SIZE}x{SIZE}, {I2V_EXPERTS} ControlNets",
                 step_ms, peak_gb)
    # (no checkpoint round trip here: phase 14 holds the format's, masters and
    # AdamW state; phase 15 (4) reads the router's checkpoint back)
    # 4 frames at 256x256: the adapter's A blocks and the UNet's level 0 at
    # T = 1024, so K2 runs forward and backward; 3 experts active
    small_mask = [1.0, 1.0, 0.0, 1.0] + [0.0] * (I2V_EXPERTS - 4)
    train_reference_check(
        trainer, dev, "i2vgenxl multi-condition",
        branch_batch(dev, "i2vgenxl", I2V_EXPERTS, 4, 256, 32, SEED + 25, small_mask),
        trainer.draw(torch.Generator(device=dev).manual_seed(SEED + 26), 1, 4, 32, 32),
        dataclasses.replace(mcfg, n_sample_frames=4, control_latent_size=32),
        faults=tuple(training_faults()))
    del trainer, unet, nets, adapter, vae, router, batches, start
    torch.cuda.empty_cache()

    # SDXL depth with min-SNR
    label = "sdxl training"
    t0 = time.perf_counter()
    unet, cnet, adapter, vae, n_params = build_sdxl(dev, bf)
    torch.cuda.synchronize()
    print(f"sdxl training: built the SDXL UNet, the SD-v1.5 ControlNet, the adapter "
          f"({sum(p.numel() for p in adapter.parameters()) / 1e6:.1f} M, fp32 masters) and the "
          f"SDXL VAE, {n_params / 1e9:.3f} B params bf16, in {time.perf_counter() - t0:.1f} s")
    scfg = TrainConfig(model_name="sdxl", n_sample_frames=1, output_fps=1,
                       control_latent_size=SDXL_CONTROL, snr_gamma=5.0,
                       vae_scaling_factor=0.13025, gradient_checkpointing=True)
    trainer = CtrlAdapterTrainer(scfg, unet, cnet, adapter, vae, device=dev)
    start = [m.clone() for m in trainer.optimizer.masters]
    batch = branch_batch(dev, "sdxl", 1, 1, SDXL_SIZE, SDXL_CONTROL, SEED + 27)
    for k in kernels.values():
        k.reset()
    step_ms, _, peak_gb = run_branch(label, trainer, [batch] * BRANCH_STEPS, kernels,
                                     sdxl_train_launches(), single_key=False)
    counts["train_sdxl"] = {name: k.launches for name, k in kernels.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    lat = SDXL_SIZE // 8
    parts = step_parts(trainer, batch, trainer.draw(gen, 1, 1, lat, lat))
    activity = device_activity(lambda: trainer.train_step(batch, generator=gen))
    masters_moved(label, trainer.optimizer.masters, start)
    print_branch(label, card, f"1x{SDXL_SIZE}x{SDXL_SIZE}, min-SNR 5", step_ms, peak_gb, parts,
                 activity)
    # 512x512: the adapter's A blocks at T = 4096 after the x2 upsample, the
    # UNet's level 1 at T = 1024
    train_reference_check(
        trainer, dev, "sdxl", branch_batch(dev, "sdxl", 1, 1, 512, 32, SEED + 29),
        trainer.draw(torch.Generator(device=dev).manual_seed(SEED + 30), 1, 1, 64, 64),
        dataclasses.replace(scfg, control_latent_size=32),
        faults=("K1 without its SiLU", "K2 backward without head 0"))
    del trainer, unet, cnet, adapter, vae, start, batch
    torch.cuda.empty_cache()
    return counts


def run_exact_gelu(dev, card, full_kernel, k4_kernel):
    """Phase 6: the JAX package's ``CTRL_ADAPTER_EXACT_GELU=1`` switch. A UNet
    level-0 temporal block (bf16, c = 320, 5 heads, 14 frames) still takes
    K3 full, whose FFs now use erf gelu: one launch, against the plain path
    under the same switch at K3 full's tolerance. A 320-wide spatial
    transformer block on 4,096 rows under ``CTRL_ADAPTER_FUSED_BLOCK=1``
    launches K4 once, and not at all with the switch: the JAX rule runs its
    kernel for tanh-gelu only."""
    from ctrl_adapter_tpu_torch.nn.attention import (BasicTransformerBlock,
                                                     TemporalBasicTransformerBlock)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731

    def init(module, scale=0.05):
        for p in module.parameters():
            p.copy_(rand(*p.shape, scale=scale))
        return module.eval()

    def run_block(block, x, ctx, approximate, kernel):
        """The block under the switch unless ``approximate``, through its
        kernels or (not ``kernel``) their plain versions."""
        with contextlib.ExitStack() as stack:
            if not approximate:
                stack.enter_context(env_switch("CTRL_ADAPTER_EXACT_GELU"))
            if not kernel:
                stack.enter_context(plain_kernels())
            return block(x, FRAMES, ctx)

    with torch.no_grad():
        block = init(TemporalBasicTransformerBlock(320, 320, 5, 64, 1024, device=dev, dtype=bf))
        x, ctx = rand(2 * FRAMES, 256, 320).to(bf), rand(2 * 256, 1, 1024).to(bf)
        full_kernel.reset()
        got = run_block(block, x, ctx, False, True)
        torch.cuda.synchronize()
        launches = full_kernel.launches
        want = run_block(block, x, ctx, False, False)
        print(f"exact gelu on {card}: temporal block (2,14,256,320) under "
              f"CTRL_ADAPTER_EXACT_GELU=1: K3 full launches {launches}")
        if launches != 1:
            raise RuntimeError("the level-0 temporal block did not take K3 full under the switch")
        compare("temporal block, erf gelu, K3 full vs plain", got, want, atol=1e-1, rtol=2e-2)
        # the same block with weights under which the forms differ by far more
        # than the rounding (gelu_form_ff), on a residual stream of ~1e-2: the
        # switch must reach K3 full's FFs
        init(block, 2e-3)
        for norm in (block.norm_in, block.norm1, block.norm2, block.norm3):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        for feed_forward in (block.ff_in, block.ff):
            _, _, wg, bg, w2, b2 = gelu_form_ff(rand, 320, 1280, 320)
            for p, v in zip((feed_forward.net[0].proj.weight, feed_forward.net[0].proj.bias,
                             feed_forward.net[2].weight, feed_forward.net[2].bias),
                            (wg, bg, w2, b2)):
                p.copy_(v)
        xf = rand(2 * FRAMES, 256, 320, scale=1e-2).to(bf)
        gelu_form_check("temporal block (2,14,256,320) with and without the switch",
                        lambda a, k: run_block(block, xf, ctx, a, k))

        spatial = init(BasicTransformerBlock(320, 5, 64, 1024, device=dev, dtype=bf))
        xs, ctx = rand(1, 4096, 320).to(bf), rand(1, 77, 1024).to(bf)
        counts = {}
        with env_switch("CTRL_ADAPTER_FUSED_BLOCK"):
            for exact in (False, True):
                k4_kernel.reset()
                with env_switch("CTRL_ADAPTER_EXACT_GELU") if exact else contextlib.nullcontext():
                    out = spatial(xs, ctx)
                torch.cuda.synchronize()
                if not torch.isfinite(out.float()).all():
                    raise RuntimeError("spatial block: non-finite output")
                counts[exact] = k4_kernel.launches
    print(f"exact gelu: spatial block (1,4096,320) under CTRL_ADAPTER_FUSED_BLOCK=1: K4 launches "
          f"{counts[False]} without CTRL_ADAPTER_EXACT_GELU=1, {counts[True]} with it")
    if counts != {False: 1, True: 0}:
        raise RuntimeError(f"K4 launches {counts}: want 1 without the exact-gelu switch, 0 with it")


def run_feed_forward(dev, card, kernel):
    """Phase 7: K5 sits on no model path (no model builds ``FeedForward`` on its
    own); drive it through the port's ``FeedForward`` at the level-0 shape."""
    from ctrl_adapter_tpu_torch.nn.attention import FeedForward

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        module = FeedForward(320, 320, device=dev, dtype=bf)
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
        x = torch.randn(28, 4096, 320, generator=g, device=dev).to(bf)
        want = module(x)
        kernel.reset()
        with env_switch("CTRL_ADAPTER_FUSED_FF"):
            got = module(x)
        torch.cuda.synchronize()
        launches = kernel.launches
    print(f"FeedForward (28,4096,320) under CTRL_ADAPTER_FUSED_FF=1 on {card}: K5 launches "
          f"{launches}")
    if launches != 1:
        raise RuntimeError("FeedForward under CTRL_ADAPTER_FUSED_FF=1 did not launch K5")
    compare("FeedForward with K5 vs plain", got, want, atol=3e-2, rtol=2e-2)
    return launches


# ------------------------------------------------------- phase 13, the CLI
CLI_PROMPT = "a red sports car drives along a coastal road at sunset"
CLI_STEPS = 4
PREPROCESSOR = {  # feature_extractor/preprocessor_config.json of the SVD release
    "crop_size": {"height": 224, "width": 224}, "do_center_crop": True,
    "do_convert_rgb": True, "do_normalize": True, "do_rescale": True, "do_resize": True,
    "image_mean": [0.48145466, 0.4578275, 0.40821073],
    "image_std": [0.26862954, 0.26130258, 0.27577711], "resample": 3,
    "rescale_factor": 0.00392156862745098, "size": {"shortest_edge": 224},
}


def smooth_frames(rng, n, size, channels=3):
    """``n`` uint8 frames (size, size, channels) of smooth fields that drift from
    frame to frame: per channel a sum of four random plane waves."""
    import numpy as np

    yy, xx = (a.astype(np.float32) / size for a in np.mgrid[0:size, 0:size])
    waves = rng.uniform(-1.0, 1.0, (channels, 4, 5))  # fy, fx, ft, phase, amplitude
    frames = []
    for t in range(n):
        img = np.stack([sum(a * np.sin(2 * np.pi * (3 * fy * yy + 3 * fx * xx + 0.05 * ft * t)
                                       + 3 * ph) for fy, fx, ft, ph, a in waves[c])
                        for c in range(channels)], axis=-1)
        frames.append(np.clip(127.5 + 60.0 * img, 0, 255).astype(np.uint8))
    return frames


def write_cli_fixture(root, frames, size, control_types, seed, sample="s0",
                      prompt=CLI_PROMPT):
    """The reference's evaluation layout under ``root``: ``raw_input/{sample}/000.png``
    ..., one folder of gray condition frames per control type, ``captions.json``."""
    import numpy as np
    from ctrl_adapter_tpu_torch.utils.image import save_png

    rng = np.random.default_rng(seed)
    for i, fr in enumerate(smooth_frames(rng, frames, size)):
        save_png(fr, os.path.join(root, "raw_input", sample, f"{i:03d}.png"))
    for ctype in control_types:
        for i, fr in enumerate(smooth_frames(rng, frames, size, channels=1)):
            save_png(np.repeat(fr, 3, axis=2), os.path.join(root, ctype, sample, f"{i:03d}.png"))
    with open(os.path.join(root, "captions.json"), "w") as fh:
        json.dump({f"{sample}.mp4": prompt}, fh)
    return root


def write_tokenizer(path, pad_token="<|endoftext|>", words=None):
    """A small CLIP BPE tokenizer folder: the 512 byte tokens, merges that make
    each of ``words`` (default: those of ``CLI_PROMPT``) one token, the two
    specials; ``pad_token`` in special_tokens_map.json."""
    from ctrl_adapter_tpu_torch.models.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    merges = []
    for word in words or CLI_PROMPT.split():
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        while len(pieces) > 1:
            if (pieces[0], pieces[1]) not in merges:
                merges.append((pieces[0], pieces[1]))
            pieces = [pieces[0] + pieces[1]] + pieces[2:]
    vocab = chars + [c + "</w>" for c in chars] + [a + b for a, b in merges]
    vocab = list(dict.fromkeys(vocab)) + ["<|startoftext|>", "<|endoftext|>"]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump({t: i for i, t in enumerate(vocab)}, fh)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"model_max_length": 77, "tokenizer_class": "CLIPTokenizer"}, fh)
    with open(os.path.join(path, "special_tokens_map.json"), "w") as fh:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "pad_token": pad_token}, fh)
    return len(vocab)


@torch.no_grad()
def random_fill(module, seed, scale=0.02):
    """Every parameter of ``module`` drawn from a seeded generator on its device."""
    params = list(module.parameters())
    g = torch.Generator(device=params[0].device).manual_seed(seed)
    for p in params:
        p.copy_(torch.randn(p.shape, generator=g, device=p.device) * scale)
    return module


def write_tower(path, module, config, dtype):
    """A transformers folder: ``model.safetensors`` in ``dtype`` + ``config.json``."""
    from ctrl_adapter_tpu_torch.convert.release import write_safetensors

    os.makedirs(path, exist_ok=True)
    write_safetensors({k: v.to(dtype) for k, v in module.state_dict().items()},
                      os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)


def write_text_encoder(root, cfg, seed, dtype, device, subfolder="text_encoder",
                       tokenizer="tokenizer", pad_token="<|endoftext|>"):
    """A fabricated CLIP text tower of ``cfg`` (``models/clip.py:CLIPTextConfig``)
    and its tokenizer folder under ``root``; returns the tower."""
    from ctrl_adapter_tpu_torch.models.clip import CLIPTextModel

    write_tokenizer(os.path.join(root, tokenizer), pad_token)
    tower = random_fill(CLIPTextModel(cfg, device=device), seed)
    config = {"model_type": "clip_text_model", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
              "max_position_embeddings": cfg.max_position_embeddings,
              "hidden_act": cfg.hidden_act, "layer_norm_eps": cfg.layer_norm_eps,
              "eos_token_id": cfg.eos_token_id}
    if cfg.projection_dim is not None:
        config["projection_dim"] = cfg.projection_dim
    write_tower(os.path.join(root, subfolder), tower, config, dtype)
    return tower


def write_image_encoder(root, cfg, seed, dtype, device):
    """A fabricated CLIP vision tower of ``cfg`` under ``root``/image_encoder, and
    ``feature_extractor/preprocessor_config.json``; returns the tower."""
    from ctrl_adapter_tpu_torch.models.clip import CLIPVisionModel

    tower = random_fill(CLIPVisionModel(cfg, device=device), seed)
    config = {"model_type": "clip_vision_model", "image_size": cfg.image_size,
              "patch_size": cfg.patch_size, "hidden_size": cfg.hidden_size,
              "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
              "intermediate_size": cfg.intermediate_size, "hidden_act": cfg.hidden_act,
              "layer_norm_eps": cfg.layer_norm_eps, "projection_dim": cfg.projection_dim}
    write_tower(os.path.join(root, "image_encoder"), tower, config, dtype)
    os.makedirs(os.path.join(root, "feature_extractor"), exist_ok=True)
    with open(os.path.join(root, "feature_extractor", "preprocessor_config.json"), "w") as fh:
        json.dump(PREPROCESSOR, fh, indent=2)
    return tower


# ------------------------------------- phase 15, condition extraction and data
# preprocessor_config.json of the two transformers checkpoints the extractors
# default to (Intel/dpt-large, nvidia/segformer-b5-finetuned-ade-640-640)
DPT_PREPROCESSOR = {"do_normalize": True, "do_resize": True, "do_rescale": True,
                    "feature_extractor_type": "DPTFeatureExtractor", "image_mean": [0.5] * 3,
                    "image_std": [0.5] * 3, "keep_aspect_ratio": False, "ensure_multiple_of": 1,
                    "resample": 3, "rescale_factor": 1 / 255, "size": 384}
SEGFORMER_PREPROCESSOR = {"do_normalize": True, "do_resize": True,
                          "feature_extractor_type": "SegformerFeatureExtractor",
                          "image_mean": [0.485, 0.456, 0.406],
                          "image_std": [0.229, 0.224, 0.225], "reduce_labels": True,
                          "resample": 2, "size": 640}


@torch.no_grad()
def seeded_fill(module, seed, scale=0.02):
    """Every parameter of ``module`` (and a BatchNorm's running statistics)
    drawn from a generator of ``seed`` on its device: a norm's weight
    1 + scale * N(0, 1), a running variance 1 + |N(0, 1)| / 2, the rest
    scale * N(0, 1)."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    norms = (torch.nn.LayerNorm, torch.nn.GroupNorm, torch.nn.BatchNorm2d)
    for mod in module.modules():
        tensors = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, torch.nn.BatchNorm2d):
            tensors.update(running_mean=mod.running_mean, running_var=mod.running_var)
        for name, t in tensors.items():
            draw = torch.randn(t.shape, generator=g, device=dev)
            if name == "running_var":
                t.copy_(1 + 0.5 * draw.abs())
            elif name == "weight" and isinstance(mod, norms):
                t.copy_(1 + scale * draw)
            else:
                t.copy_(scale * draw)
    return module


def _write_transformers_folder(root, module, config, preprocessor):
    from ctrl_adapter_tpu_torch.convert.release import write_safetensors

    os.makedirs(root, exist_ok=True)
    write_safetensors({k: v.float().cpu() for k, v in module.state_dict().items()},
                      os.path.join(root, "model.safetensors"))
    for name, value in (("config.json", config), ("preprocessor_config.json", preprocessor)):
        with open(os.path.join(root, name), "w") as fh:
            json.dump(value, fh, indent=2)


def write_dpt(root, cfg, seed, device, scale=0.02, preprocessor=None):
    """A transformers ``DPTForDepthEstimation`` folder of ``cfg``
    (``conditions/dpt.py:DPTConfig``), seeded (``seeded_fill``), the head's
    last bias 1; returns the module."""
    from ctrl_adapter_tpu_torch.conditions.dpt import DPTForDepthEstimation

    model = seeded_fill(DPTForDepthEstimation(cfg, device=device), seed, scale)
    with torch.no_grad():  # the depth above the final relu's zero, as a trained head's
        model.head.head[4].bias.fill_(1.0)
    config = {"model_type": "dpt", "is_hybrid": False, "readout_type": "project",
              "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
              "patch_size": cfg.patch_size, "image_size": cfg.image_size,
              "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu", "qkv_bias": True,
              "backbone_out_indices": list(cfg.backbone_out_indices),
              "neck_hidden_sizes": list(cfg.neck_hidden_sizes),
              "reassemble_factors": list(cfg.reassemble_factors),
              "fusion_hidden_size": cfg.fusion_hidden_size}
    _write_transformers_folder(root, model, config, preprocessor or DPT_PREPROCESSOR)
    return model


def write_segformer(root, cfg, seed, device, scale=0.02, preprocessor=None):
    """A transformers ``SegformerForSemanticSegmentation`` folder of ``cfg``,
    seeded; returns the module."""
    from ctrl_adapter_tpu_torch.conditions.segformer import SegformerForSemanticSegmentation

    model = seeded_fill(SegformerForSemanticSegmentation(cfg, device=device), seed, scale)
    config = {"model_type": "segformer", "num_labels": cfg.num_labels,
              "id2label": {str(i): f"class_{i}" for i in range(cfg.num_labels)},
              "hidden_sizes": list(cfg.hidden_sizes), "depths": list(cfg.depths),
              "num_attention_heads": list(cfg.num_heads), "sr_ratios": list(cfg.sr_ratios),
              "patch_sizes": list(cfg.patch_sizes), "strides": list(cfg.strides),
              "mlp_ratios": list(cfg.mlp_ratios), "decoder_hidden_size": cfg.decoder_hidden_size,
              "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
              "num_encoder_blocks": len(cfg.depths), "num_channels": 3,
              "reshape_last_stage": True}
    _write_transformers_folder(root, model, config, preprocessor or SEGFORMER_PREPROCESSOR)
    return model


def write_midas(path, cfg, seed, device, scale=0.02, features=256):
    """A MiDaS ``dpt_swin2_*.pt`` of ``cfg`` (``conditions/swin2.py:SwinV2Config``):
    the model's state dict (seeded, the head's last bias 1) with the
    backbone's index, table and mask buffers beside it, as the released file
    holds them; returns the module."""
    from ctrl_adapter_tpu_torch.conditions.dpt_swin import DPTSwinDepthModel

    model = seeded_fill(DPTSwinDepthModel(cfg, features, device=device), seed, scale)
    with torch.no_grad():  # the depth above the final relu's zero, as a trained head's
        model.scratch.output_conv[4].bias.fill_(1.0)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    for name, buf in model.named_buffers():
        if name.startswith("pretrained.model.") and buf is not None:
            state[name] = buf.cpu()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(state, path)
    return model


def nnet_release_shapes(stem=48, stages=None, head=2048, dims=(2048, 1024, 512, 256, 128)):
    """{name: shape} of ``scannet.pt``'s ``model`` state dict (the NormalBAE
    NNET: geffnet's tf_efficientnet_b5_ap under ``encoder.original_model``,
    BatchNorms apart, its unused ``bn2`` kept, and the decoder; without the
    ``module.`` prefix) and the set of BatchNorm weight names."""
    from ctrl_adapter_tpu_torch.conditions.normalbae import B5_STAGES

    stages = stages or B5_STAGES
    enc = "encoder.original_model"
    out, norms = {}, set()

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{leaf}"] = (c,)
        out[f"{prefix}.num_batches_tracked"] = ()
        norms.add(f"{prefix}.weight")

    def conv(name, o, i, k, bias=False, groups=1):
        out[f"{name}.weight"] = (o, i // groups, k, k)
        if bias:
            out[f"{name}.bias"] = (o,)

    conv(f"{enc}.conv_stem", stem, 3, 3)
    bn(f"{enc}.bn1", stem)
    cin = stem
    for s, (repeats, k, _stride, expand, cout) in enumerate(stages):
        for j in range(repeats):
            t, mid, se = f"{enc}.blocks.{s}.{j}", cin * expand, max(1, cin // 4)
            if expand != 1:
                conv(f"{t}.conv_pw", mid, cin, 1)
                bn(f"{t}.bn1", mid)
            conv(f"{t}.conv_dw", mid, mid, k, groups=mid)
            bn(f"{t}.bn1" if expand == 1 else f"{t}.bn2", mid)
            conv(f"{t}.se.conv_reduce", se, mid, 1, bias=True)
            conv(f"{t}.se.conv_expand", mid, se, 1, bias=True)
            conv(f"{t}.conv_pw" if expand == 1 else f"{t}.conv_pwl", cout, mid, 1)
            bn(f"{t}.bn2" if expand == 1 else f"{t}.bn3", cout)
            cin = cout
    conv(f"{enc}.conv_head", head, cin, 1)
    bn(f"{enc}.bn2", head)
    skips = [stages[i][4] for i in (0, 1, 2, 4)]
    conv("decoder.conv2", dims[0], head, 1, bias=True)
    for i, cin in enumerate((dims[0] + skips[3], dims[1] + skips[2], dims[2] + skips[1],
                             dims[3] + skips[0])):
        net = f"decoder.up{i + 1}._net"
        conv(f"{net}.0", dims[i + 1], cin, 3, bias=True)
        bn(f"{net}.1", dims[i + 1])
        conv(f"{net}.3", dims[i + 1], dims[i + 1], 3, bias=True)
        bn(f"{net}.4", dims[i + 1])
    conv("decoder.out_conv_res8", 4, dims[2], 3, bias=True)
    for scale, c in (("res4", dims[2]), ("res2", dims[3]), ("res1", dims[4])):
        for i, (o, n) in zip((0, 2, 4, 6), ((128, c + 4), (128, 128), (128, 128), (4, 128))):
            out[f"decoder.out_conv_{scale}.{i}.weight"] = (o, n, 1)  # Conv1d
            out[f"decoder.out_conv_{scale}.{i}.bias"] = (o,)
    return out, norms


def annotator_release_shapes():
    """{type: ({name: shape}, BatchNorm weight names)} of the five released
    annotator state dicts at the published widths, without prefixes:
    ``table5_pidinet.pth`` (raw 3x3 difference convs), ``ControlNetHED.pth``,
    ``sk_model.pth`` (3 residual blocks), ``scannet.pt``,
    ``body_pose_model.pth`` (the caffe export's names)."""
    from ctrl_adapter_tpu_torch.conditions import hed, lineart, openpose, pidinet

    def shapes(module, strip=""):
        return {k.removeprefix(strip): tuple(v.shape) for k, v in module.state_dict().items()}

    pidi = shapes(pidinet.PiDiNet(device="meta"))
    raw = [("init_block.weight", pidinet.CARV4[0])] + [
        (f"block{s + 1}_{b + 1}.conv1.weight", op) for s, b, op in pidinet._blocks(pidinet.CARV4)]
    for name, op in raw:  # the checkpoint holds rd's 3x3 weight; the converter makes it 5x5
        pidi[name] = pidi[name][:2] + (3, 3)
    return {"softedge": (pidi, set()),
            "scribble": (shapes(hed.ControlNetHED(device="meta")), set()),
            "lineart": (shapes(lineart.LineartGenerator(3, device="meta")), set()),
            "normal": nnet_release_shapes(),
            "openpose": (shapes(openpose.BodyPoseNet(device="meta"), "layers."), set())}


def write_annotators(root, seed, device, scale=0.02):
    """The five released annotator checkpoints under ``root``, in their files'
    layouts (``{"state_dict": {"module." ...}}`` for PiDiNet, ``{"model":
    {"module." ...}}`` for NNET, the bare state dict for the others), every
    tensor drawn on ``device`` from a generator of ``seed``: a BatchNorm's
    weight 1 + scale N(0, 1), its running variance 1 + |N| / 2, its counter
    0, the rest scale N(0, 1). Returns {type: path}."""
    from ctrl_adapter_tpu_torch.conditions.extractors import ANNOTATORS

    g = torch.Generator(device=device).manual_seed(seed)
    paths = {}
    for ctype, (spec, norms) in annotator_release_shapes().items():
        state = {}
        for name, shape in spec.items():
            if name.endswith("num_batches_tracked"):
                state[name] = torch.tensor(0)
                continue
            draw = torch.randn(shape, generator=g, device=device)
            if name.endswith("running_var"):
                draw = 1 + 0.5 * draw.abs()
            elif name in norms:
                draw = 1 + scale * draw
            else:
                draw = scale * draw
            state[name] = draw.cpu()
        if ctype == "softedge":
            state = {"state_dict": {f"module.{k}": v for k, v in state.items()}}
        elif ctype == "normal":
            state = {"model": {f"module.{k}": v for k, v in state.items()}}
        paths[ctype] = os.path.join(root, ANNOTATORS[ctype][1])
        os.makedirs(root, exist_ok=True)
        torch.save(state, paths[ctype])
    return paths


def pose_fields(h=96, w=96):
    """OpenPose heat (h, w, 19) and PAF (h, w, 38) fields of two people of 6
    parts (nose, neck, both shoulders and elbows), gaussian peaks and unit
    limb vectors 5 pixels wide: what the decoding and the drawing are held to
    where the seeded networks find no one (``POSE_CANVAS_SHA256``)."""
    import numpy as np
    from ctrl_adapter_tpu_torch.conditions.openpose import LIMB_SEQ, MAP_IDX

    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    people = [{1: (10, 30), 2: (20, 30), 3: (20, 42), 6: (20, 18), 4: (34, 46), 7: (34, 14)},
              {1: (50, 60), 2: (60, 60), 3: (60, 72), 6: (60, 48), 4: (74, 76), 7: (74, 44)}]
    for person in people:
        for part, (y, x) in person.items():
            heat[:, :, part - 1] += np.exp(-((ys - y) ** 2 + (xs - x) ** 2) / (2 * 2.5 ** 2))
        for k, (a, b) in enumerate(LIMB_SEQ):
            if a in person and b in person:
                (ya, xa), (yb, xb) = person[a], person[b]
                v = np.array([xb - xa, yb - ya], np.float32)
                v /= np.linalg.norm(v)
                for t in np.linspace(0, 1, 40):
                    y, x = int(round(ya + t * (yb - ya))), int(round(xa + t * (xb - xa)))
                    for c, val in zip(MAP_IDX[k], v):
                        paf[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3, c - 19] = val
    return heat, paf


# sha256 of the JAX package's draw_bodypose canvas (cv2) of pose_fields()'s two
# people (tests/test_torch_annotators.py::test_pose_fields_canvas_is_the_jax_one)
POSE_CANVAS_SHA256 = "99dac71d6462d1c2c3f983ca7b8e371da3af1dcb32ec1191e1bdf216b5c93fb7"


def write_clip_folder(root, n_clips, frames, size, seed, prompt=CLI_PROMPT):
    """``n_clips`` clips of ``frames`` smooth PNG frames (``clip{i}/000.png``,
    ...) and ``captions.csv`` under ``root``; returns (folder, csv)."""
    import numpy as np
    from ctrl_adapter_tpu_torch.utils.image import save_png

    rng = np.random.default_rng(seed)
    for i in range(n_clips):
        for j, fr in enumerate(smooth_frames(rng, frames, size)):
            save_png(fr, os.path.join(root, f"clip{i}", f"{j:03d}.png"))
    csv_path = os.path.join(root, "captions.csv")
    with open(csv_path, "w") as fh:
        fh.write("name,caption\n" + "".join(f"clip{i}.mp4,{prompt} {i}\n" for i in range(n_clips)))
    return root, csv_path


def write_image_folder(root, n_images, size, seed, prompt=CLI_PROMPT):
    """``n_images`` smooth PNG images and ``captions.csv`` under ``root``."""
    import numpy as np
    from ctrl_adapter_tpu_torch.utils.image import save_png

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i, fr in enumerate(smooth_frames(rng, n_images, size)):
        save_png(fr, os.path.join(root, f"img{i}.png"))
    csv_path = os.path.join(root, "captions.csv")
    with open(csv_path, "w") as fh:
        fh.write("name,caption\n" + "".join(f"img{i}.png,{prompt} {i}\n"
                                            for i in range(n_images)))
    return root, csv_path


def fill_on_card(seed):
    """A stand-in for ``inference_torch.fabricate_params`` (for ``swapped``):
    ``--fake_weights``' towers drawn on the card by ``random_fill`` from
    generators of ``seed`` + i, not from host numpy (~40 s for SVD's 2.6 B
    values on the card's host)."""
    import inference_torch

    def make(_):
        def run(pipe, scale=0.02):
            for i, module in enumerate(inference_torch.towers(pipe).values()):
                random_fill(module, seed + i, scale)
        return run
    return make


def write_stack(pipe, root):
    """The pipeline's towers as diffusers release folders under ``root`` (``unet``,
    ``vae``, ``adapter``, ``router``, ``controlnet``, ``controlnet_1``, ...),
    each tensor in its module's dtype; returns the CLI flags that read them."""
    from ctrl_adapter_tpu_torch.convert.release import save_release
    from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel

    for name in ("unet", "vae", "adapter", "router"):
        module = getattr(pipe, name, None)
        if module is not None:
            save_release(module.state_dict(), os.path.join(root, name))
    multi = (pipe.controlnet if isinstance(pipe.controlnet, MultiControlNetModel)
             else MultiControlNetModel([pipe.controlnet]))
    cn_dirs = multi.save_pretrained(root)
    flags = ["--pretrained_model_path", root, "--adapter_checkpoint_path",
             os.path.join(root, "adapter"), "--controlnet_model_paths", *cn_dirs]
    if getattr(pipe, "router", None) is not None:
        flags += ["--router_checkpoint_path", os.path.join(root, "router")]
    return flags


def decode_gif(blob):
    """The frames of a GIF (global or local colour table, no interlace, each
    frame the full canvas) as (n, h, w, 3) uint8: enough to read back what
    ``utils/image.py:encode_gif`` writes."""
    import struct

    import numpy as np

    if blob[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, flags = struct.unpack("<HHB", blob[6:11])
    pos = 13
    table = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        table = np.frombuffer(blob[pos: pos + n], np.uint8).reshape(-1, 3)
        pos += n
    frames = []
    while pos < len(blob):
        kind = blob[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:  # extension: a label, then sub-blocks
            pos += 1
            while blob[pos]:
                pos += blob[pos] + 1
            pos += 1
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF: unknown block {kind:#x}")
        _, _, fw, fh, fflags = struct.unpack("<HHHHB", blob[pos: pos + 9])
        pos += 9
        colors = table
        if fflags & 0x80:
            n = 3 << ((fflags & 7) + 1)
            colors = np.frombuffer(blob[pos: pos + n], np.uint8).reshape(-1, 3)
            pos += n
        if fflags & 0x40 or (fw, fh) != (w, h):
            raise ValueError("GIF: interlaced or partial frames are not read")
        min_size = blob[pos]
        pos += 1
        data = bytearray()
        while blob[pos]:
            data += blob[pos + 1: pos + 1 + blob[pos]]
            pos += blob[pos] + 1
        pos += 1
        frames.append(colors[np.frombuffer(_lzw_decode(bytes(data), min_size), np.uint8)
                             [: w * h].reshape(h, w)])
    return np.stack(frames)


def _lzw_decode(data, min_size):
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    bits = nbits = pos = 0
    size = min_size + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    prev = None
    while True:
        while nbits < size:
            if pos >= len(data):
                return bytes(out)
            bits |= data[pos] << nbits
            nbits += 8
            pos += 1
        code = bits & ((1 << size) - 1)
        bits >>= size
        nbits -= size
        if code == clear:
            table = table[: eoi + 1]
            size, prev = min_size + 1, None
            continue
        if code == eoi:
            return bytes(out)
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            table.append(prev + entry[:1])
            if len(table) == (1 << size) and size < 12:
                size += 1
        out += entry
        prev = entry


def cli_run(label, argv, kernels):
    """``inference_torch.main(argv)`` on the card, its towers hooked as they are
    built: launches and host ms per denoise step, decode seconds; every launch
    count from 0 just before the call, read just after; the status line
    checked. Returns the run and what was measured."""
    import io

    import inference_torch

    box = {}
    build = inference_torch.build_modules
    hooks = contextlib.ExitStack()

    def hooked_build(args, device, dtype=torch.bfloat16):
        pipe = build(args, device, dtype)
        box["ms"] = []
        box["steps"] = hooks.enter_context(launches_per_step(pipe, kernels, box["ms"]))
        decode = pipe._decode

        def timed_decode(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode(*args, **kwargs)
            torch.cuda.synchronize()
            box["decode_s"] = time.perf_counter() - t0
            return out

        pipe._decode = timed_decode
        return pipe

    stdout = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    box["before_gb"] = torch.cuda.memory_allocated() / 2 ** 30
    for k in kernels.values():
        k.reset()
    with hooks, swapped(inference_torch, "build_modules", lambda _: hooked_build), \
            contextlib.redirect_stdout(stdout):
        run = inference_torch.main(argv)
    box["launches"] = {name: k.launches for name, k in kernels.items()}
    box["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    lines = stdout.getvalue().strip().splitlines()
    print("\n".join(f"{label}: CLI stdout: {line}" for line in lines))
    if not lines or json.loads(lines[-1]) != {"status": "ok", "output": run.out_root}:
        raise RuntimeError(f"{label}: the CLI printed no status line: {lines[-3:]}")
    return run, box


def check_cli_run(label, run, box, want_per_step, card):
    """The outputs of one SVD CLI run: the video, the two gifs, the launches
    per step against phase 4's; prints its times."""
    video = torch.from_numpy(run.videos["s0"])
    check_video(video, label, FRAMES)
    out = os.path.join(run.out_root, "s0")
    for name, width in (("output.gif", SIZE), ("output_concat.gif", 2 * SIZE)):
        with open(os.path.join(out, name), "rb") as fh:
            frames = decode_gif(fh.read())
        if frames.shape != (FRAMES, SIZE, width, 3):
            raise RuntimeError(f"{label}: {name} decodes to {frames.shape}")
    per_step = per_kind(label, box["steps"])
    on_path = ("group_norm_silu", "flash_attention", "temporal_block", "temporal_block_full")
    wrong = {kind: ({n: counts[n] for n in on_path},
                    {n: want_per_step[kind][n] for n in on_path})
             for kind, counts in per_step.items()
             if any(counts[n] != want_per_step[kind][n] for n in on_path)}
    if wrong or set(per_step) != set(want_per_step):
        raise RuntimeError(f"{label}: launches per step differ from phase 4 (got, want): {wrong}")
    ms = {kind: [m for (c, _), m in zip(box["steps"], box["ms"]) if c == (kind == "controlled")]
          for kind in ("controlled", "unet_only")}
    print(f"{label}: output.gif and output_concat.gif decode to {FRAMES} frames of {SIZE}x{SIZE} "
          f"and {SIZE}x{2 * SIZE}; K1, K2, K3 full and K3 hybrid per step as phase 4: "
          + "; ".join(f"{kind} {[per_step[kind][n] for n in on_path]}" for kind in per_step))
    print(f"{label} on {card}: load {run.load_s:.2f} s; encoders + image latent "
          f"{run.encode_ms['s0']:.1f} ms; "
          + "; ".join(f"{kind} steps {', '.join(f'{m:.1f}' for m in v)} ms"
                      for kind, v in ms.items())
          + f" (host clock, card synchronised at each end); decode {box['decode_s']:.3f} s; "
          f"generate {run.generate_s['s0']:.2f} s; peak {box['peak_gb']:.2f} GiB, of which "
          f"{box['before_gb']:.2f} GiB allocated before the call")
    return per_step


# The fp32 towers on the card against the CPU read 4.2e-7 (CLIP-L) and 8.8e-7
# (CLIP-H) of max|CPU| on the H100; TF32 or a bf16 path would be far above this.
ENCODER_TOL = 1e-5


def encoder_check(label, run, written, card):
    """The loaded encoders equal the written towers (fp16 files, ``written`` on
    the CPU), launch no kernel, give finite outputs, and agree with CPU fp32
    copies of themselves: max error relative to max|CPU| within ENCODER_TOL
    (fp32 on both, TF32 off)."""
    import numpy as np

    text, image = run.encoders["controlnet"], run.encoders["image"]
    for name, module in (("text", text.tower.model), ("image", image.model)):
        got = module.state_dict()
        for k, v in written[name].state_dict().items():
            if not torch.equal(got[k].cpu(), v.half().float()):
                raise RuntimeError(f"{label}: loaded {name} encoder tensor {k} differs")
    frame = (np.random.default_rng(SEED).uniform(0, 255, (SIZE, SIZE, 3))).astype(np.uint8)
    calls = {"text": lambda enc: enc([CLI_PROMPT], [""]),
             "image": lambda enc: enc([frame], antialiased=True)}
    kernels = kernel_counters()
    for k in kernels.values():
        k.reset()
    outs = {name: fn(enc) for (name, fn), enc in zip(calls.items(), (text, image))}
    if any(k.launches for k in kernels.values()):
        raise RuntimeError(f"{label}: the encoders launched a port kernel")
    times = {name: cuda_ms(lambda fn=fn, enc=enc: fn(enc), iters=3, reps=3)
             for (name, fn), enc in zip(calls.items(), (text, image))}
    cpu_text, cpu_image = copy.copy(text), copy.copy(image)
    cpu_text.tower = copy.copy(text.tower)
    cpu_text.tower.model = copy.deepcopy(text.tower.model).cpu()
    cpu_text.tower.device = torch.device("cpu")
    cpu_image.model = copy.deepcopy(image.model).cpu()
    cpu_image.device = torch.device("cpu")
    for name, enc in (("text", cpu_text), ("image", cpu_image)):
        ref = calls[name](enc)
        got = outs[name].cpu()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label}: {name} encoder output is not finite")
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        what = ("CLIP-L text, prompt and negative" if name == "text"
                else "CLIP-H vision, one frame, SVD preprocessing")
        print(f"{label}: {name} encoder {tuple(got.shape)} finite, on the card vs CPU fp32: max "
              f"error {err:.3e} of max|CPU| (tolerance {ENCODER_TOL:g}); {times[name]:.2f} ms "
              f"on {card} ({what})")
        if err > ENCODER_TOL:
            raise RuntimeError(f"{label}: {name} encoder on the card differs from the CPU")


def run_cli(dev, card, kernels, want_per_step, root):
    """Phase 13: ``inference_torch.py`` on the card at the main path's full
    width (SVD, 14 frames at 512x512, depth, skip_conv_in, 4 steps): (a) with
    ``--fake_weights``, (b) from diffusers-layout folders (the UNet, the
    temporal VAE, the SD-v1.5 ControlNet and the 13-block adapter in bf16
    safetensors; CLIP-L text with a small BPE tokenizer and CLIP-H vision in
    fp16) written under ``root``, the caller's directory: ``fixture/``,
    ``release/`` and ``sd15/`` stay there for phase 15."""
    import inference_torch
    from ctrl_adapter_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig

    fixture = write_cli_fixture(os.path.join(root, "fixture"), FRAMES, SIZE, ["depth"],
                                seed=SEED + 13)
    argv = ["--model_name", "svd", "--control_types", "depth", "--skip_conv_in", "True",
            "--n_sample_frames", str(FRAMES), "--height", str(SIZE), "--width", str(SIZE),
            "--num_inference_steps", str(CLI_STEPS), "--evaluation_input_folder", fixture]
    with swapped(inference_torch, "fabricate_params", fill_on_card(SEED + 10)):
        run, box = cli_run("cli (a) fake weights", argv + [
            "--evaluation_output_folder", os.path.join(root, "out_a"), "--fake_weights"],
            kernels)
    check_cli_run("cli (a) fake weights", run, box, want_per_step, card)
    launches = {"cli_fake": box["launches"]}
    del run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    src = inference_torch.build_modules(
        argparse.Namespace(model_name="svd", control_types=["depth"]), dev)
    for i, module in enumerate(inference_torch.towers(src).values()):
        random_fill(module, SEED + 20 + i)
    release = os.path.join(root, "release")
    flags = write_stack(src, release)
    sd15 = os.path.join(root, "sd15")
    written = {
        "text": write_text_encoder(sd15, CLIPTextConfig(eos_token_id=2), SEED + 30,
                                   torch.float16, dev),
        "image": write_image_encoder(release, CLIPVisionConfig(), SEED + 31, torch.float16,
                                     dev)}
    # what was written waits on the CPU, so the card holds only the CLI's own
    for module in (*inference_torch.towers(src).values(), *written.values()):
        module.cpu()
    torch.cuda.empty_cache()
    n_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                  for f in fs)
    print(f"cli (b): wrote {n_bytes / 2 ** 30:.3f} GiB ({n_bytes} bytes) of fixture, "
          f"diffusers-layout towers and encoders in {time.perf_counter() - t0:.1f} s")
    run, box = cli_run("cli (b) diffusers folders", argv + [
        "--evaluation_output_folder", os.path.join(root, "out_b"), *flags,
        "--controlnet_text_encoder_path", sd15], kernels)
    for name, module in inference_torch.towers(src).items():
        got = inference_torch.towers(run.pipe)[name].state_dict()
        bad = [k for k, v in module.state_dict().items()
               if not torch.equal(got[k].cpu(), v)]
        if bad or set(got) != set(module.state_dict()):
            raise RuntimeError(f"cli (b): loaded {name} differs from the written: {bad[:5]}")
    print(f"cli (b): every tensor of the UNet, the VAE, the ControlNet and the adapter "
          f"loaded equals the one written, bit for bit")
    check_cli_run("cli (b) diffusers folders", run, box, want_per_step, card)
    encoder_check("cli (b)", run, written, card)
    launches["cli_release"] = box["launches"]
    del run, src, written
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------- phase 14, the training CLI
TRAIN_PATH_KERNELS = ("group_norm_silu", "flash_attention", "flash_attention_bwd",
                      "temporal_block", "temporal_block_full")


def config_copy(name, root, data_path):
    """``configs/{name}`` with its ``DATA_PATH`` pointed at ``data_path`` (the
    YAML keys overwrite the flags, as in the reference), written under
    ``root``; read back through the port's YAML reader (the card's host has no
    PyYAML). Returns the copy's path and its values."""
    from ctrl_adapter_tpu_torch.config import load_yaml

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)
    with open(src) as fh:
        text = fh.read()
    if text.count("DATA_PATH: ./outputs\n") != 1:
        raise RuntimeError(f"{name}: no 'DATA_PATH: ./outputs' line to repoint")
    path = os.path.join(root, f"{os.path.basename(data_path)}_{name}")
    with open(path, "w") as fh:
        fh.write(text.replace("DATA_PATH: ./outputs\n", f"DATA_PATH: {data_path}\n"))
    values = load_yaml(path)
    if values["DATA_PATH"] != data_path or values != {**load_yaml(src), "DATA_PATH": data_path}:
        raise RuntimeError(f"{name}: the copy reads back as {values}")
    return path, values


def train_cli_run(label, argv, kernels, capture=None):
    """``train_torch.main(argv)`` on the card with each kernel's launches
    counted per ``train_step`` (every count from 0 just before the call, read
    just after); ``capture(trainer)`` runs before the first step. Prints the
    losses, build seconds, ms per step after the first and peak GiB; returns
    the run and what was measured. Raises on a non-finite loss."""
    import train_torch
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer

    box = {"steps": []}

    def counted(step):
        def run(self, *args, **kwargs):
            if capture is not None and not box["steps"]:
                capture(self)
            before = {n: k.launches for n, k in kernels.items()}
            out = step(self, *args, **kwargs)
            box["steps"].append({n: k.launches - before[n] for n, k in kernels.items()})
            return out
        return run

    torch.cuda.reset_peak_memory_stats()
    box["before_gb"] = torch.cuda.memory_allocated() / 2 ** 30
    for k in kernels.values():
        k.reset()
    with swapped(CtrlAdapterTrainer, "train_step", counted):
        run = train_torch.main(argv)
    box["launches"] = {name: k.launches for name, k in kernels.items()}
    box["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r["loss"] for r in run.records]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{label}: non-finite losses {losses}")
    ms = [1000 * s for s in run.step_s]
    print(f"{label}: steps {[r['step'] for r in run.records]}, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; build, fill or load and init "
          f"{run.build_s:.2f} s; step 1 {ms[0]:.1f} ms, "
          + (f"{statistics.mean(ms[1:]):.1f} ms/step after it "
             f"({', '.join(f'{t:.1f}' for t in ms[1:])})" if len(ms) > 1 else "one step")
          + f"; peak {box['peak_gb']:.2f} GiB ({box['before_gb']:.2f} GiB allocated before)")
    return run, box


def check_train_launches(label, box, want):
    """Each step's launches of the training path's kernels equal ``want``."""
    wrong = [(i + 1, {n: s[n] for n in TRAIN_PATH_KERNELS}) for i, s in enumerate(box["steps"])
             if any(s[n] != want[n] for n in TRAIN_PATH_KERNELS)]
    if wrong or not box["steps"]:
        raise RuntimeError(f"{label}: launches per step (step, counts) {wrong}, want "
                           f"{ {n: want[n] for n in TRAIN_PATH_KERNELS} }")
    print(f"{label}: K1, K2, K2 backward, K3 hybrid, K3 full per step "
          f"{[want[n] for n in TRAIN_PATH_KERNELS]} in each of {len(box['steps'])} steps, as the "
          f"library runs' (phases 8, 11)")


def released(label, before):
    """After the caller dropped a run: the card holds no more than the
    ``before`` GiB allocated before it."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2 ** 30
    print(f"{label}: after the run the card holds {left:.2f} GiB ({before:.2f} before it)")
    if left > before + 0.5:
        raise RuntimeError(f"{label}: {left - before:.2f} GiB left on the card after the run")


def states_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def update_gap(start, a, b, dev):
    """||(a - start) - (b - start)|| / ||a - start|| over lists of tensors,
    each moved to ``dev`` in turn."""
    num = den = 0.0
    for s, x, y in zip(start, a, b):
        s, x, y = (t.to(dev).float() for t in (s, x, y))
        num += float(torch.sum((x - y) ** 2))
        den += float(torch.sum((x - s) ** 2))
    return math.sqrt(num / den)


def nondeterministic_ops(run):
    """``run()`` under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: returns its result and the first line of each warning
    that names an op without a deterministic implementation, once each."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out = run()
        finally:
            torch.use_deterministic_algorithms(False)
    named = []
    for w in caught:
        text = str(w.message).strip().splitlines()[0]
        if "determinis" in text and text not in named:
            named.append(text)
    return out, named


def run_train_cli(dev, card, kernels, svd_per_step, serve_per_step):
    """Phase 14: ``train_torch.main`` on the card at full width. (a) SVD depth
    (``configs/svd_train_depth.yaml``: 1 x 14 x 512^2, skip_conv_in,
    ``--fake_weights``), 3 steps under a one-rank NCCL group (``--multihost``
    with torchrun's variables for a world of one), a checkpoint at
    step 2 and at step 3, a validation sample at step 3; the same 3 steps
    without a group; (b) a resume from ``checkpoint-2`` for step 3; (c)
    ``inference_torch.main`` serving (a)'s ``adapter_3``; (d) SDXL depth at
    1024^2, 2 steps (the I2VGen-XL multi-condition run went to phase 15 (4),
    on real data). Returns the launch counts of (a) and (d)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    import inference_torch
    from ctrl_adapter_tpu_torch.convert.release import load_release
    from ctrl_adapter_tpu_torch.train import checkpoints
    from ctrl_adapter_tpu_torch.train import trainer as trainer_mod
    from ctrl_adapter_tpu_torch.train.trainer import MasterOptimizer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    counts = {}
    try:
        # (a) under a one-rank NCCL group: the all-reduce of every step's fp32
        # gradient checked to return its input, bit for bit; the gradients and
        # the first masters kept for a replay without the group
        data_a = os.path.join(root, "a")
        cfg_a, values = config_copy("svd_train_depth.yaml", root, data_a)
        common = ["--yaml_file", cfg_a, "--fake_weights", "--max_train_steps", "3",
                  "--seed", str(SEED)]
        argv_a = common + ["--checkpointing_steps", "2", "--run_validation",
                           "--validate_every_steps", "3"]
        seen = {"grads": [], "identity": []}

        def checked(reduce):
            def run(flat, group):
                before = flat.clone()
                out = reduce(flat, group)
                seen["identity"].append(torch.equal(before, out))
                seen["grads"].append(before.to("cpu", copy=True))
                return out
            return run

        def keep_start(trainer):
            seen["start"] = [m.detach().to("cpu", copy=True) for m in trainer.optimizer.masters]

        torchrun = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
        with environ(torchrun), swapped(trainer_mod, "all_reduce_mean_", checked):
            run_a = train_cli_run("train CLI (a) svd, one-rank NCCL group",
                                  argv_a + ["--multihost"], kernels, keep_start)
        run, box = run_a
        counts["train_cli_svd"] = box["launches"]
        if run.mesh.world_size != 1 or run.mesh.group is None or dist.is_initialized():
            raise RuntimeError(f"train CLI (a): not under a one-rank group it left: {run.mesh}")
        if len(seen["identity"]) != 3 or not all(seen["identity"]):
            raise RuntimeError(f"train CLI (a): the one-rank all-reduce changed the gradient: "
                               f"{seen['identity']}")
        check_train_launches("train CLI (a)", box, svd_per_step)
        with open(os.path.join(data_a, "train_log.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        if logged != run.records or [r["step"] for r in logged] != [1, 2, 3] or any(
                r["lr"] != values.get("learning_rate", 5e-5) or r["loss_time"] <= 0
                for r in logged):
            raise RuntimeError(f"train CLI (a): the log's records {logged}")
        with open(run.validations[0], "rb") as fh:
            frames = decode_gif(fh.read())
        if run.validations != [os.path.join(data_a, "validation", "step_3.gif")] or \
                frames.shape != (FRAMES, SIZE, SIZE, 3):
            raise RuntimeError(f"train CLI (a): validation {run.validations}, {frames.shape}")
        want_ckpts = [os.path.join(data_a, f"checkpoint-{i}") for i in (2, 3)]
        loaded = checkpoints.load_checkpoint(want_ckpts[1], 3)
        opt = run.trainer.optimizer.state_dict()
        same = (run.checkpoints == want_ckpts and states_equal(loaded["adapter"],
                                                               run.trainer.adapter_state())
                and loaded["optimizer"]["update_count"] == opt["update_count"] == 3
                and all(states_equal(st, loaded["optimizer"]["adamw"]["state"][i])
                        for i, st in opt["adamw"]["state"].items()))
        print(f"train CLI (a): {len(logged)} log records as returned; validation step_3.gif "
              f"decodes to {frames.shape}; checkpoints "
              f"{[os.path.basename(c) for c in run.checkpoints]}"
              f", checkpoint-3 read back {'equal to the bit' if same else 'DIFFERENT'}; the "
              f"one-rank NCCL all-reduce returned each step's gradient unchanged, bit for bit")
        if not same:
            raise RuntimeError("train CLI (a): checkpoint-3 does not read back as written")
        del loaded, opt
        # the same updates without a group, from the same gradients
        replay = MasterOptimizer(run.trainer.config,
                                 [torch.nn.Parameter(m.to(dev, copy=True)) for m in seen["start"]])
        shapes = [m.shape for m in replay.masters]
        for flat in seen["grads"]:
            replay.step([g.view(s) for g, s in zip(flat.to(dev).split([math.prod(s) for s in
                                                                         shapes]), shapes)])
        replayed = all(torch.equal(a, b) for a, b in
                       zip(replay.masters, run.trainer.optimizer.masters))
        masters_a = [m.detach().to("cpu", copy=True) for m in run.trainer.optimizer.masters]
        print(f"train CLI (a): the 3 updates replayed without a group from the same gradients "
              f"give masters {'equal to the bit' if replayed else 'DIFFERENT'}")
        if not replayed:
            raise RuntimeError("train CLI (a): a one-rank group changed the masters")
        del replay, seen["grads"]
        losses_a, before = [r["loss"] for r in run.records], box["before_gb"]
        del run, run_a, box
        released("train CLI (a)", before)

        # the same 3 steps without any group
        data_f = os.path.join(root, "f")
        cfg_f, _ = config_copy("svd_train_depth.yaml", root, data_f)
        run_f = train_cli_run("train CLI (a) svd, no group", ["--yaml_file", cfg_f] + common[2:]
                              + ["--save_starting_step", "4"], kernels)
        run, box = run_f
        check_train_launches("train CLI (a) no group", box, svd_per_step)
        gap = update_gap(seen["start"], masters_a, run.trainer.optimizer.masters, dev)
        first_equal = run.records[0]["loss"] == losses_a[0]
        print(f"train CLI (a) no group: step 1 loss "
              f"{'equal to the bit' if first_equal else 'DIFFERENT'}"
              f" (the forward is deterministic); losses of steps 2-3 "
              f"{[r['loss'] - x for r, x in zip(run.records[1:], losses_a[1:])]} from the "
              f"grouped run's; the grouped and ungrouped runs' updates differ by {gap!r} of "
              f"their norm (held to 0: every gradient of the step repeats its bits)")
        if not first_equal or run.mesh.group is not None:
            raise RuntimeError("train CLI (a): the run without a group differs")
        before = box["before_gb"]
        del run, run_f, box
        released("train CLI (a) no group", before)
        if gap != 0:
            # before failing: the ops of the step PyTorch itself calls not repeatable
            data_d = os.path.join(root, "d")
            cfg_d, _ = config_copy("svd_train_depth.yaml", root, data_d)
            (run, box), named = nondeterministic_ops(lambda: train_cli_run(
                "train CLI (a) no group, deterministic algorithms (warn only)",
                ["--yaml_file", cfg_d] + common[2:] + ["--save_starting_step", "4"], kernels))
            print("train CLI (a) no group under torch.use_deterministic_algorithms(True, "
                  f"warn_only=True): {len(named)} ops named" + "".join(
                      f"\n    {text}" for text in named))
            before = box["before_gb"]
            del run, box
            released("train CLI (a) no group, deterministic algorithms", before)
            raise RuntimeError(f"train CLI (a): the run without a group moved {gap!r} from "
                               "the grouped run's updates")

        # (b) resume from checkpoint-2 for step 3
        data_b = os.path.join(root, "b")
        cfg_b, _ = config_copy("svd_train_depth.yaml", root, data_b)
        restored = {}

        def keep_restored(trainer):
            restored["adapter"] = {k: v.detach().cpu().clone()
                                   for k, v in trainer.adapter_state().items()}
            restored["optimizer"] = copy.deepcopy(trainer.optimizer.state_dict())

        run_b = train_cli_run("train CLI (b) resume", ["--yaml_file", cfg_b] + common[2:] + [
            "--adapter_resume_path", want_ckpts[0], "--adapter_resume_step", "2",
            "--save_starting_step", "4"], kernels, keep_restored)
        run, box = run_b
        check_train_launches("train CLI (b)", box, svd_per_step)
        written = checkpoints.load_checkpoint(want_ckpts[0], 2)
        wopt, ropt = written["optimizer"], restored["optimizer"]
        exact = (states_equal(written["adapter"], restored["adapter"])
                 and (wopt["update_count"], wopt["mini_step"], wopt["acc_grads"])
                 == (ropt["update_count"], ropt["mini_step"], ropt["acc_grads"]) == (2, 0, None)
                 and all(states_equal(st, ropt["adamw"]["state"][i])
                         for i, st in wopt["adamw"]["state"].items()))
        loss_b = run.records[0]["loss"]
        rel = abs(loss_b - losses_a[2]) / abs(losses_a[2])
        print(f"train CLI (b): resumed at step {run.records[0]['step']}: masters, AdamW state, "
              f"update count and accumulation restored "
              f"{'equal to the bit' if exact else 'DIFFERENT'}"
              f" to checkpoint-2; step 3 loss {loss_b:.9f} against (a)'s {losses_a[2]:.9f} "
              f"(relative {rel:.3e}; tolerance 1e-5, the forward of the same masters)")
        if not exact or [r["step"] for r in run.records] != [3] or rel > 1e-5:
            raise RuntimeError("train CLI (b): the resume is not exact")
        before = box["before_gb"]
        del run, run_b, box, written, wopt, ropt, restored
        shutil.rmtree(want_ckpts[0])
        released("train CLI (b)", before)

        # (c) serve (a)'s adapter_3 through inference_torch.main, the other
        # towers drawn on the card
        adapter_dir = os.path.join(want_ckpts[1], "adapter_3")

        def fabricate_then_load(_):
            def run(pipe, scale=0.02):
                for i, module in enumerate(inference_torch.towers(pipe).values()):
                    random_fill(module, SEED + 40 + i, scale)
                load_release(pipe.adapter, adapter_dir)
            return run

        fixture = write_cli_fixture(os.path.join(root, "fixture"), FRAMES, SIZE, ["depth"],
                                    seed=SEED + 14)
        argv_c = ["--model_name", "svd", "--control_types", "depth", "--skip_conv_in", "True",
                  "--n_sample_frames", str(FRAMES), "--height", str(SIZE), "--width", str(SIZE),
                  "--num_inference_steps", "2", "--evaluation_input_folder", fixture,
                  "--evaluation_output_folder", os.path.join(root, "c"), "--fake_weights"]
        with torch.no_grad(), swapped(inference_torch, "fabricate_params", fabricate_then_load):
            serve, sbox = cli_run("train CLI (c) serving adapter_3", argv_c, kernels)
        got = serve.pipe.adapter.state_dict()
        same = all(torch.equal(got[k], v.to(got[k].device, got[k].dtype)) for k, v in
                   zip((n for n, _ in serve.pipe.adapter.named_parameters()), masters_a))
        print(f"train CLI (c): the served adapter is (a)'s masters in bf16 "
              f"{'to the bit' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError("train CLI (c): the served adapter differs from the trained one")
        check_cli_run("train CLI (c)", serve, sbox, serve_per_step, card)
        del serve, got, masters_a, seen
        gc.collect()
        torch.cuda.empty_cache()

        # (d) SDXL depth, 2 steps (I2VGen-XL multi-condition runs on real data in
        # phase 15 (4), through the same CLI path)
        data_s = os.path.join(root, "s")
        cfg_s, _ = config_copy("sdxl_train_depth.yaml", root, data_s)
        run_s = train_cli_run("train CLI (d) sdxl", [
            "--yaml_file", cfg_s, "--fake_weights", "--max_train_steps", "2",
            "--save_starting_step", "3", "--seed", str(SEED)], kernels)
        counts["train_cli_sdxl"] = run_s[1]["launches"]
        check_train_launches("train CLI (d) sdxl", run_s[1], sdxl_train_launches())
        before = run_s[1]["before_gb"]
        del run_s
        released("train CLI (d) sdxl", before)
        print(f"phase 14 on {card}: {time.perf_counter() - t_phase:.1f} s")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------- phase 15, condition extraction and real data
EXTRACT_TIMES = 3  # timed calls after a warm one
# an extractor on the card against its CPU copy, one frame, fp32 (TF32 off):
# the network's output within this share of its largest value
NET_TOL = 1e-4
# segmentation: the share of pixels whose class may flip at a near-tie
SEG_FLIP = 1e-3


def _cpu_copy(extractor):
    """The estimator with its network and its tensors (a palette, the
    normalisation) copied to the CPU."""
    out = copy.copy(extractor)
    out.model = copy.deepcopy(extractor.model).cpu()
    out.device = torch.device("cpu")
    for name, value in vars(extractor).items():
        if isinstance(value, torch.Tensor):
            setattr(out, name, value.cpu())
    return out


def _io(module, run, replace=None):
    """``run()``'s result, the inputs ``module`` was given and the outputs it
    gave during it (the last of a tuple or list: OpenPose's heatmaps, NNET's
    finest prediction); with ``replace`` the module takes that input in place
    of its own (its own is still what is recorded)."""
    inputs, outputs = [], []

    def pre(m, args):
        inputs.append(args[0].detach())
        if replace is not None:
            return (replace.to(args[0].device, args[0].dtype),) + args[1:]
        return None

    handles = [module.register_forward_pre_hook(pre),
               module.register_forward_hook(lambda m, i, out: outputs.append(
                   (out[-1] if isinstance(out, (tuple, list)) else out).detach()))]
    try:
        return run(), inputs, outputs
    finally:
        for h in handles:
            h.remove()


def extractor_check(label, fn, cpu_fn, frames, card, kernels, nets=None, step=None,
                    exact=False):
    """``fn`` on the card over ``frames``: a warm call, then ``EXTRACT_TIMES``
    timed ones (host clock, card synchronised) and the peak memory; no port
    kernel may launch. Then ``fn`` and ``cpu_fn`` on the first frame: uint8
    maps within one step (equal with ``exact``; segmentation: at most
    ``SEG_FLIP`` of the pixels apart). With ``nets`` = (the card's network,
    the CPU's): the networks'
    inputs (each device's preprocessing) within ``step``, one uint8 step in
    the network's units; the CPU network is given the card's input, and its
    output must lie within ``NET_TOL`` of its largest value from the card's;
    and one call's device busy time and top kernels under
    ``torch.profiler``. Returns the card's maps of ``frames``."""
    import numpy as np

    for k in kernels.values():
        k.reset()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    maps = fn(frames)
    times = []
    for _ in range(EXTRACT_TIMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frames)
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(k.launches for k in kernels.values()):
        raise RuntimeError(f"{label}: the extractor launched a port kernel")
    if len(maps) != len(frames) or any(m.shape != f.shape or m.dtype != np.uint8
                                       for m, f in zip(maps, frames)):
        raise RuntimeError(f"{label}: maps {[m.shape for m in maps[:2]]} for frames "
                           f"{frames[0].shape}")
    if nets is not None:
        got_map, got_in, got = _io(nets[0], lambda: fn(frames[:1]))
        got_in = got_in[0].float().cpu()
        ref_map, ref_in, want = _io(nets[1], lambda: cpu_fn(frames[:1]), replace=got_in)
        in_diff = float((got_in - ref_in[0]).abs().max())
    else:
        got_map, ref_map = fn(frames[:1]), cpu_fn(frames[:1])
    diff = np.abs(got_map[0].astype(int) - ref_map[0])
    if label.startswith("segmentation"):
        apart = float((diff.max(axis=-1) > 0).mean())
        what = f"{apart:.2e} of the pixels in another class (tolerance {SEG_FLIP:g})"
        bad = apart > SEG_FLIP
    else:
        what = f"max uint8 difference {int(diff.max())} (tolerance {0 if exact else 1})"
        bad = diff.max() > (0 if exact else 1)
    if nets is not None:
        got, want = got[0].float().cpu(), want[0]
        rel = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        what += (f"; preprocessed input {in_diff:.3e} apart (tolerance {step:.3e}, one uint8 "
                 f"step); network output on the card's input {rel:.3e} of max|CPU| "
                 f"{float(want.abs().max()):.3e} (tolerance {NET_TOL:g})")
        bad = (bad or not rel <= NET_TOL or not torch.isfinite(got).all()
               or not in_diff <= step * 1.01)  # float32's rounding of one step
    print(f"{label}: {len(frames)} frames of {frames[0].shape[1]}x{frames[0].shape[0]}: "
          f"{statistics.median(times):.1f} ms a call (median of {EXTRACT_TIMES}: "
          f"{', '.join(f'{t:.1f}' for t in times)}; host clock, card synchronised), peak "
          f"{peak:.2f} GiB ({before:.2f} allocated before), no port kernel; on the card vs "
          f"the CPU, one frame: {what}; {card}")
    if bad:
        raise RuntimeError(f"{label}: the card's output differs from the CPU's")
    if nets is not None:
        print_activity(f"{label}: one call: ", device_activity(lambda: fn(frames)), unit="call",
                       top=5)
    return maps


def cuda_left(label, before, top=6):
    """After the caller dropped a run: the GiB the card still holds (gc run,
    cache emptied); over ``before`` + 0.1, the largest live CUDA tensors the
    collector can see are printed."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2 ** 30
    print(f"{label}: after the run the card holds {left:.2f} GiB ({before:.2f} before it)")
    if left > before + 0.1:
        seen = {}
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    seen[obj.data_ptr()] = (obj.untyped_storage().nbytes(), tuple(obj.shape),
                                            obj.dtype, type(obj).__name__)
            except Exception:  # objects that fail isinstance or a storage query: not tensors
                continue
        found = sorted(seen.values(), key=lambda t: -t[0])
        print(f"  {len(found)} live CUDA tensors found, {sum(t[0] for t in found) / 2 ** 30:.2f} "
              f"GiB; the largest: " + "; ".join(f"{n / 2 ** 20:.1f} MiB {shape} {dtype} {kind}"
                                               for n, shape, dtype, kind in found[:top]))
    return left - before


def data_config(name, root, data_path, train_data, prompts, edits=()):
    """``configs/{name}`` with ``DATA_PATH``, ``train_data_path`` and
    ``train_prompt_path`` pointed at ``data_path``, ``train_data`` and
    ``prompts`` and the text ``edits`` (old, new) made, written under ``root``
    and read back by the port's YAML reader. Returns the copy's path."""
    from ctrl_adapter_tpu_torch.config import load_yaml

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)
    with open(src) as fh:
        text = fh.read()
    key = {"videos": "sample_data/videos", "video_captions": "sample_data/video_captions.csv",
           "images": "sample_data/images", "image_captions": "sample_data/image_captions.csv"}
    kind = "images" if "train_data_path: sample_data/images" in text else "videos"
    edits = [("DATA_PATH: ./outputs\n", f"DATA_PATH: {data_path}\n"),
             (key[kind], train_data), (key[kind[:-1] + "_captions"], prompts), *edits]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in it once")
        text = text.replace(old, new)
    path = os.path.join(root, f"{os.path.basename(data_path)}_{name}")
    with open(path, "w") as fh:
        fh.write(text)
    values = load_yaml(path)
    if (values["DATA_PATH"], values["train_data_path"], values["train_prompt_path"]) != (
            data_path, train_data, prompts):
        raise RuntimeError(f"{name}: the copy reads back as {values}")
    return path, values


def write_sdxl_release(dev, root):
    """SDXL's towers (``inference_torch.build_modules``, a seeded fill),
    CLIP-L and OpenCLIP-bigG text towers with their tokenizers, as diffusers
    folders under ``root``; returns the training CLI's flags."""
    import argparse as _argparse

    import inference_torch
    from ctrl_adapter_tpu_torch.models.clip import CLIPTextConfig

    pipe = inference_torch.build_modules(
        _argparse.Namespace(model_name="sdxl", control_types=["depth"]), dev)
    for i, module in enumerate(inference_torch.towers(pipe).values()):
        random_fill(module, SEED + 60 + i)
    flags = write_stack(pipe, root)
    towers = [write_text_encoder(root, CLIPTextConfig(eos_token_id=2), SEED + 65,
                                 torch.float16, dev),
              write_text_encoder(root, CLIPTextConfig(hidden_size=1280, num_layers=32,
                                                      num_heads=20, intermediate_size=5120,
                                                      hidden_act="gelu", eos_token_id=2,
                                                      projection_dim=1280),
                                 SEED + 66, torch.float16, dev, subfolder="text_encoder_2",
                                 tokenizer="tokenizer_2", pad_token="!")]
    del pipe, towers
    gc.collect()
    torch.cuda.empty_cache()
    i = flags.index("--adapter_checkpoint_path")
    return flags[:i] + flags[i + 2:]


def real_train_run(label, argv, kernels, want, t_phase, check=None):
    """``train_cli_run`` on real data: prints the time each step's batch was
    waited for and the types of each step's batch, checks the launches per
    step against ``want``, that each step ran the ControlNet of its batch's
    type and ``check(run)``. Returns the run's counts, its validation files
    and the GiB it left on the card (``cuda_left``)."""
    from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer

    nets = []
    step = CtrlAdapterTrainer.train_step

    def with_net(fn):
        def run(self, *args, **kwargs):
            nets.append(self.experts[0])
            return fn(self, *args, **kwargs)
        return run

    with swapped(CtrlAdapterTrainer, "train_step", with_net):
        run, box = train_cli_run(label, argv, kernels)
    print(f"{label}: the run ended {time.perf_counter() - t_phase:.1f} s into phase 15")
    if CtrlAdapterTrainer.train_step is not step:
        raise RuntimeError(f"{label}: train_step was not restored")
    if len(run.wait_s) != len(run.records):
        raise RuntimeError(f"{label}: {len(run.wait_s)} batches for {len(run.records)} steps")
    check_train_launches(label, box, want)
    towers = []
    for types, net in zip(run.step_types, nets):
        if types:
            owner = [t for t, n in run.controlnet_by_type.items() if n is net]
            towers.append(owner)
            if owner != [types[0]]:
                raise RuntimeError(f"{label}: a {types[0]} batch ran the {owner} ControlNet")
    net = None  # the loop's name would keep the last ControlNet alive
    if check is not None:
        check(run)
    print(f"{label}: waited for the prefetcher "
          f"{', '.join(f'{1000 * w:.1f}' for w in run.wait_s)} ms before steps "
          f"{[r['step'] for r in run.records]}"
          + (f"; each step's batch type and the tower it ran: "
             f"{[(t[0], o[0]) for t, o in zip(run.step_types, towers)]}" if towers else ""))
    before = box["before_gb"]
    launches = box["launches"]
    validations = list(run.validations)
    del run, box, nets
    return launches, validations, cuda_left(label, before)


def pose_report(est, frames):
    """OpenPose on the card: its heatmaps' range, the peaks per part over
    ``frames`` and the people found per frame; then the decoding and the
    drawing on the host over ``pose_fields()``, its canvas held to the JAX
    package's (``POSE_CANVAS_SHA256``)."""
    import hashlib

    import numpy as np
    from ctrl_adapter_tpu_torch.conditions import openpose as op

    paf, heat = est.maps(np.stack(frames))
    masks = op.peak_masks(heat)
    people = []
    for i in range(len(frames)):
        peaks = op.find_peaks(heat[i], masks=masks[i])
        people.append(len(op.assemble_subsets(
            peaks, op.score_connections(paf[i], peaks, frames[i].shape[0]))[1]))
    print(f"openpose on the card: heatmaps in [{float(heat.min()):.4f}, "
          f"{float(heat.max()):.4f}]; peaks per part over the {len(frames)} frames "
          f"{masks.sum(dim=(0, 2, 3)).tolist()}; people found per frame {people}")
    del paf, heat, masks
    t0 = time.perf_counter()
    fheat, fpaf = pose_fields()
    peaks = op.find_peaks(torch.from_numpy(fheat))
    candidate, subset = op.assemble_subsets(
        peaks, op.score_connections(torch.from_numpy(fpaf), peaks, fheat.shape[0]))
    canvas = op.draw_bodypose(fheat.shape[0], fheat.shape[1], candidate, subset)
    digest = hashlib.sha256(canvas.tobytes()).hexdigest()
    same = digest == POSE_CANVAS_SHA256 and len(subset) == 2
    print(f"openpose decoding and drawing on this host over pose_fields(): "
          f"{sum(map(len, peaks))} peaks, {len(subset)} people, canvas sha256 {digest[:16]}... "
          f"{'equal to' if same else 'DIFFERENT FROM'} the JAX package's (cv2's drawing); "
          f"{1000 * (time.perf_counter() - t0):.1f} ms")
    if not same:
        raise RuntimeError("openpose: the decoded and drawn pose_fields() canvas differs")


def write_i2v_release(dev, root):
    """I2VGen-XL's UNet and VAE (``inference_torch.build_modules``, a seeded
    fill), its text tower (OpenCLIP ViT-H: 1024 wide, 23 layers) with a
    tokenizer, and the CLIP-H vision tower, as diffusers folders under
    ``root``."""
    import inference_torch
    from ctrl_adapter_tpu_torch.convert.release import save_release
    from ctrl_adapter_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig

    pipe = inference_torch.build_modules(
        argparse.Namespace(model_name="i2vgenxl", control_types=["depth"]), dev)
    for i, name in enumerate(("unet", "vae")):
        module = getattr(pipe, name)
        random_fill(module, SEED + 80 + i)
        save_release(module.state_dict(), os.path.join(root, name))
    written = [write_text_encoder(root, CLIPTextConfig(hidden_size=1024, num_layers=23,
                                                       num_heads=16, intermediate_size=4096,
                                                       hidden_act="gelu", eos_token_id=2),
                                  SEED + 82, torch.float16, dev),
               write_image_encoder(root, CLIPVisionConfig(), SEED + 83, torch.float16, dev)]
    del pipe, written
    gc.collect()
    torch.cuda.empty_cache()


def run_conditions(dev, card, kernels, serve_per_step, train_per_step, root):
    """Phase 15: condition extraction and the dataset path at full width.
    Fabricated checkpoints (seeded, scale 0.02): ``Intel/dpt-large`` (ViT-L/16
    at 384^2), MiDaS ``dpt_swin2_large_384``, SegFormer-b5 ADE 640 and the five
    lllyasviel/Annotators files in their released layouts (PiDiNet table 5,
    ControlNetHED, the lineart generator, NormalBAE's NNET, the OpenPose
    body). (1) Each extractor on phase 13's 14 frames of 512^2
    (``extractor_check``; OpenPose also ``pose_report``); (2)
    ``inference_torch.main --extract_control_conditions`` (SVD depth,
    ``--fake_weights``, 4 steps) from a working directory that holds
    ``Intel/dpt-large``; (3) ``train_torch.main`` on real data from phase
    13's diffusers folders under ``root``: SVD depth (2 steps, validation on
    the real batch), SVD mixed over the seven types of
    ``svd_train_mixed.yaml`` (2 steps), SDXL depth at 1024^2 (2 steps); (4) I2VGen-XL
    multi-condition (``i2vgenxl_train_multi_condition.yaml``: 7 ControlNets,
    a simple-weights router, 1-4 active, all seven conditions extracted for
    every clip; 2 steps, checkpoint-2's router read back). Returns the launch
    counts of (2)-(4)."""
    import numpy as np

    import inference_torch
    from ctrl_adapter_tpu_torch.conditions import extractors as ex
    from ctrl_adapter_tpu_torch.conditions import hed, lineart, normalbae, openpose, pidinet
    from ctrl_adapter_tpu_torch.conditions.dpt import DPT_LARGE_CONFIG
    from ctrl_adapter_tpu_torch.conditions.dpt_swin import DepthDPTSwin
    from ctrl_adapter_tpu_torch.conditions.segformer import SEGFORMER_B5_ADE_CONFIG
    from ctrl_adapter_tpu_torch.conditions.swin2 import SWIN2_LARGE_384
    from ctrl_adapter_tpu_torch.train import checkpoints
    from ctrl_adapter_tpu_torch.utils.image import image_to_unit

    t_phase = time.perf_counter()

    def mark(what):
        print(f"[phase 15: {what} at {time.perf_counter() - t_phase:.1f} s]")

    counts, left = {}, []  # left: (run, GiB it left on the card), checked at the end
    start_gb = torch.cuda.memory_allocated() / 2 ** 30
    annot = os.path.join(root, "annotators")
    dpt_dir = os.path.join(annot, ex.DEFAULT_PATHS["depth"])
    seg_dir = os.path.join(annot, ex.DEFAULT_PATHS["segmentation"])
    midas = os.path.join(annot, "dpt_swin2_large_384.pt")
    t0 = time.perf_counter()
    for module in (write_dpt(dpt_dir, DPT_LARGE_CONFIG, SEED + 50, dev),
                   write_midas(midas, SWIN2_LARGE_384, SEED + 51, dev),
                   write_segformer(seg_dir, SEGFORMER_B5_ADE_CONFIG, SEED + 52, dev)):
        n = sum(p.numel() for p in module.parameters())
        print(f"phase 15: wrote {type(module).__name__} ({n / 1e6:.1f} M parameters, fp32)")
        del module
    torch.cuda.empty_cache()
    paths = write_annotators(os.path.join(annot, "lllyasviel_Annotators"), SEED + 55, dev)
    print(f"phase 15: the eight checkpoints written in {time.perf_counter() - t0:.1f} s")

    # (1) each extractor on phase 13's frames, on the card and against the CPU
    frames = smooth_frames(np.random.default_rng(SEED + 13), FRAMES, SIZE)
    dpt, seg = ex.DepthDPT(dpt_dir, dev), ex.SegmentationSegformer(seg_dir, dev)
    swin = DepthDPTSwin(midas, SWIN2_LARGE_384, device=dev)
    # one uint8 step in each network's input units: 1 / 255 over the std
    for label, est, step in (("depth (DPT-L, Intel/dpt-large)", dpt, 1 / 255 / 0.5),
                             ("depth (MiDaS dpt_swin2_large_384)", swin, 1 / 255 / 0.5),
                             ("segmentation (SegFormer-b5 ADE 640)", seg,
                              1 / 255 / min(seg.processor.image_std))):
        cpu = _cpu_copy(est)
        extractor_check(label, est, cpu, frames, card, kernels, (est.model, cpu.model), step)
    del est, cpu, swin, seg  # the loop's names would keep the last network alive
    gc.collect()
    torch.cuda.empty_cache()
    on_card, on_cpu = ex.ConditionExtractor(device=dev), ex.ConditionExtractor(device="cpu")
    for ctype in ("canny", "shuffle"):
        extractor_check(ctype, lambda f, c=ctype: on_card.extract(c, f),
                        lambda f, c=ctype: on_cpu.extract(c, f), frames, card, kernels)
    # the five annotator networks: (label, estimator, the input step, the
    # calls checked as (label suffix, keyword arguments, maps equal))
    nets = (("softedge (PiDiNet table 5)", lambda: pidinet.SoftEdgePidiNet(paths["softedge"], dev),
             1 / 255, (("", {}, False),)),
            ("HED (ControlNetHED)", lambda: hed.ScribbleHED(paths["scribble"], dev), 1.0,
             ((", soft edges", {"scribble": False}, False),
              (", scribble", {"scribble": True}, True))),
            ("lineart (sk_model, 3 residual blocks)",
             lambda: lineart.LineartDetector(paths["lineart"], dev), 1 / 255, (("", {}, False),)),
            ("normal (NormalBAE NNET, tf_efficientnet_b5_ap)",
             lambda: normalbae.NormalBaeDetector(paths["normal"], dev),
             1 / 255 / min(normalbae.IMAGENET_STD), (("", {}, False),)),
            ("openpose (body_pose_model)", lambda: openpose.OpenposeDetector(paths["openpose"], dev),
             1 / 256, (("", {}, True),)))
    for label, make, step, calls in nets:
        est = make()
        print(f"{label}: {sum(p.numel() for p in est.model.parameters()) / 1e6:.2f} M "
              f"parameters as loaded, fp32")
        cpu = _cpu_copy(est)
        for suffix, kw, exact in calls:
            extractor_check(label + suffix, lambda f, e=est, k=kw: e(f, **k),
                            lambda f, c=cpu, k=kw: c(f, **k), frames, card, kernels,
                            (est.model, cpu.model), step, exact=exact)
        if isinstance(est, openpose.OpenposeDetector):
            pose_report(est, frames)
        del est, cpu
        gc.collect()
        torch.cuda.empty_cache()
    mark("(1) the extractors done")

    # (2) the serving CLI extracting depth on the fly
    seen = []

    def recorded(load):
        def run(*args, **kwargs):
            seen.append((args[3], load(*args, **kwargs)))
            return seen[-1][1]
        return run

    argv = ["--model_name", "svd", "--control_types", "depth", "--skip_conv_in", "True",
            "--n_sample_frames", str(FRAMES), "--height", str(SIZE), "--width", str(SIZE),
            "--num_inference_steps", str(CLI_STEPS), "--evaluation_input_folder",
            os.path.join(root, "fixture"), "--evaluation_output_folder",
            os.path.join(root, "out_extract"), "--fake_weights",
            "--extract_control_conditions", "True"]
    with contextlib.chdir(annot), swapped(inference_torch, "load_conditions", recorded), \
            swapped(inference_torch, "fabricate_params", fill_on_card(SEED + 70)):
        run, box = cli_run("cli (c) --extract_control_conditions", argv, kernels)
    check_cli_run("cli (c) --extract_control_conditions", run, box, serve_per_step, card)
    used, conds = seen[0]
    same = len(seen) == 1 and np.array_equal(
        conds[0], np.stack([image_to_unit(m) for m in dpt(used)]))
    print(f"cli (c): the CLI's depth conditions {conds.shape} "
          f"{'equal' if same else 'DIFFER FROM'} DepthDPT's direct output on the same frames")
    if not same or not all(np.array_equal(a, b) for a, b in zip(used, frames)):
        raise RuntimeError("cli (c): the extracted conditions differ from DepthDPT's, or the "
                           "CLI read other frames than (1)'s")
    counts["cli_extract"] = box["launches"]
    del run, box, seen, used, conds, dpt, on_card, on_cpu
    left.append(("(1)-(2)", cuda_left("phase 15 (1)-(2)", start_gb)))
    mark("(2) the serving CLI done")

    # (3) the training CLI on real data
    clips, clip_csv = write_clip_folder(os.path.join(root, "clips"), 2, 20, SIZE, SEED + 53)
    images, image_csv = write_image_folder(os.path.join(root, "images"), 2, SDXL_SIZE, SEED + 54)
    release, sd15 = os.path.join(root, "release"), os.path.join(root, "sd15")
    towers = ["--pretrained_model_path", release, "--controlnet_text_encoder_path", sd15,
              "--seed", str(SEED)]

    def controlnets(types):
        """One folder per type: phase 13's depth ControlNet, linked."""
        out = []
        for ctype in types:
            link = os.path.join(root, f"controlnet_{ctype}")
            if not os.path.exists(link):
                os.symlink(os.path.join(release, "controlnet"), link)
            out.append(link)
        return out

    annotators = {"depth": dpt_dir, "segmentation": seg_dir, **paths}
    with environ({"CTRL_ADAPTER_ANNOTATORS": json.dumps(annotators)}):
        cfg, _ = data_config("svd_train_depth.yaml", root, os.path.join(root, "r_svd"), clips,
                             clip_csv)
        launches, validations, gib = real_train_run(
            "train CLI (e) svd depth, real data", [
                "--yaml_file", cfg, *towers, "--max_train_steps", "2",
                "--controlnet_model_paths", os.path.join(release, "controlnet"),
                "--run_validation", "--validate_every_steps", "2", "--num_inference_steps",
                str(CLI_STEPS), "--save_starting_step", "3"],
            kernels, train_per_step, t_phase)
        counts["train_real_svd"] = launches
        left.append(("svd", gib))
        gif = os.path.join(root, "r_svd", "validation", "step_2.gif")
        shapes = []
        for path in (gif, gif.replace(".gif", "_concat.gif")):
            with open(path, "rb") as fh:
                shapes.append(decode_gif(fh.read()).shape)
        print(f"train CLI (e): validation on the step's real batch: step_2.gif {shapes[0]}, "
              f"step_2_concat.gif {shapes[1]}")
        if validations != [gif] or shapes != [(FRAMES, SIZE, SIZE, 3),
                                              (FRAMES, SIZE, 2 * SIZE, 3)]:
            raise RuntimeError(f"train CLI (e): validation {validations}, {shapes}")

        # svd_train_mixed.yaml as it stands: seven types, one ControlNet folder each
        cfg, values = data_config("svd_train_mixed.yaml", root, os.path.join(root, "r_mixed"),
                                  clips, clip_csv)
        types = values["mixed_control_types_training"]
        if sorted(types) != sorted(ex.MULTI_CONDITION_EXPERT_ORDER):
            raise RuntimeError(f"svd_train_mixed.yaml copy: {values}")
        counts["train_real_mixed"], _, gib = real_train_run(
            f"train CLI (e) svd mixed over the {len(types)} types of svd_train_mixed.yaml, "
            f"real data", ["--yaml_file", cfg, *towers, "--max_train_steps", "2",
                           "--save_starting_step", "3", "--controlnet_model_paths",
                           *controlnets(types)], kernels, train_per_step, t_phase)
        left.append(("mixed", gib))
        mark("(3) the SVD runs done")

        t0 = time.perf_counter()
        sdxl_root = os.path.join(root, "sdxl")
        sdxl_flags = write_sdxl_release(dev, sdxl_root)
        print(f"train CLI (e) sdxl: wrote the SDXL towers, CLIP-L and bigG in "
              f"{time.perf_counter() - t0:.1f} s")
        cfg, _ = data_config("sdxl_train_depth.yaml", root, os.path.join(root, "r_sdxl"),
                             images, image_csv)
        counts["train_real_sdxl"], _, gib = real_train_run(
            "train CLI (e) sdxl depth, real data", [
                "--yaml_file", cfg, *sdxl_flags, "--max_train_steps", "2", "--seed", str(SEED),
                "--save_starting_step", "3"], kernels, sdxl_train_launches(), t_phase)
        left.append(("sdxl", gib))
        shutil.rmtree(sdxl_root)
        mark("(3) the SDXL run done")

        # (4) I2VGen-XL multi-condition on real data: every clip's seven conditions
        t0 = time.perf_counter()
        i2v_root = os.path.join(root, "i2v")
        write_i2v_release(dev, i2v_root)
        print(f"train CLI (f) i2vgenxl: wrote the I2VGen-XL UNet, VAE, OpenCLIP-H text and "
              f"CLIP-H vision towers in {time.perf_counter() - t0:.1f} s")
        data_f = os.path.join(root, "r_multi")
        cfg, values = data_config("i2vgenxl_train_multi_condition.yaml", root, data_f, clips,
                                  clip_csv)
        types = values["control_types"]
        extracted = []
        extract = ex.ConditionExtractor.extract

        def counting(self, ctype, images):
            extracted.append((ctype, len(images)))
            return extract(self, ctype, images)

        def multi_check(run):
            n_on = []
            for rec, mask in zip(run.records, run.expert_masks):
                w, off = np.asarray(rec["down_block_weights"]), np.asarray(mask) == 0
                n_on.append(int(sum(mask)))
                if not (1 <= n_on[-1] <= values["max_num_multi_source_train"]
                        and (w[:, off] == 0).all()):
                    raise RuntimeError(f"train CLI (f): mask {mask}, router weights {w}")
            per_type = {t: sum(1 for c, _ in extracted if c == t) for t in types}
            router = torch.load(os.path.join(data_f, "checkpoint-2", "router_2",
                                             checkpoints.WEIGHTS_NAME), weights_only=True)
            same = (run.checkpoints == [os.path.join(data_f, "checkpoint-2")]
                    and states_equal(router, run.trainer.router_state()))
            print(f"train CLI (f) i2vgenxl: {len(run.trainer.experts)} ControlNets, {n_on} "
                  f"experts active per step, the masked ones' router weights exactly 0; "
                  f"extraction calls per type {per_type} of {sorted({n for _, n in extracted})} "
                  f"frames; checkpoint-2/router_2 read back "
                  f"{'equal to the bit' if same else 'DIFFERENT'}")
            if min(per_type.values()) < len(run.records):
                raise RuntimeError("train CLI (f): a type was extracted for fewer items than "
                                   "steps")
            if not same:
                raise RuntimeError("train CLI (f): the router's checkpoint differs")

        with swapped(ex.ConditionExtractor, "extract", lambda _: counting):
            counts["train_real_i2vgenxl_multi"], _, gib = real_train_run(
                "train CLI (f) i2vgenxl multi-condition, real data", [
                    "--yaml_file", cfg, "--pretrained_model_path", i2v_root,
                    "--controlnet_text_encoder_path", sd15, "--controlnet_model_paths",
                    *controlnets(types), "--max_train_steps", "2", "--checkpointing_steps", "2",
                    "--seed", str(SEED)],
                kernels, i2v_train_launches(), t_phase, check=multi_check)
        left.append(("i2vgenxl multi", gib))
        shutil.rmtree(i2v_root)
        shutil.rmtree(data_f)
    print(f"phase 15 on {card}: {time.perf_counter() - t_phase:.1f} s")
    leaks = [(what, gib) for what, gib in left if gib > 0.5]
    if leaks:
        raise RuntimeError(f"phase 15: runs left memory on the card (GiB): {leaks}")
    return counts



# ------------------------------- phase 16, fp32 towers and data-parallel generation
# Each fp32 kernel against its plain version (TF32 off for the plain
# products): both compute in fp32, in other summation orders, so the outputs
# agree to a few fp32 roundings; a wrong tile, row or head moves them by far
# more than this share of their norm.
FP32_TOL = 1e-5
FP32_FRAMES = 14      # the fp32 training run at the width of svd_train_depth.yaml
FP32_TRAIN_STEPS = 2
# K2 fp32 and its backward at SDXL's fp32 training shapes too (1 x 1024^2: the
# adapter's A blocks at 128^2 tokens, the UNet's at 64^2 and 32^2)
SDXL_FP32_SHAPES = ((1, 5, 16384, 64), (1, 10, 4096, 64), (1, 20, 1024, 64))
MESH_BATCH = 2        # SVD generate(mesh=...) under a one-rank group: videos, steps
MESH_STEPS = 2
FP32_KERNELS = {  # name: (source, replaces)
    "group_norm_silu_fp32": ("ctrl_adapter_tpu_torch/csrc/group_norm.cu",
                             "ctrl_adapter_tpu/ops/group_norm.py:166 (fp32 input)"),
    "flash_attention_fp32": ("ctrl_adapter_tpu_torch/csrc/flash_attention_fp32.cu",
                             "ctrl_adapter_tpu/ops/flash_attention.py:97 (fp32 input)"),
    "flash_attention_fp32_bwd": (
        "ctrl_adapter_tpu_torch/csrc/flash_attention_fp32_bwd.cu",
        "ctrl_adapter_tpu/ops/flash_attention.py:97 (the custom VJP's _flash_attention_bwd_dkv, "
        "_flash_attention_bwd_dq; fp32 input)"),
}


def fp32_counters():
    """The launch counter of each fp32 kernel (name: ``Kernel``)."""
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    return {"group_norm_silu_fp32": gn.KERNEL_FP32, "flash_attention_fp32": fa.KERNEL_FP32,
            "flash_attention_fp32_bwd": fa.KERNEL_FP32_BWD}


def sdpa_fp32_times(q, k, v, do=None):
    """``F.scaled_dot_product_attention`` on fp32 inputs: the default backend
    named, and the memory-efficient one forced (the fused backend that takes
    fp32; flash and cuDNN take 16-bit types only); with ``do``, their
    backward (forward + backward, minus the forward). Yardsticks only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    default = SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    qg, kg, vg = (x.detach().requires_grad_(do is not None) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg)  # noqa: E731
    times = {}
    for name, backends in (("SDPA EFFICIENT_ATTENTION", [SDPBackend.EFFICIENT_ATTENTION]),
                           (f"SDPA default ({default})", None)):
        try:
            with (sdpa_kernel(backends) if backends else contextlib.nullcontext()):
                fwd = cuda_ms(sdpa, iters=3, reps=3)
                if do is not None:
                    both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do),
                                   iters=3, reps=3)
            times[name + (" backward" if do is not None else "")] = (
                fwd if do is None else both - fwd)
        except RuntimeError:
            times[name] = None
    return times


def print_launch_times(label, fn):
    """Each device kernel's ms in one call of ``fn`` (``kernel_times``, one
    attempt: late in the script the profiler mostly keeps too few events, and
    the call's own device time comes from ``warm_ms``): the fp32 kernels'
    split prologue beside their main kernels."""
    times = kernel_times(fn, iters=3, attempts=1)
    print(f"    {label} launches (device ms, warm L2): " + (
        "not measured" if times is None else
        ", ".join(f"{name} {t:.3f}" for name, t in times.items())))


def fp32_rel(name, got, want, atol=1e-4):
    """An fp32 kernel's output against its plain version's: within FP32_TOL of
    its norm (and ``atol`` + 1e-4 relative elementwise); returns the max abs."""
    return compare(name, got, want, atol=atol, rtol=1e-4, rel_norm=FP32_TOL)


def k1_fp32_row(rand, flush, shape, silu, n):
    """K1 fp32 at ``shape`` (G = 32, eps 1e-6): one launch on K1 fp32's
    counter, within FP32_TOL of the plain version's norm, the same bits over
    two calls; timed on the host clock beside its bound, its plain version
    and ``F.group_norm`` (with SiLU also ``F.silu(F.group_norm)``), then on
    the card's clock (``warm_ms``, ``cold_ms``) beside ``F.group_norm`` fp32
    on the same clocks; ``n`` launches per adapter call."""
    import torch.nn.functional as F

    from ctrl_adapter_tpu_torch.ops import group_norm as gn
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    x, w, b = rand(*shape), 1.0 + rand(shape[1], scale=0.1), rand(shape[1], scale=0.1)
    label = f"({','.join(map(str, shape))})" + (" silu" if silu else "")
    kernel = lambda: gn.group_norm_silu(x, w, b, 32, 1e-6, silu)  # noqa: E731
    before = gn.KERNEL_FP32.launches
    got = kernel()
    torch.cuda.synchronize()
    if gn.KERNEL_FP32.launches != before + 1:
        raise RuntimeError(f"K1 fp32 {label}: {gn.KERNEL_FP32.launches - before} launches")
    err = fp32_rel(f"K1 fp32 {label} ({n} per adapter call)", got,
                   gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu))
    if not torch.equal(got, kernel()):
        raise RuntimeError(f"K1 fp32 {label}: two calls differ")
    del got
    ms = cuda_ms(kernel)
    pms = cuda_ms(lambda: gn._torch_group_norm_silu(x, w, b, 32, 1e-6, silu))
    yard = lambda: F.group_norm(x, 32, w, b, 1e-6)  # noqa: E731
    library = {"F.group_norm fp32": cuda_ms(yard)}
    if silu:
        library["F.silu(F.group_norm) fp32"] = cuda_ms(lambda: F.silu(yard()))
    row = report(label, err, ms, pms, rl.group_norm(shape, silu, 4), library, not silu)
    warm, cold = warm_ms(kernel), cold_ms(kernel, flush)
    ywarm, ycold = warm_ms(yard), cold_ms(yard, flush)
    bound = row["bound_ms"]
    branch = gn.plan(shape, 32, itemsize=4,
                     sms=torch.cuda.get_device_properties(0).multi_processor_count).branch
    print(f"    device ({branch}): kernel {warm:.4f} ms warm L2 ({100 * bound / warm:.1f} % of "
          f"the bound), {cold:.4f} ms cold L2 ({100 * bound / cold:.1f} %); F.group_norm fp32 "
          f"{ywarm:.4f} warm, {ycold:.4f} cold; faster than it: "
          + ("met" if cold < ycold and warm < ywarm else "NOT met"))
    row.update(per_adapter_call=n, plan=branch, device_ms=warm, cold_ms=cold,
               library_device_ms=ywarm, library_cold_ms=ycold)
    return row


def check_fp32_kernels(dev, card):
    """Phase 16 (1): K1 fp32, K2 fp32 and K2 bwd fp32 at the fp32 training
    paths' shapes against their plain versions, TF32 off: K1 at the adapter
    norms JAX admits at itemsize 4 for SVD (``k1_rows(FP32_FRAMES, 1, 4)``),
    I2VGen-XL (``k1_rows(I2V_FRAMES, 1, 4)``) and SDXL
    (``sdxl_k1_rows(batch=1, itemsize=4)``), ``k1_fp32_row``, with each
    model's sums over one adapter call; K2 and its backward at SVD's UNet and
    adapter spatial attentions and ``SDXL_FP32_SHAPES``, the backward's
    gradients equal to the bit over two calls. Times beside the bounds
    (``ops/roofline.py``: K1 fp32 at 67 TFLOP/s on the CUDA cores, K2 fp32
    and its backward at the 3xTF32 rate they run at) and SDPA's
    memory-efficient backend, forward and backward, on the host clock and on
    the card's (``warm_ms``, ``cold_ms``). Returns {name: [rows]}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import roofline as rl

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("phase 16: TF32 must be off for the fp32 plain versions")
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = {name: [] for name in FP32_KERNELS}
    print(f"phase 16 (1): the fp32 kernels against their plain versions (fp32, TF32 off; "
          f"tolerance ||err|| <= {FP32_TOL} ||plain||) on {card}")
    frames = FP32_FRAMES
    for model, k1 in (("SVD", k1_rows(frames, 1, 4)), ("I2VGen-XL", k1_rows(I2V_FRAMES, 1, 4)),
                      ("SDXL", sdxl_k1_rows(batch=1, itemsize=4))):
        model_rows = [k1_fp32_row(rand, flush, shape, silu, n) for (shape, silu), n in k1.items()]
        launches = sum(r["per_adapter_call"] for r in model_rows)
        bound = sum(r["per_adapter_call"] * r["bound_ms"] for r in model_rows)
        for field, what in (("device_ms", "warm L2"), ("cold_ms", "cold L2"),
                            ("library_cold_ms", "cold L2, F.group_norm fp32")):
            t = sum(r["per_adapter_call"] * r[field] for r in model_rows)
            print(f"  K1 fp32 per {model} adapter call (device, {what}): {launches} launches, "
                  f"{t:.4f} ms against {bound:.4f} ms of bound ({100 * bound / t:.1f} %)")
        rows["group_norm_silu_fp32"] += model_rows
    # the K1 fp32 rows with the one PyTorch call first: the JSON line takes row 0
    rows["group_norm_silu_fp32"].sort(key=lambda r: r["library_ms"] is None)
    for shape in ((frames, 5, 4096, 64), (frames, 10, 1024, 64), *SDXL_FP32_SHAPES):
        b, n_heads, t, hd = shape
        label = f"({','.join(map(str, shape))})"
        q, k, v, do = (rand(b, t, n_heads * hd).view(b, t, n_heads, hd).transpose(1, 2)
                       for _ in range(4))
        out, lse = fa._forward(q, k, v, True)
        want, want_lse = fa._torch_attention(q, k, v, True)
        torch.cuda.synchronize()
        err = fp32_rel(f"K2 fp32 {label} output", out, want)
        compare(f"K2 fp32 {label} log-sum-exp", lse, want_lse, atol=1e-4, rtol=1e-5,
                rel_norm=FP32_TOL)
        del want, want_lse
        fwd = lambda: fa.attention_bnth(q, k, v)  # noqa: E731
        ms = cuda_ms(fwd, iters=3, reps=5)
        print_launch_times(f"K2 fp32 {label}", fwd)
        pms = cuda_ms(lambda: fa._torch_attention(q, k, v), iters=3, reps=3, warmup=1)
        row = report(label, err, ms, pms, rl.attention(*shape[:3], t, hd, itemsize=4),
                     sdpa_fp32_times(q, k, v))

        def efficient(run):
            def call():
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    return run()
            return call

        sdpa = efficient(lambda: F.scaled_dot_product_attention(q, k, v))
        device_line(row, fwd, flush, ("SDPA EFFICIENT_ATTENTION", sdpa), profiler=False,
                    heavy=True)
        rows["flash_attention_fp32"].append(row)
        got = fa.attention_bnth_bwd(q, k, v, out, do, lse)
        want = fa._torch_attention_bwd(q, k, v, out, do, lse)
        torch.cuda.synchronize()
        err = max(fp32_rel(f"K2 bwd fp32 {label} d{name}", x, y,
                           atol=1e-4 * y.abs().max().item())
                  for name, x, y in zip("qkv", got, want))
        again = fa.attention_bnth_bwd(q, k, v, out, do, lse)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(got, again)]
        print(f"  K2 bwd fp32 {label}, two calls: dQ, dK, dV "
              f"{'equal to the bit' if all(same) else f'DIFFER {same}'}")
        if not all(same):
            raise RuntimeError(f"K2 bwd fp32 {label}: the gradients differ between two calls")
        del got, want, again
        bwd = lambda: fa.attention_bnth_bwd(q, k, v, out, do, lse)  # noqa: E731
        ms = cuda_ms(bwd, iters=3, reps=3)
        print_launch_times(f"K2 bwd fp32 {label}", bwd)
        pms = cuda_ms(lambda: fa._torch_attention_bwd(q, k, v, out, do, lse), iters=3, reps=3,
                      warmup=1)
        row = report(label, err, ms, pms, rl.attention_bwd(*shape, itemsize=4),
                     sdpa_fp32_times(q, k, v, do))
        # SDPA's backward alone: its forward and backward on the card's clocks, less the forward
        qg, kg, vg = (z.detach().requires_grad_() for z in (q, k, v))
        both = efficient(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do))
        device_line(row, bwd, flush, ("SDPA EFFICIENT_ATTENTION forward + backward", both),
                    profiler=False, heavy=True)
        fwd_warm, fwd_cold = device_times(sdpa, flush, profiler=False, heavy=True)
        row.update(library_device_ms=row["library_device_ms"] - fwd_warm,
                   library_cold_ms=row["library_cold_ms"] - fwd_cold)
        print(f"    device: SDPA EFFICIENT_ATTENTION backward {row['library_device_ms']:.4f} ms "
              f"warm L2, {row['library_cold_ms']:.4f} ms cold L2 (less its forward)")
        rows["flash_attention_fp32_bwd"].append(row)
        del q, k, v, do, out, lse, qg, kg, vg
    torch.cuda.empty_cache()
    return rows


def fp32_train_launches(bf16_per_step):
    """The fp32 kernels' launches per step of the fp32 training run: K1 fp32
    at the adapter norms of ``k1_rows(FP32_FRAMES, 1, 4)``, forward and
    recompute; K2 fp32 and its backward as often as the bf16 step launches K2
    and its backward (``bf16_per_step``, phase 8's: the attention dispatch
    does not read the dtype); no bf16 kernel."""
    return {"group_norm_silu_fp32": 2 * sum(k1_rows(FP32_FRAMES, 1, 4).values()),
            "flash_attention_fp32": bf16_per_step["flash_attention"],
            "flash_attention_fp32_bwd": bf16_per_step["flash_attention_bwd"]}


def run_fp32_training(dev, card, root, bf16_per_step):
    """Phase 16 (2): ``train_torch.main`` with ``--mixed_precision no`` at the
    full width of ``configs/svd_train_depth.yaml`` (1 x 14 x 512^2, fp32
    towers, ``--fake_weights``), 2 steps and a validation sample: finite
    losses, the fp32 kernels launched per step (``fp32_train_launches``) and
    no bf16 kernel, the gif; ms per step and peak GiB. Returns the fp32
    kernels' launches in the run."""
    frames = FP32_FRAMES
    cfg, _ = config_copy("svd_train_depth.yaml", root, os.path.join(root, "fp32"))
    counters = {**kernel_counters(), **fp32_counters()}
    argv = ["--yaml_file", cfg, "--fake_weights", "--mixed_precision", "no",
            "--max_train_steps", str(FP32_TRAIN_STEPS), "--run_validation",
            "--validate_every_steps", str(FP32_TRAIN_STEPS), "--save_starting_step",
            str(FP32_TRAIN_STEPS + 1), "--seed", str(SEED)]
    import train_torch

    val_s = []

    def timed(validate):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(*args, **kwargs)
            torch.cuda.synchronize()
            val_s.append(time.perf_counter() - t0)
            return out
        return run

    with swapped(train_torch, "run_validation", timed):
        run, box = train_cli_run("phase 16 (2) train CLI svd --mixed_precision no", argv,
                                 counters)
    want = fp32_train_launches(bf16_per_step)
    check_fp32_run("phase 16 (2) svd", run, box, counters, want)
    with open(run.validations[0], "rb") as fh:
        gif = decode_gif(fh.read())
    if gif.shape != (frames, SIZE, SIZE, 3):
        raise RuntimeError(f"phase 16 (2): validation gif {gif.shape}")
    ms = [1000 * t for t in run.step_s]
    print(f"phase 16 (2): K1 fp32, K2 fp32, K2 bwd fp32 per step "
          f"{[want[n] for n in FP32_KERNELS]} in each of {len(box['steps'])} steps, no bf16 "
          f"kernel; validation {os.path.basename(run.validations[0])} decodes to {gif.shape}")
    print(f"phase 16 (2) on {card}: fp32 training 1x{frames}x{SIZE}x{SIZE}, fp32 towers and "
          f"masters, gradient checkpointing: step 1 {ms[0]:.1f} ms, "
          + (f"step 2 {ms[1]:.1f} ms" if len(ms) > 1 else "")
          + f"; validation (4 steps and the decode) {sum(val_s):.2f} s; peak "
          f"{box['peak_gb']:.2f} GiB")
    launches = {n: box["launches"][n] for n in FP32_KERNELS}
    before = box["before_gb"]
    del run, box
    released("phase 16 (2)", before)
    return launches, ms


def check_fp32_run(label, run, box, counters, want):
    """An fp32 training run: each step launched ``want`` of each counted
    kernel (0 where ``want`` has no entry: no bf16 kernel), FP32_TRAIN_STEPS
    steps, fp32 towers and masters."""
    for i, step in enumerate(box["steps"]):
        wrong = {n: (step[n], want.get(n, 0)) for n in counters if step[n] != want.get(n, 0)}
        if wrong:
            raise RuntimeError(f"{label} step {i + 1}: launches (got, want) {wrong}")
    if len(box["steps"]) != FP32_TRAIN_STEPS:
        raise RuntimeError(f"{label}: {len(box['steps'])} steps, want {FP32_TRAIN_STEPS}")
    if any(m.dtype != torch.float32 for m in run.trainer.optimizer.masters) or any(
            p.dtype != torch.float32 for p in run.trainer.unet.parameters()):
        raise RuntimeError(f"{label}: the towers or masters are not fp32")


def sdxl_fp32_train_launches():
    """The fp32 kernels' launches per step of SDXL's fp32 training run at
    1 x 1024^2: K1 fp32 at the SDXL adapter's norms JAX admits at itemsize 4,
    forward and recompute; K2 fp32 and its backward as often as the bf16 SDXL
    step launches K2 and its backward (``sdxl_train_launches``); no bf16
    kernel."""
    bf16 = sdxl_train_launches()
    return {"group_norm_silu_fp32": 2 * sum(sdxl_k1_rows(batch=1, itemsize=4).values()),
            "flash_attention_fp32": bf16["flash_attention"],
            "flash_attention_fp32_bwd": bf16["flash_attention_bwd"]}


def i2v_fp32_train_launches():
    """The fp32 kernels' launches per step of I2VGen-XL's fp32 training run
    at 1 x 16 x 512^2: K1 fp32 at the adapter norms JAX admits at itemsize 4
    (``k1_rows(I2V_FRAMES, 1, 4)``), forward and recompute; K2 fp32 and its
    backward as often as the bf16 I2VGen-XL step launches K2 and its backward
    (``i2v_train_launches``); no bf16 kernel."""
    bf16 = i2v_train_launches()
    return {"group_norm_silu_fp32": 2 * sum(k1_rows(I2V_FRAMES, 1, 4).values()),
            "flash_attention_fp32": bf16["flash_attention"],
            "flash_attention_fp32_bwd": bf16["flash_attention_bwd"]}


def run_fp32_branch(card, root, model, config, want, cell):
    """Phase 16 (2), a training branch: ``train_torch.main`` with
    ``--mixed_precision no`` on ``configs/{config}`` (fp32 towers,
    ``--fake_weights``), FP32_TRAIN_STEPS steps: finite losses, the fp32
    kernels launched per step as ``want`` and no bf16 kernel, fp32 towers and
    masters; ms per step and peak GiB. Returns the fp32 kernels' launches in
    the run."""
    cfg, _ = config_copy(config, root, os.path.join(root, f"fp32_{model}"))
    counters = {**kernel_counters(), **fp32_counters()}
    argv = ["--yaml_file", cfg, "--fake_weights", "--mixed_precision", "no",
            "--max_train_steps", str(FP32_TRAIN_STEPS), "--save_starting_step",
            str(FP32_TRAIN_STEPS + 1), "--seed", str(SEED)]
    run, box = train_cli_run(f"phase 16 (2) train CLI {model} --mixed_precision no", argv,
                             counters)
    check_fp32_run(f"phase 16 (2) {model}", run, box, counters, want)
    ms = [1000 * t for t in run.step_s]
    print(f"phase 16 (2): {model} K1 fp32, K2 fp32, K2 bwd fp32 per step "
          f"{[want[n] for n in FP32_KERNELS]} in each of {len(box['steps'])} steps, no bf16 "
          f"kernel")
    print(f"phase 16 (2) on {card}: {model} fp32 training {cell}, fp32 towers and masters, "
          f"gradient checkpointing: "
          + ", ".join(f"step {i + 1} {t:.1f} ms" for i, t in enumerate(ms))
          + f"; peak {box['peak_gb']:.2f} GiB")
    launches = {n: box["launches"][n] for n in FP32_KERNELS}
    before = box["before_gb"]
    del run, box
    released(f"phase 16 (2) {model}", before)
    return launches


def mesh_inputs(dev, dtype, b, frames, size, seed):
    """A global batch of ``b`` SVD videos from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale: (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)  # noqa: E731
    lat = size // 8
    return dict(image_embeddings=r(b, 1, 1024, scale=0.1), image_latent=r(b, lat, lat, 4, scale=0.1),
                controlnet_prompt_embeds=r(2 * b, 77, 768, scale=0.02),
                control_images=torch.rand(b * frames, size, size, 3, generator=g,
                                          device=dev).to(dtype))


def run_mesh_generate(dev, card):
    """Phase 16 (3): ``SVDControlNetAdapterPipeline.generate(mesh=...)`` at full
    width under a one-rank NCCL group (torchrun's variables for a world of
    one), batch 2, 2 steps, the latents drawn from a seeded generator, against
    the same call without a mesh."""
    from ctrl_adapter_tpu_torch.parallel import mesh as meshes

    pipe, _ = build_pipeline(dev, torch.bfloat16)
    x = mesh_inputs(dev, torch.bfloat16, MESH_BATCH, FRAMES, SIZE, SEED + 61)
    kw = dict(num_frames=FRAMES, num_inference_steps=MESH_STEPS, skip_conv_in=True,
              control_latent_size=SIZE // 8)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 62)  # noqa: E731
    torchrun = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    with environ(torchrun):
        mesh = meshes.join(dev)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded = pipe.generate(**x, **kw, generator=gen(), mesh=mesh)
            torch.cuda.synchronize()
            t_mesh = time.perf_counter() - t0
        finally:
            meshes.leave(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone = pipe.generate(**x, **kw, generator=gen())
    torch.cuda.synchronize()
    t_alone = time.perf_counter() - t0
    if tuple(sharded.shape) != (MESH_BATCH, FRAMES, SIZE, SIZE, 3):
        raise RuntimeError(f"phase 16 (3): output {tuple(sharded.shape)}")
    same = torch.equal(sharded, alone)
    err = (sharded.float() - alone.float()).abs().max().item()
    print(f"phase 16 (3) on {card}: SVD generate(mesh=...) under a one-rank NCCL group, "
          f"{MESH_BATCH} x {FRAMES} x {SIZE}^2, {MESH_STEPS} steps: output "
          f"{tuple(sharded.shape)}, {'equal to the bit' if same else 'DIFFERENT'} to the run "
          f"without a mesh (max abs {err:.3e}); {t_mesh:.2f} s with the mesh, {t_alone:.2f} s "
          f"without (the decode included)")
    if not same:
        raise RuntimeError("phase 16 (3): the one-rank mesh changes the output")
    del pipe, sharded, alone
    gc.collect()
    torch.cuda.empty_cache()


def run_phase16(dev, card, bf16_per_step):
    """Phase 16: (1) the fp32 kernels, (2) fp32 training, SVD
    (``bf16_per_step``: phase 8's launches per step), SDXL and I2VGen-XL, (3)
    generate(mesh=...). Returns the fp32 kernels' rows and their launches in
    the SVD run and ({run: launches}) in the others."""
    import tempfile

    t_phase = time.perf_counter()
    rows = check_fp32_kernels(dev, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_fp32_")
    try:
        launches, _ = run_fp32_training(dev, card, root, bf16_per_step)
        launches_sdxl = run_fp32_branch(card, root, "sdxl", "sdxl_train_depth.yaml",
                                        sdxl_fp32_train_launches(),
                                        f"1x{SDXL_SIZE}x{SDXL_SIZE}")
        launches_i2v = run_fp32_branch(card, root, "i2vgenxl", "i2vgenxl_train_depth.yaml",
                                       i2v_fp32_train_launches(),
                                       f"1x{I2V_FRAMES}x{SIZE}x{SIZE}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    run_mesh_generate(dev, card)
    print(f"phase 16 on {card}: {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, {"sdxl_training_fp32": launches_sdxl,
                            "i2vgenxl_training_fp32": launches_i2v}


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability >= 9.0, got {cap}")
    # before any output: outside a checkout of the repo the script prints nothing
    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft

    card = nvidia_smi_line()
    print(f"card: {card} (capability {cap[0]}.{cap[1]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    t_start = time.perf_counter()

    def phase_done(label):
        print(f"[{label} done at {time.perf_counter() - t_start:.1f} s]")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    built_before = os.path.exists(_build.library_path())
    t0 = time.perf_counter()
    path = _build.build()
    print(f"build: {path} in {time.perf_counter() - t0:.1f} s"
          + (" (already built)" if built_before else " (nvcc ran)"))
    serialized = []
    with open(path[:-3] + ".log") as fh:  # per entry function: name, spills, registers
        for line in fh:
            if any(key in line for key in ("Compiling entry", "bytes stack frame", "registers",
                                           "warning", "C7520")):
                print("  ptxas: " + line.strip())
            if "C7520" in line:  # ptxas serialised a kernel's wgmma instructions
                serialized.append(line.strip())
    if serialized:
        raise RuntimeError(f"ptxas serialised wgmma (C7520): {serialized}")
    print("  ptxas: no wgmma serialised (no C7520 in the build log)")

    phase_done("build")
    results = check_kernels(dev, card)
    phase_done("phase 3 at the SVD shapes")
    for name, rows in check_i2vgenxl_kernels(dev, card).items():
        results[name] += rows
    phase_done("phase 3 at the I2VGen-XL shapes")
    for name, rows in check_sdxl_kernels(dev, card).items():
        results[name] += rows
    phase_done("phase 3 at the SDXL shapes")
    kernels = kernel_counters()
    launches, launches_fb, k4_per_step, per_step = run_slices(dev, card, kernels)
    phase_done("phases 4-5, the SVD slice")
    # K4's per-step sums from the launches the fused-block run counted per step
    k4 = {**results["ln_ff_residual"][0], "controlled": 0, "unet_only": 0, **k4_per_step}
    for key in ("controlled", "unet_only"):
        per_step_total("K4 (fused-block)", [k4], key)
    run_exact_gelu(dev, card, ft.KERNEL_FULL, fb.KERNEL)
    launches_ff = run_feed_forward(dev, card, ff.KERNEL)
    print("K5 geglu is off every model path: the models' BasicTransformerBlocks run their "
          "FF through K4's op (as the JAX package's do) and no model builds FeedForward on "
          "its own; its launches below are those of the FeedForward run")
    phase_done("phases 6-7")
    launches_train, train_per_step = run_training(dev, card, kernels)
    phase_done("phase 8, SVD training")
    launches_i2v, launches_i2v_multi = run_i2vgenxl(dev, card, kernels)
    phase_done("phase 9, I2VGen-XL")
    launches_sdxl = run_sdxl(dev, card, kernels)
    phase_done("phase 10, SDXL")
    launches_branches = run_train_branches(dev, card, kernels)
    phase_done("phase 11, I2VGen-XL and SDXL training")
    import tempfile

    shared = tempfile.mkdtemp(prefix="chip_smoke_cli_")  # phase 13's folders, read by 15
    try:
        launches_branches.update(run_cli(dev, card, kernels, per_step, shared))
        phase_done("phase 13, the CLI")
        launches_branches.update(run_train_cli(dev, card, kernels, train_per_step[0],
                                               per_step))
        phase_done("phase 14, the training CLI")
        launches_branches.update(run_conditions(dev, card, kernels, per_step,
                                                train_per_step[0], shared))
        phase_done("phase 15, condition extraction and real-data training")
    finally:
        shutil.rmtree(shared, ignore_errors=True)
    fp32_rows, fp32_launches, fp32_launches_branches = run_phase16(dev, card,
                                                                   train_per_step[0])
    phase_done("phase 16, fp32 towers and generate(mesh=...)")
    print(f"torch.profiler: {PROFILER_COST['traces']} traces of device activity, "
          f"{PROFILER_COST['traced_s']:.1f} s under the profiler, "
          f"{PROFILER_COST['read_s']:.1f} s reading their device events")

    meta = {  # name: (source, replaces, the run its launches come from)
        "group_norm_silu": ("ctrl_adapter_tpu_torch/csrc/group_norm.cu",
                            "ctrl_adapter_tpu/ops/group_norm.py:166", "svd default"),
        "flash_attention": ("ctrl_adapter_tpu_torch/csrc/flash_attention.cu",
                            "ctrl_adapter_tpu/ops/flash_attention.py:97", "svd default"),
        "temporal_block": ("ctrl_adapter_tpu_torch/csrc/temporal_attention.cu",
                           "ctrl_adapter_tpu/ops/fused_temporal.py:265", "svd default"),
        "temporal_block_full": ("ctrl_adapter_tpu_torch/csrc/temporal_full.cu",
                                "ctrl_adapter_tpu/ops/fused_temporal.py:265", "svd default"),
        "ln_ff_residual": ("ctrl_adapter_tpu_torch/csrc/ln_ff.cu",
                           "ctrl_adapter_tpu/ops/fused_block.py:142", "svd fused-block"),
        "geglu": ("ctrl_adapter_tpu_torch/csrc/geglu.cu", "ctrl_adapter_tpu/ops/fused_ff.py:70",
                  "FeedForward, no model path"),
        "flash_attention_bwd": ("ctrl_adapter_tpu_torch/csrc/flash_attention_bwd.cu",
                                "ctrl_adapter_tpu/ops/flash_attention.py:97 (the custom VJP's "
                                "_flash_attention_bwd_dkv, _flash_attention_bwd_dq)",
                                "svd training"),
    }
    counts = {"svd default": launches, "svd fused-block": launches_fb,
              "FeedForward, no model path": {"geglu": launches_ff},
              "svd training": launches_train}
    # each kernel's first row, without the per-step counts the sums above used
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": counts[meta[name][2]][name], "path": meta[name][2],
         **{k: v for k, v in results[name][0].items()
            if k not in ("controlled", "unet_only", "training", "train_i2vgenxl",
                         "train_sdxl")},
         "max_abs_err": max(r["max_abs_err"] for r in results[name]),
         "launches_i2vgenxl": launches_i2v[name],
         "launches_i2vgenxl_multi": launches_i2v_multi[name],
         "launches_sdxl": launches_sdxl[name],
         **{f"launches_{run}": n[name] for run, n in launches_branches.items()}}
        for name in kernels]}
    line["kernels"] += [  # the fp32 kernels: launches of phase 16's fp32 training run
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": fp32_launches[name], "path": "svd training, --mixed_precision no",
         **{k: v for k, v in fp32_rows[name][0].items() if k != "per_adapter_call"},
         "max_abs_err": max(r["max_abs_err"] for r in fp32_rows[name]),
         **{f"launches_{run}": n[name] for run, n in fp32_launches_branches.items()}}
        for name, (src, replaces) in FP32_KERNELS.items()]
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
