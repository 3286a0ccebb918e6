"""Chip smoke test of the PyTorch port: the SVD control path on one Hopper card.

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
   gelu forms apart (``gelu_form_check``);
4. run the slice: ``SVDControlNetAdapterPipeline`` at full width (SVD UNet
   320/640/1280/1280, SD-v1.5 ControlNet, the 13-block adapter at A-D + M, the
   temporal VAE) in bf16 with weights drawn from a seeded generator, 14 frames
   at 512x512, a few Euler steps with CFG and latent skipping, then decode;
   check the video, that every kernel of the path was launched and that the
   temporal blocks took the JAX dispatch (K3 "full" at UNet level 0, K3
   "hybrid" at level 1 and in the adapter); then, on a small input, check the
   kernel path against an fp32 reference of the same weights;
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
8. print the per-kernel JSON line, the card line, and the result line.

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


def device_times(fn, flush):
    """(warm, cold) device ms per call of ``fn()``: the sum of its kernels'
    device times under ``torch.profiler`` (back-to-back calls, inputs left in
    L2; None where the profiler records no device time), and ``cold_ms``."""
    split = kernel_times(fn)
    return (None if split is None else sum(split.values())), cold_ms(fn, flush)


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def device_line(row, fn, flush) -> None:
    """Time ``fn()`` on device, warm and cold L2 (``device_times``), print both
    beside the row's bound and its share of them, and add them to the row."""
    warm, cold = device_times(fn, flush)
    bound = row["bound_ms"]
    shares = ", ".join(f"{what} {100 * bound / t:.1f} %" for what, t in (("warm", warm),
                                                                         ("cold", cold)) if t)
    print(f"    device: kernel {fmt_ms(warm)} warm L2, {fmt_ms(cold)} cold L2; bound "
          f"{bound:.4f} ms, kernel at {shares} of it")
    row.update(device_ms=warm, cold_ms=cold)


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


def k1_rows():
    """K1's calls in one adapter call, by (shape, silu): per block the spatial
    ResNet's two norms (SiLU) on (28, c, h, h), the temporal ResNet's two (SiLU)
    on (2, c, 14, h, h) and the transformer's input norm (no SiLU) on (28, c, h, h)."""
    rows = {}
    for c, h in adapter_blocks():
        for shape, silu, n in (((2 * FRAMES, c, h, h), False, 1), ((2 * FRAMES, c, h, h), True, 2),
                               ((2, c, FRAMES, h, h), True, 2)):
            rows[(shape, silu)] = rows.get((shape, silu), 0) + n
    return rows


def per_step_total(name, rows, key):
    """Print the sum of launches x kernel ms against launches x bound over
    ``rows``: host-inclusive (``ms``), then on device time, warm and cold L2."""
    n = sum(r[key] for r in rows)
    bound = sum(r[key] * r["bound_ms"] for r in rows)
    for field, what in (("ms", "host-inclusive"), ("device_ms", "device, warm L2"),
                        ("cold_ms", "device, cold L2")):
        if any(r[key] and r[field] is None for r in rows):
            print(f"  {name} per {key.replace('_', ' ')} step ({what}): not measured")
            continue
        ms = sum(r[key] * r[field] for r in rows if r[key])
        print(f"  {name} per {key.replace('_', ' ')} step ({what}): {n} launches, {ms:.3f} ms "
              f"of kernel against {bound:.3f} ms of bound ({100 * bound / ms:.1f} %)")


def kernel_times(fn, iters: int = 5):
    """Device ms per call of each CUDA kernel ``fn()`` launches, from
    ``torch.profiler``; a run in which the profiler recorded no device time
    (it happens now and then for short runs) is made again, up to three
    runs, then None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            us = ev.self_device_time_total
            if us > 0:
                name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
                times[name] = times.get(name, 0.0) + us / 1000 / iters
        if times:
            return times
    return None


def device_activity(run):
    """``run()`` once under ``torch.profiler``: (busy, span, per_name) of the
    CUDA kernels it launched, in µs. busy is the union of their spans, span
    the time from the first one's start to the last one's end (1 - busy / span
    is the device's idle share), per_name {kernel name: [µs, calls]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise RuntimeError("the profiler recorded no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
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
        t[0] += e.time_range.elapsed_us()
        t[1] += 1
    return busy, spans[-1][1] - spans[0][0], per_name


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


def check_kernels(dev, card):
    import torch.nn.functional as F

    from ctrl_adapter_tpu_torch.ops import flash_attention as fa
    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
    from ctrl_adapter_tpu_torch.ops import fused_temporal as ft
    from ctrl_adapter_tpu_torch.ops import group_norm as gn
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
    k1 = []
    cases = [(shape, silu, n, False) for (shape, silu), n in k1_rows().items()]
    cases.append(((28, 320, 64, 64), False, 0, True))
    for shape, silu, n, flat in cases:
        label = (f"({','.join(map(str, shape))})" + (" silu" if silu else "")
                 + (" near-constant groups" if flat else ""))
        x = rand(*shape)
        if flat:  # half the groups: 0.1 + 1e-4 noise, variance far below eps
            x[:, : shape[1] // 2] = 0.1 + 1e-4 * x[:, : shape[1] // 2]
        x = x.to(bf)
        w, b = (1.0 + rand(shape[1], scale=0.1)).to(bf), rand(shape[1], scale=0.1).to(bf)
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
        k1.append(row)
    per_step_total("K1", k1, "controlled")
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
        # the outputs average T keys (std ~0.03 here), far below atol: the norm
        # check catches a K/V tile that is skipped or read from the wrong slot
        err = compare(f"K2 ({b_},{n_},{t_},64)", got, want, atol=1e-2, rtol=2e-2, rel_norm=1e-2)
        ms = cuda_ms(lambda: fa.attention_bnth(q, k, v))
        pms = cuda_ms(lambda: fa._torch_attention(q, k, v), iters=3, reps=3, warmup=1)
        k2.append(report(f"({b_},{n_},{t_},64)", err, ms, pms,
                         rl.attention(b_, n_, t_, t_, 64), sdpa_times(q, k, v)))
    results["flash_attention"] = k2

    # K3 hybrid: the temporal attention sub-block with cross bias at every
    # shape the dispatch sends it on the slice (hybrid_rows), and two check
    # rows the wrapper takes but the dispatch sends elsewhere (UNet level 0,
    # c = 1280)
    print(f"K3 temporal attention block (bf16, f=14, head_dim 64, cross bias) on {card}")
    k3 = []
    cases = [(f"{r['where']} ({b_},{f_},{s_},{c_}) ia={ia}", (b_, f_, s_, c_, ia // 64),
              r["controlled"], r["unet_only"])
             for (b_, f_, s_, c_, ia), r in hybrid_rows().items()]
    cases += [("check L0 (2,14,4096,320) ia=320", (2, 14, 4096, 320, 5), 0, 0),
              ("check (2,14,64,1280) ia=1280", (2, 14, 64, 1280, 20), 0, 0)]
    for label, (b_, f_, s_, c_, heads), n_ctrl, n_unet in cases:
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
        k3.append(row)
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
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)


@contextlib.contextmanager
def env_switch(name: str):
    """Set an opt-in switch of the JAX package (``name=1``) and restore it."""
    saved = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def check_video(video, label):
    if tuple(video.shape) != (1, FRAMES, SIZE, SIZE, 3):
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
def launches_per_step(pipe, kernel):
    """Count ``kernel``'s launches in each denoise step of the runs inside:
    yields a list that gets, per step, (whether the step ran the ControlNet,
    the launches in the step). A step starts at the first tower call after
    the previous step's UNet call and ends with its own."""
    steps, state = [], {"mark": None, "controlled": False}

    def start(*_):
        if state["mark"] is None:
            state.update(mark=kernel.launches, controlled=False)

    def controlnet(*_):
        start()
        state["controlled"] = True

    def unet_done(*_):
        steps.append((state["controlled"], kernel.launches - state["mark"]))
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


def reference_check(pipe, dev, label):
    """On a small input, the bf16 kernel path and the bf16 plain path, each
    against the same weights in fp32 through the plain path."""
    bf = torch.bfloat16
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
    print(f"{label} reference (1x4x256x256, 2 steps, latents, errors relative to max|fp32|): "
          f"bf16 kernel path vs fp32 {err_k:.3e}, bf16 plain path vs fp32 {err_p:.3e}, "
          f"kernel vs plain {err_kp:.3e}; tolerance: kernel path within 2x the plain "
          f"path's error + 1e-2")
    if not (torch.isfinite(got).all() and err_k <= 2 * err_p + 1e-2):
        raise RuntimeError(f"{label}: kernel path is farther from the fp32 reference than allowed")


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
    video, launches, t_first = drive(pipe, inputs, kw, kernels, STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"slice: launches during the run {launches}")
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
    reference_check(pipe, dev, "slice")

    # phase 5, the fused-block configuration (K4 on the 320-wide FFs)
    fb_steps = 2
    with env_switch("CTRL_ADAPTER_FUSED_BLOCK"):
        with launches_per_step(pipe, kernels["ln_ff_residual"]) as k4_steps:
            video, launches_fb, t_fb = drive(pipe, inputs, kw, kernels, fb_steps)
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
        reference_check(pipe, dev, "fused-block slice")
    default_ms, _ = ms_per_step(pipe, inputs, kw, fb_steps)
    print(f"fused-block slice on {card}: {fb_steps} steps (control window covers {hi - lo}), "
          f"first generate() {t_fb:.3f} s; denoise {fused_ms:.1f} ms/step with "
          f"CTRL_ADAPTER_FUSED_BLOCK=1, {default_ms:.1f} ms/step default (same steps, run "
          f"right after)")
    del pipe
    return launches, launches_fb, k4_per_step


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
    from ctrl_adapter_tpu_torch.ops import fused_block as fb
    from ctrl_adapter_tpu_torch.ops import fused_ff as ff
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

    results = check_kernels(dev, card)
    kernels = {"group_norm_silu": gn.KERNEL, "flash_attention": fa.KERNEL,
               "temporal_block": ft.KERNEL, "temporal_block_full": ft.KERNEL_FULL,
               "ln_ff_residual": fb.KERNEL, "geglu": ff.KERNEL}
    launches, launches_fb, k4_per_step = run_slices(dev, card, kernels)
    # K4's per-step sums from the launches the fused-block run counted per step
    k4 = {**results["ln_ff_residual"][0], "controlled": 0, "unet_only": 0, **k4_per_step}
    for key in ("controlled", "unet_only"):
        per_step_total("K4 (fused-block)", [k4], key)
    run_exact_gelu(dev, card, ft.KERNEL_FULL, fb.KERNEL)
    launches_ff = run_feed_forward(dev, card, ff.KERNEL)
    print("K5 geglu is off every model path: the models' BasicTransformerBlocks run their "
          "FF through K4's op (as the JAX package's do) and no model builds FeedForward on "
          "its own; its launches below are those of the FeedForward run")

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
    }
    counts = {"svd default": launches, "svd fused-block": launches_fb,
              "FeedForward, no model path": {"geglu": launches_ff}}
    # each kernel's first row, without the per-step counts the sums above used
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": counts[meta[name][2]][name], "path": meta[name][2],
         **{k: v for k, v in results[name][0].items() if k not in ("controlled", "unet_only")},
         "max_abs_err": max(r["max_abs_err"] for r in results[name])}
        for name in kernels]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
