"""Where K1 fp32's ring kernel (``csrc/group_norm.cu``, ``gn_ring_kernel``)
spends a call on one Hopper card: a timeline of its CTAs.

    python tools/k1_ring_cycles.py [--shapes 14,640,32,32 14,1280,8,8 ...]

There is no ``ncu`` on the card's machine, so this reads the card's global
timer (``%globaltimer``, ns, one clock for every SM) from inside the kernel,
in a copy of the package under ``build/k1_ring_cycles/`` (gitignored); the
package itself is not changed. Thread 0 of each CTA marks its entry, the end
of the mbarrier set-up, and for each group it walks the moment its sums are
done (every piece of x has landed), the moment the statistics are known
(after the block's reduction) and the moment the group is written (after the
barrier that frees its table), then its exit; a C entry (``cak_k1_marks``)
copies the marks out. Each shape runs once with L2 flushed before the call,
as ``chip_smoke.py:cold_ms`` times it, and prints one JSON line: the call's
device time (CUDA events), the span from the first CTA's entry to the last
CTA's exit, and over the CTAs the median and the largest of each phase (µs
from the first entry: entry, first data, last data, last write, exit; per
group: wait for data, reduction, normalise and write). The marks cost a few
instructions a group; the times of ``tools/k1_fp32_times.py`` are the
kernel's. Every edit must match its anchor in the source once, or the tool
stops. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OUT = os.path.join(_REPO, "build", "k1_ring_cycles")
SHAPES = ((14, 320, 32, 32), (14, 640, 32, 32), (14, 640, 16, 16), (14, 1280, 16, 16),
          (14, 1280, 8, 8))
UNITS = 8                 # groups a CTA marks at most
MARKS = 4 + 3 * UNITS     # entry, set-up, exit, spare; per group: data, statistics, written
_MARK = "if (threadIdx.x == 0 && {cond}) mk_[{k}] = gtime_();"


def _edits():
    """(anchor, replacement) pairs for the marked copy of ``group_norm.cu``."""
    kernel = "template <int NT, bool SILU>\n__global__ void __launch_bounds__(NT)\n    gn_ring_kernel("
    head = ("constexpr int kMU = %d, kMarks = %d;\n"
            "__device__ unsigned long long k1_marks_[8192 * kMarks];\n"
            "__device__ __forceinline__ unsigned long long gtime_() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n\n" % (UNITS, MARKS))
    setup = "  constexpr int kWarps = NT / 32;\n"
    reduced = "    if (lane == 0) red[warp] = make_float2(s, ss);\n"
    stats = "    float4* out = reinterpret_cast<float4*>(y + unit(i) * span);\n"
    written = "    __syncthreads();  // every thread is done with the table and with red\n"
    init = "  __syncthreads();  // the mbarriers are initialised\n"
    end = "  }\n}\n\ntemplate <int NT, bool SILU>\ncudaError_t launch_ring("
    unit = "i < kMU"
    return [
        (kernel, head + kernel),
        (setup, setup + "  unsigned long long* mk_ = k1_marks_ + int64_t(blockIdx.x) * kMarks;\n  "
         + _MARK.format(cond="true", k=0) + "\n"),
        (init, init + "  " + _MARK.format(cond="true", k=1) + "\n"),
        (reduced, "    " + _MARK.format(cond=unit, k="4 + 3 * i") + "\n" + reduced),
        (stats, stats + "    " + _MARK.format(cond=unit, k="5 + 3 * i") + "\n"),
        (written, written + "    " + _MARK.format(cond=unit, k="6 + 3 * i") + "\n"),
        (end, "  }\n  " + _MARK.format(cond="true", k=2) + "\n}\n\ntemplate <int NT, bool SILU>\n"
         "cudaError_t launch_ring("),
        ("", "\nextern \"C\" int cak_k1_marks(void* dst, int n) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, k1_marks_, "
         "n * sizeof(unsigned long long)));\n}\n"),
    ]


def make_copy() -> str:
    """The package under ``build/k1_ring_cycles/`` with the marks in
    ``group_norm.cu``; returns the copy's root."""
    dst = os.path.join(_OUT, "ctrl_adapter_tpu_torch")
    if os.path.exists(_OUT):
        shutil.rmtree(_OUT)
    shutil.copytree(os.path.join(_REPO, "ctrl_adapter_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "csrc", "group_norm.cu")
    with open(path) as fh:
        src = fh.read()
    for anchor, text in _edits():
        if anchor == "":
            src += text
            continue
        if src.count(anchor) != 1:
            raise SystemExit(f"k1_ring_cycles: anchor found {src.count(anchor)} times, want 1:\n"
                             f"{anchor}")
        src = src.replace(anchor, text)
    with open(path, "w") as fh:
        fh.write(src)
    return _OUT


def _smoke():
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timeline(marks, grid, walks):
    """Per-phase µs over the CTAs, from the first CTA's entry."""
    t0 = min(m[0] for m in marks[:grid])
    us = lambda t: (t - t0) / 1000  # noqa: E731
    rows = {"entry": [], "set-up done": [], "first data": [], "last data": [],
            "last write": [], "exit": [], "wait for data": [], "reduction": [],
            "normalise and write": []}
    for b in range(grid):
        m, n = marks[b], min(walks[b], UNITS)
        rows["entry"].append(us(m[0]))
        rows["set-up done"].append(us(m[1]))
        rows["exit"].append(us(m[2]))
        rows["first data"].append(us(m[4]))
        rows["last data"].append(us(m[4 + 3 * (n - 1)]))
        rows["last write"].append(us(m[6 + 3 * (n - 1)]))
        prev = m[1]
        for i in range(n):
            data, stats, done = m[4 + 3 * i], m[5 + 3 * i], m[6 + 3 * i]
            rows["wait for data"].append((data - prev) / 1000)
            rows["reduction"].append((stats - data) / 1000)
            rows["normalise and write"].append((done - stats) / 1000)
            prev = done
    return {k: {"median": statistics.median(v), "max": max(v)} for k, v in rows.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="fp32 shapes as comma-separated integers (default: SVD's rows)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_ring_cycles: no CUDA device")
    smoke = _smoke()
    card = smoke.nvidia_smi_line()
    root = make_copy()
    sys.path.insert(0, root)
    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import group_norm as gn

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"k1_ring_cycles: imported {_build.CSRC_DIR}, not the copy")
    lib = _build.library()
    lib.cak_k1_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes] if args.shapes
              else SHAPES)
    for shape in shapes:
        p = gn.plan(shape, 32, itemsize=4, sms=sms)
        if p.branch != "ring":
            print(json.dumps({"shape": shape, "plan": p.branch, "skipped": "not the ring"}))
            continue
        x = torch.randn(*shape, generator=g, device=dev)
        w, b = torch.ones(shape[1], device=dev), torch.zeros(shape[1], device=dev)
        for silu in (False, True):
            run = lambda: gn.group_norm_silu(x, w, b, 32, 1e-6, silu)  # noqa: E731
            for _ in range(3):  # the first calls load the kernel and set its shared memory
                run()
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            buf = (ctypes.c_ulonglong * (p.grid * MARKS))()
            status = lib.cak_k1_marks(buf, p.grid * MARKS)
            if status:
                raise RuntimeError(f"k1_ring_cycles: cak_k1_marks returned {status}")
            marks = [buf[i * MARKS:(i + 1) * MARKS] for i in range(p.grid)]
            groups = shape[0] * 32
            walks = [(groups - 1 - i) // p.grid + 1 for i in range(p.grid)]
            tl = timeline(marks, p.grid, walks)
            span = max(m[2] for m in marks) - min(m[0] for m in marks)
            print(json.dumps({"shape": shape, "silu": silu, "plan": {
                "threads": p.threads, "grid": p.grid, "walk": p.groups_per_cta}, "event_us": 1000 * start.elapsed_time(end),
                "span_us": span / 1000, "timeline_us": tl, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
