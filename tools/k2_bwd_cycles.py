"""Where K2 backward's main kernel (``csrc/flash_attention_bwd.cu``,
``flash_bwd_kernel``) spends its cycles on one Hopper card.

    python tools/k2_bwd_cycles.py

There is no ``ncu`` on the card's machine, so this reads the SM clock from
inside the kernel, in copies of the package under ``build/k2_bwd_cycles/``
(gitignored); the package itself is not changed. Four copies:

- ``marks``: ``clock64()`` marks between the phases of the consumer loop. Each
  consumer thread sums the cycles of each phase over its tiles; thread 0 of
  each consumer warpgroup adds its sums into a device array that a C entry
  (``cak_bwd_cycles``) reads and clears. Printed per phase as cycles per CTA
  and as a share of the consumer's time from the wait for K and V to the end;
  beside them the dQ writer's cycles per CTA waiting for its turn, for the
  consumers' partials and for its reduce-adds to complete;
- ``no-reduce``: the dQ partial is staged and handed to the writer, which
  takes its turns but adds nothing into the scratch (no TMA reduce-add);
- ``no-dq``: neither the dQ product nor its reduce-add;
- ``intact``: the kernel as it is.

Each copy is built (its own ``build/kernels/``) and run in a process of its
own at the training step's two shapes; the main kernel's device time
(``torch.profiler``, warm L2, ``chip_smoke.py:kernel_times``) is printed for
each, so the cost of the dQ reduction and of the dQ product reads as the
difference to ``intact``. The copies' gradients are wrong where a step is
left out, and the marks cost registers and issue slots: only ``intact``
computes the kernel's numbers. Every edit must match its anchor in the source
once, or the tool stops. One JSON line per copy and shape. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OUT = os.path.join(_REPO, "build", "k2_bwd_cycles")
SHAPES = ((14, 5, 4096, 64), (14, 10, 1024, 64))

PHASES = ("wait for K, V", "wait for Q, dO (producer)", "S^T product", "P^T (exp2)",
          "dP^T product", "dS^T, pack to bf16, dS^T to shared memory", "issue dV, dK",
          "barrier between the consumers", "dV, dK products", "dQ product",
          "wait for the staging slot (the dQ writer)", "stage dQ, hand it to the writer",
          "dK and dV stores")
WRITER = ("wait for the turn", "wait for the partials", "wait for the adds to complete")
_MARK = "{{ const unsigned now_ = unsigned(clock64()); cyc_[{k}] += now_ - last_; last_ = now_; }}"


def _mark(k: int) -> str:
    return _MARK.format(k=k)


def _edits(variant: str):
    """(anchor, replacement) pairs for the copy ``variant`` of the source."""
    reduce = ("          tma_reduce_add_2d(&tm_dq, src, col0, row0);\n"
              "          tma_reduce_add_2d(&tm_dq, src + 64 * kRowBytes, col0 + 32, row0);\n")
    if variant == "no-reduce":
        return [(reduce, "")]
    if variant == "no-dq":
        return [("      for (int kk = 0; kk < kKeys / 16; ++kk)\n        wgmma_ss_n64<1, 1>(dq,",
                 "      for (int kk = 0; kk < 0; ++kk)\n        wgmma_ss_n64<1, 1>(dq,"),
                (reduce, "")]
    if variant != "marks":
        return []
    n = len(PHASES)

    def after(anchor, k):
        return anchor, anchor + _mark(k) + "\n"

    w = len(WRITER)
    clock = "unsigned(clock64())"
    return [
        ("namespace {\n", f"namespace {{\n\n__device__ unsigned long long g_cyc[2 * {n} + {w}];"
                          "\n"),
        ("      int* counter = a.counters + int64_t(bn) * nq;\n",
         "      int* counter = a.counters + int64_t(bn) * nq;\n"
         f"      unsigned wcyc_[{w}] = {{}};\n      unsigned wt_ = 0;\n"),
        ("        wait_turn(counter + t, turn0 + i / span);\n",
         f"        wt_ = {clock};\n        wait_turn(counter + t, turn0 + i / span);\n"
         f"        wcyc_[0] += {clock} - wt_;\n"),
        ("          mbar_wait(stg_full(w), i & 1);\n",
         f"          wt_ = {clock};\n          mbar_wait(stg_full(w), i & 1);\n"
         f"          wcyc_[1] += {clock} - wt_;\n"),
        ("        bulk_wait<0>();  // the adds are done in L2, not only read from shared memory\n",
         f"        wt_ = {clock};\n        bulk_wait<0>();\n        wcyc_[2] += {clock} - wt_;\n"),
        ("        red_release_gpu_add(counter + t, 1);\n      }\n",
         "        red_release_gpu_add(counter + t, 1);\n      }\n"
         f"      for (int k = 0; k < {w}; ++k) atomicAdd(&g_cyc[2 * {n} + k], "
         "(unsigned long long)wcyc_[k]);\n"),
        ("    mbar_wait(kv_full, 0);\n",
         f"    unsigned cyc_[{n}] = {{}};\n    unsigned last_ = unsigned(clock64());\n"
         "    mbar_wait(kv_full, 0);\n" + _mark(0) + "\n"),
        after("      mbar_wait(full(s), (i >> 1) & 1);\n", 1),
        after("      wgmma_wait<1>();\n      fence_regs(st);\n", 2),
        ("      wgmma_wait<0>();\n      fence_regs(dpt);\n",
         _mark(3) + "\n      wgmma_wait<0>();\n      fence_regs(dpt);\n" + _mark(4) + "\n"),
        after("((chunk ^ g8) << 4) + 4 * t4) = ds_frag[kk][e];\n        }\n      }\n"
              "      fence_async_smem();\n", 5),
        ("      wgmma_commit();\n\n      // dQ_partial",
         "      wgmma_commit();\n" + _mark(6) + "\n\n      // dQ_partial"),
        after("      named_bar_sync(1, 256);\n", 7),
        after("      mbar_arrive(empty(s));  // Q and dO of this slot read for the last time\n", 8),
        after("      wgmma_wait<0>();\n      fence_regs(dq);\n", 9),
        after("      if (i > 0) mbar_wait(stg_empty(wc), (i - 1) & 1);\n", 10),
        after("      mbar_arrive(stg_full(wc));\n", 11),
        ("            pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);\n      }\n    }\n",
         "            pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);\n      }\n    }\n"
         + _mark(n - 1) + "\n"
         f"    if (tid == 0)\n      for (int k = 0; k < {n}; ++k) atomicAdd(&g_cyc[wc * {n} + k], "
         "(unsigned long long)cyc_[k]);\n"),
        ("", f"""
extern "C" int cak_bwd_cycles(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));
  static const unsigned long long zero[2 * {n} + {w}] = {{}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cyc, zero, sizeof(g_cyc));
  return static_cast<int>(e);
}}
"""),
    ]


def make_copy(variant: str) -> str:
    """The package copied to ``build/k2_bwd_cycles/<variant>`` with the
    variant's edits; only the sources K2 needs are kept, so the build is short."""
    root = os.path.join(_OUT, variant)
    shutil.rmtree(root, ignore_errors=True)
    pkg = os.path.join(root, "ctrl_adapter_tpu_torch")
    shutil.copytree(os.path.join(_REPO, "ctrl_adapter_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(pkg, "csrc")
    for name in os.listdir(csrc):
        if name.endswith(".cu") and name not in ("common.cu", "flash_attention.cu",
                                                 "flash_attention_bwd.cu"):
            os.remove(os.path.join(csrc, name))
    path = os.path.join(csrc, "flash_attention_bwd.cu")
    with open(path) as fh:
        src = fh.read()
    for anchor, text in _edits(variant):
        if anchor == "":
            src += text
            continue
        if src.count(anchor) != 1:
            raise SystemExit(f"k2_bwd_cycles: anchor found {src.count(anchor)} times, want 1:\n"
                             f"{anchor}")
        src = src.replace(anchor, text)
    with open(path, "w") as fh:
        fh.write(src)
    return root


def run(root: str, variant: str) -> None:
    """In a process of its own: build the copy at ``root`` and time it."""
    import torch

    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(_REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from ctrl_adapter_tpu_torch.ops import _build
    from ctrl_adapter_tpu_torch.ops import flash_attention as fa

    if not _build.CSRC_DIR.startswith(root):
        raise SystemExit(f"k2_bwd_cycles: imported the package from {_build.CSRC_DIR}")
    path = _build.build()
    with open(path[:-3] + ".log") as fh:
        log = fh.read().splitlines()
    starts = [i for i, text in enumerate(log) if "Compiling" in text and "flash_bwd_kernel" in text]
    regs = [text.strip() for i in starts for text in log[i + 2:i + 4]]
    lib = _build.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    card = smoke.nvidia_smi_line()
    for b, n, t, h in SHAPES:
        q, k, v, do = (torch.randn(b, t, n * h, generator=g, device=dev).to(torch.bfloat16)
                       .view(b, t, n, h).transpose(1, 2) for _ in range(4))
        o, lse = fa._forward(q, k, v, True)
        bwd = lambda: fa.attention_bnth_bwd(q, k, v, o, do, lse)  # noqa: E731
        split = smoke.kernel_times(bwd)
        main_ms = None if split is None else sum(ms for name, ms in split.items()
                                                 if "flash_bwd_kernel" in name)
        line = {"variant": variant, "shape": [b, n, t, h], "main_kernel_ms": main_ms,
                "launches_ms": split, "ptxas": regs, "card": card}
        if variant == "marks":
            n = len(PHASES)
            out = (ctypes.c_ulonglong * (2 * n + len(WRITER)))()
            lib.cak_bwd_cycles(out)  # clear what the timing runs added
            bwd()
            torch.cuda.synchronize()
            if lib.cak_bwd_cycles(out) != 0:
                raise SystemExit("k2_bwd_cycles: reading the cycle counts failed")
            ctas = (t // 128) * b * n
            per = [(out[i] + out[n + i]) / 2 / ctas for i in range(n)]
            total = sum(per)
            line["cycles_per_cta"] = total
            line["phases"] = {p: [round(c), round(100 * c / total, 1)]
                              for p, c in zip(PHASES, per)}
            line["writer_cycles_per_cta"] = {p: round(out[2 * n + k] / ctas)
                                             for k, p in enumerate(WRITER)}
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run(args.run, args.variant)
        return 0
    for variant in ("marks", "no-reduce", "no-dq", "intact"):
        root = make_copy(variant)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run", root,
                        "--variant", variant], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
