"""Write ``ctrl_adapter_tpu_torch/csrc/wgmma.cuh``: inline-PTX wrappers of the
Hopper ``wgmma.mma_async`` shapes the port's kernels use (bf16 or tf32 in, fp32
accumulate), one function per shape, every accumulator register spelled out.

    python tools/gen_wgmma.py

SS takes A and B from shared memory through descriptors; RS takes A from
registers (four 32-bit registers of bf16 pairs, the mma.m16n8k16 A layout per
warp) and B through a descriptor. ``TB`` is the transpose-B immediate (1 for an
MN-major B such as attention's V); SS also takes ``TA``, the transpose-A
immediate (1 for an MN-major A, such as the backward's dS^T read as dS).

The tf32 forms (``wgmma_tf32_ss_n*``, ``wgmma_tf32_rs_n*``, k8) take no
transpose: both shared-memory operands are K-major. Their RS A operand is four
32-bit registers of one tf32 value each, per warp the mma.m16n8k8 tf32 layout:
a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4].
"""

import os

SS_N = (64, 128, 160, 192)
RS_N = (64, 128, 160)
TF32_SS_N = (16, 32, 64)
TF32_RS_N = (64,)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "ctrl_adapter_tpu_torch", "csrc", "wgmma.cuh")

HEAD = """\
// Generated by tools/gen_wgmma.py; edit that script, not this file.
//
// wgmma.mma_async bf16 x bf16 -> fp32 (k16) and tf32 x tf32 -> fp32 (k8) for
// one warpgroup (128 threads, m64).
// Accumulator layout (per warp w of the warpgroup, g = lane / 4, t = lane % 4):
// d[4j + 0..1] = D[16w + g][8j + 2t .. +1], d[4j + 2..3] = D[16w + g + 8][...].
// Each call must sit between wgmma_fence() and wgmma_commit(); read the
// accumulators only after wgmma_wait<>() and fence_regs().
#pragma once

#include <stdint.h>
"""


def regs(n):
    return ", ".join(f"%{i}" for i in range(n))


def outs(n):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(n):
    r = n // 2
    return f"""
// D (64 x {n}) {{+}}= A (64 x 16, smem) . B (16 x {n}, smem); scale_d 0 overwrites D.
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss_n{n}(float (&d)[{r}], uint64_t da, uint64_t db,
                                             int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, %{r + 4}, %{r + 3};\\n}}\\n"
      : {outs(r)}
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}}
"""


def rs(n):
    r = n // 2
    return f"""
// D (64 x {n}) += A (64 x 16, registers) . B (16 x {n}, smem).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n{n}(float (&d)[{r}], const uint32_t (&a)[4],
                                             uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6};\\n}}\\n"
      : {outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}}
"""


def tf32_ss(n):
    r = n // 2
    return f"""
// D (64 x {n}) {{+}}= A (64 x 8, smem) . B (8 x {n}, smem), tf32, both K-major;
// scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n{n}(float (&d)[{r}], uint64_t da, uint64_t db,
                                                  int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs(r)}}}, %{r}, %{r + 1}, p, 1, 1;\\n}}\\n"
      : {outs(r)}
      : "l"(da), "l"(db), "r"(scale_d));
}}
"""


def tf32_rs(n):
    r = n // 2
    return f"""
// D (64 x {n}) += A (64 x 8, registers, tf32) . B (8 x {n}, smem, K-major).
__device__ __forceinline__ void wgmma_tf32_rs_n{n}(float (&d)[{r}], const uint32_t (&a)[4],
                                                  uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}\\n"
      : {outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}}
"""


def main():
    text = (HEAD + "".join(ss(n) for n in SS_N) + "".join(rs(n) for n in RS_N)
            + "".join(tf32_ss(n) for n in TF32_SS_N) + "".join(tf32_rs(n) for n in TF32_RS_N))
    with open(OUT, "w") as fh:
        fh.write(text)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
