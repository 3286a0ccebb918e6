// Shared device helpers for the hand-written Hopper kernels: bf16 conversion,
// warp reductions and the mma.sync.m16n8k16 bf16 tensor-core instruction (fp32
// accumulate).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4), as the kernels
// use it:
//   A (16x16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col": B[k][n]), two registers:
//     b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C/D (16x8 fp32): c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// Round an fp32 value to bf16 and back: mirrors a tensor stored in bf16.
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// c += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Load the A fragment of rows [r0, r0+16) x cols [k0, k0+16) of a row-major
// bf16 tile with leading dimension ld (elements).
__device__ __forceinline__ void load_a_frag(uint32_t* a, const bf16* tile, int ld, int r0,
                                            int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment for B[k][n] = W[n][k] with W row-major (n rows, leading dim ld):
// the k-pairs of one n are contiguous.
__device__ __forceinline__ void load_b_frag_nk(uint32_t& b0, uint32_t& b1, const bf16* w,
                                               int ld, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = w + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}
