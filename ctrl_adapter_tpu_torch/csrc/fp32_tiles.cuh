// fp32 tile arithmetic on the CUDA cores, shared by the fp32 attention kernels
// (flash_attention_fp32.cu, flash_attention_fp32_bwd.cu).
//
// Every product there is a 64-row tile C (64 x 64 * NC) += A (64 x K) * B
// (K x 64 * NC) with both operands in shared memory "k-major": A as its
// transpose At[k][row] (a transposed tile, leading dimension kPad) and B as
// B[k][col] (a natural row-major tile of a (T, H) matrix, leading dimension H,
// or a transposed one, kPad). A CTA of 256 threads is a 16 x 16 grid: thread
// (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and, in each
// 64-column group c, columns 64 c + 4 tx .. 64 c + 4 tx + 3. Per k it reads one
// float4 of A (shared by the 16 threads of its row quad: a broadcast) and one
// float4 of B per column group, and does 16 fp32 FMAs per group, in a fixed
// order: every sum is the same from call to call.
//
// The 16 threads of one row quad are lanes 0-15 or 16-31 of one warp, so a
// row's reduction over its 64 columns is four shuffles (xor 1, 2, 4, 8).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32t {

constexpr int kRows = 64;      // rows (and columns) of every square tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 values a thread and column group
constexpr int kPad = 68;       // leading dimension of a transposed tile: rows stay 16-byte
                               // aligned, and the 64 rows' stores land on 32 banks

__device__ __forceinline__ int tx() { return threadIdx.x % 16; }
__device__ __forceinline__ int ty() { return threadIdx.x / 16; }

// sm[h * kPad + r] = g[r * ld + h] for the 64 rows r of a (rows, H) fp32 matrix
// (unit column stride, 16-byte aligned rows). Consecutive threads take
// consecutive rows, so the transposed stores hit distinct banks.
template <int H>
__device__ __forceinline__ void load_t(float* sm, const float* __restrict__ g, int64_t ld) {
  for (int idx = threadIdx.x; idx < kRows * H / 4; idx += kThreads) {
    const int r = idx % kRows, q = idx / kRows;
    const float4 v = *reinterpret_cast<const float4*>(g + r * ld + 4 * q);
    sm[(4 * q + 0) * kPad + r] = v.x;
    sm[(4 * q + 1) * kPad + r] = v.y;
    sm[(4 * q + 2) * kPad + r] = v.z;
    sm[(4 * q + 3) * kPad + r] = v.w;
  }
}

// sm[r * H + h] = g[r * ld + h]: the 64 rows as they are.
template <int H>
__device__ __forceinline__ void load_n(float* sm, const float* __restrict__ g, int64_t ld) {
  for (int idx = threadIdx.x; idx < kRows * H / 4; idx += kThreads) {
    const int r = idx / (H / 4), q = idx % (H / 4);
    *reinterpret_cast<float4*>(sm + r * H + 4 * q) =
        *reinterpret_cast<const float4*>(g + r * ld + 4 * q);
  }
}

// acc += A * B over k < K (see the header): At[k * lda + row], B[k * ldb + col].
template <int K, int NC>
__device__ __forceinline__ void mma(float (&acc)[4][4 * NC], const float* at, int lda,
                                    const float* b, int ldb) {
  const int r0 = 4 * ty(), c0 = 4 * tx();
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(at + k * lda + r0);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 b4 = *reinterpret_cast<const float4*>(b + k * ldb + 64 * c + c0);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * c + j] = fmaf(a[i], bv[j], acc[i][4 * c + j]);
    }
  }
}

// The thread's 4 x 4 block of a 64 x 64 register tile v[row][col], stored
// transposed: sm[col * kPad + row] (the A operand of a product over its columns).
__device__ __forceinline__ void store_t(float* sm, const float (&v)[4][4]) {
  const int r0 = 4 * ty(), c0 = 4 * tx();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(sm + (c0 + j) * kPad + r0) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in bytes, of a transposed tile of H rows and of a natural tile.
constexpr int t_bytes(int h) { return h * kPad * 4; }
constexpr int n_bytes(int h) { return kRows * h * 4; }

}  // namespace f32t
