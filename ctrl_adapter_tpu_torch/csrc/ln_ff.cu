// K4: the feed-forward residual sub-block on (M, C) rows,
//   out = [x +] W2 . (value * gelu(gate)) + b2,  [value; gate] = LN(x) . Wg^T + bg.
//
// Replaces: ctrl_adapter_tpu/ops/fused_block.py, ln_ff_residual ->
//   _pallas_ln_ff_residual (Pallas body _kernel): LN statistics in fp32, an
//   fp32 accumulator over inner-width chunks, so the (M, 8C) intermediate never
//   reaches memory.
//
// What bounds it on the H100: per row, 2*C*2I (GEGLU) + 2*I*Cout (W2) flops
// against 2*(C + Cout) bytes of x and out, I = 4C: ~12*C flop per byte (3,840
// at C = 320), far above the ~295 flop/byte ridge, so the tensor cores bound
// it in principle. In this first design each CTA of 64 rows re-reads all the
// weights (2.46 MB at C = 320) from L2, ~1,792 times at the main path's
// 114,688 rows, and mma.sync reaches only part of the wgmma peak.
//
// Design (ln_ff.cuh): one CTA of 8 warps per 64 rows. LN(x) goes to shared
// memory as bf16; Wg and W2 stream through a two-slot cp.async ring in chunks
// of 32 inner columns; per chunk the 64 x 64 [value; gate] product lands in
// registers, h = value * gelu(gate) (fp32, rounded to bf16 as the TPU kernel
// does) goes to shared memory and is multiplied into the 64 x Cout fp32
// accumulator in registers. The epilogue adds b2 and the residual in fp32 and
// rounds once. Shapes: C % 64 == 0, C <= 512, Cout % 64 == 0, Cout <= 512,
// inner % 32 == 0; with the residual Cout == C.
#include "ln_ff.cuh"

namespace {

using namespace lnff;

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    ln_ff_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w,
                 const bf16* __restrict__ ln_b, const bf16* __restrict__ wg,
                 const bf16* __restrict__ bg, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ out, int64_t M, int c,
                 int inner, int residual, int exact, float eps) {
  constexpr int kCout = NT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = ld_of(c);
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* slot0 = a_s + kRows * ld;
  bf16* slot1 = slot0 + slot_elems(c, kCout);
  bf16* h_s = slot1 + slot_elems(c, kCout);

  const int64_t m0 = int64_t(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(M - m0 < kRows ? M - m0 : kRows);
  // (stream_tiles synchronises before the first product reads a_s)
  layer_norm_tile(a_s, ld, [&](int r) { return x + (m0 + r) * c; }, nrows, c, ln_w, ln_b, eps);

  float acc[NT][4];
  ff_tile<NT, false>(acc, a_s, c, slot0, slot1, h_s, wg, bg, w2, inner, exact != 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * 16 + g + 8 * h;
    if (r >= nrows) continue;
    const int64_t m = m0 + r;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = (wn * NT + j) * 8 + 2 * t;
      float y0 = acc[j][2 * h] + bf2f(b2[n]);
      float y1 = acc[j][2 * h + 1] + bf2f(b2[n + 1]);
      if (residual) {
        y0 += bf2f(x[m * c + n]);
        y1 += bf2f(x[m * c + n + 1]);
      }
      *reinterpret_cast<uint32_t*>(out + m * kCout + n) = pack_bf16(y0, y1);
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* ln_w, const void* ln_b, const void* wg,
                   const void* bg, const void* w2, const void* b2, void* out, int64_t M, int c,
                   int inner, int residual, int exact, float eps, cudaStream_t st) {
  const int smem = (kRows * ld_of(c) + 2 * slot_elems(c, NT * 16) + kRows * kLDI) * 2;
  cudaError_t e = cudaFuncSetAttribute(ln_ff_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>((M + kRows - 1) / kRows);
  ln_ff_kernel<NT><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(bg), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, c, inner, residual, exact,
      eps);
  return cudaGetLastError();
}

}  // namespace

// x: (M, c); ln_w, ln_b: (c,); wg: (2*inner, c); bg: (2*inner,); w2: (cout, inner);
// b2: (cout,); out: (M, cout). All bf16, contiguous. exact: erf gelu, else tanh.
extern "C" int cak_ln_ff(const void* x, const void* ln_w, const void* ln_b, const void* wg,
                         const void* bg, const void* w2, const void* b2, void* out, int64_t M,
                         int c, int inner, int cout, int residual, int exact, float eps,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 64 || c > 512 || inner % kKI || (residual && cout != c))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cout) {
#define CAK_LN_FF_CASE(COUT) \
  case COUT:                 \
    return static_cast<int>( \
        launch<COUT / 16>(x, ln_w, ln_b, wg, bg, w2, b2, out, M, c, inner, residual, exact, eps, st));
    CAK_LN_FF_CASE(64)
    CAK_LN_FF_CASE(128)
    CAK_LN_FF_CASE(192)
    CAK_LN_FF_CASE(256)
    CAK_LN_FF_CASE(320)
    CAK_LN_FF_CASE(384)
    CAK_LN_FF_CASE(448)
    CAK_LN_FF_CASE(512)
#undef CAK_LN_FF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
