// K5: out = value * gelu(gate), [value; gate] = x . W^T + b, on (M, C) rows;
// only the half-width product (M, D) is written.
//
// Replaces: ctrl_adapter_tpu/ops/fused_ff.py, geglu -> _pallas_geglu (Pallas
//   body _kernel): fp32 accumulation, bias and gelu in fp32, one rounding.
//
// What bounds it on the H100: 2*C*2D flops per row against 2*C + 2*D bytes
// (~C flop per byte, 320-640 on the GEGLU shapes), about at the ~295
// flop/byte ridge: the tensor cores and the write of the (M, D) output both
// matter.
//
// Design: a tiled mma.sync GEMM with a GEGLU epilogue. One CTA of 8 warps
// computes 128 rows x 64 outputs, i.e. the 64 value rows and the 64 matching
// gate rows of W, so value and gate of an output sit in the same thread's
// accumulators and the (M, 2D) pre-activation never exists. x and W stream
// through a two-slot cp.async ring in chunks of 32 channels. Rows past M are
// clamped on load and not stored. Shapes: C % 32 == 0, D % 64 == 0.
#include "ln_ff.cuh"

namespace {

constexpr int kBM = 128;          // rows per CTA
constexpr int kBD = 64;           // outputs per CTA (and as many gate columns)
constexpr int kBK = 32;           // channels per chunk
constexpr int kLD = kBK + 8;
constexpr int kSlot = (kBM + 2 * kBD) * kLD;  // x chunk, then W chunk [value; gate]

__global__ void __launch_bounds__(lnff::kThreads)
    geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int64_t M, int c, int d,
                 int exact) {
  __shared__ __align__(16) bf16 smem[2 * kSlot];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int d0 = blockIdx.y * kBD;

  float acc[2][8][4];  // [m-tile][n-tile: 0-3 value, 4-7 gate][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) lnff::zero_acc(acc[mt]);

  lnff::stream_tiles(
      c / kBK, smem, smem + kSlot,
      [&](int k, bf16* dst) {
        const int k0 = k * kBK;
        for (int i = threadIdx.x; i < (kBM + 2 * kBD) * (kBK / 8); i += lnff::kThreads) {
          const int r = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
          const bf16* src;
          if (r < kBM) {
            const int64_t m = m0 + r < M ? m0 + r : M - 1;
            src = x + m * c;
          } else {
            const int n = r - kBM;  // value rows d0.., then gate rows d + d0..
            src = w + int64_t(n < kBD ? d0 + n : d + d0 + n - kBD) * c;
          }
          cp_async16(dst + r * kLD + cc, src + k0 + cc);
        }
      },
      [&](int, const bf16* s) {
        const bf16* a_s = s;
        const bf16* w_s = s + kBM * kLD;
#pragma unroll
        for (int k0 = 0; k0 < kBK; k0 += 16) {
          uint32_t a[2][4];
          ldmatrix_a(a[0], a_s, kLD, wm * 32, k0, lane);
          ldmatrix_a(a[1], a_s, kLD, wm * 32 + 16, k0, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // n-tile pairs: value wn*32 + {0,16}, gate 64 + ...
            uint32_t b[4];
            ldmatrix_b2(b, w_s, kLD, (q >> 1) * kBD + wn * 32 + (q & 1) * 16, k0, lane);
            const int nt = (q >> 1) * 4 + (q & 1) * 2;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_16816(acc[mt][nt], a[mt], b[0], b[1]);
              mma_16816(acc[mt][nt + 1], a[mt], b[2], b[3]);
            }
          }
        }
      });

  const bool gelu_exact = exact != 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = d0 + wn * 32 + i * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[mt][i][2 * h + e] + bf2f(bias[n + e]);
          const float gt = acc[mt][4 + i][2 * h + e] + bf2f(bias[d + n + e]);
          y[e] = v * lnff::gelu(gt, gelu_exact);
        }
        *reinterpret_cast<uint32_t*>(out + m * d + n) = pack_bf16(y[0], y[1]);
      }
    }
}

}  // namespace

// x: (M, c); w: (2*d, c) = [value rows; gate rows]; bias: (2*d,); out: (M, d).
// All bf16, contiguous. exact: erf gelu, else tanh.
extern "C" int cak_geglu(const void* x, const void* w, const void* bias, void* out, int64_t M,
                         int c, int d, int exact, void* stream) {
  if (c % kBK || d % kBD || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), d / kBD);
  geglu_kernel<<<grid, lnff::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), M, c, d, exact);
  return static_cast<int>(cudaGetLastError());
}
