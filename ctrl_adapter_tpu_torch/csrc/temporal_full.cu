// K3 "full": the whole TemporalBasicTransformerBlock on (b, f, s, c) in one launch,
//   cur = x + FF_in(LN_in(x))
//   cur = cur + to_out(attn_over_frames(LN1(cur))) + bo (+ cross_bias[b, s])
//   out = cur + FF(LN3(cur))
// with FF(y) = W2 . (value * gelu(gate)) + b2, [value; gate] = y . Wg^T + bg.
//
// Replaces: ctrl_adapter_tpu/ops/fused_temporal.py, temporal_block ->
//   _pallas_temporal_block (Pallas body _kernel) in its "full" mode, parts
//   ("ffin", "attn", "ff") in one pallas_call: the activation is read once and
//   written once, and every intermediate stays on chip.
//
// What bounds it on the H100: per row 2*(2*8c*c + 4c*c) (two FFs) + 8*c*ia
// (projections) flops against 4*c bytes of x and out: ~660 GFLOP per block at
// (2, 14, 4096, 320), above the ridge, so tensor cores bound it in principle.
// In this first design every CTA re-reads all of the block's weights (5.75 MB
// at c = 320) from L2, 2,048 times at the main path's shape, and mma.sync
// reaches only part of the wgmma peak; larger tiles, TMA and wgmma come later.
//
// Design: one CTA of 8 warps per (tile of ts positions, batch): its f*ts <= 64
// rows (row r = frame r / ts, position r % ts; padded to 64) keep all c
// channels. The residual stream lives in shared memory as bf16 (cur_s, the
// TPU kernel rounds it to bf16 after every part). Each part LayerNorms cur_s
// into a_s (fp32 statistics) and streams its weights through the two-slot
// cp.async ring of ln_ff.cuh:
//  - the FFs run ff_tile (chunks of 32 inner columns, fp32 accumulator of
//    64 x c in registers);
//  - the attention streams, per head, the 64 rows of Wq, Wk and Wv (Q, K, V
//    land in shared memory as bf16), then runs the frame attention of every
//    (position, query frame) one warp at a time (lane j scores key frame j,
//    fp32 softmax; common.cuh:frame_attention_64, shared with K3 hybrid), then
//    streams the head's 64 columns of Wo and adds O_h . Wo_h^T to the same
//    register accumulator.
// Rounding follows the TPU kernel (ops/fused_temporal.py:147-157, 193): every
// product is rounded to bf16 and every bias and residual add is a bf16 add.
// Shapes: head_dim 64, c in {64, ..., 320} (c % 64 == 0), inner % 32 == 0,
// f * ts <= 64, s % ts == 0.
#include "ln_ff.cuh"

namespace {

using namespace lnff;

constexpr int kHD = 64;         // head dim
constexpr int kLDH = kHD + 8;   // leading dim of the Q, K, V and O tiles

struct FFW {
  const bf16 *ln_w, *ln_b, *wg, *bg, *w2, *b2;
};
struct AttnW {
  const bf16 *ln_w, *ln_b, *wq, *wk, *wv, *wo, *bo;
};

__host__ __device__ constexpr int full_smem_elems(int c) {
  return 2 * kRows * ld_of(c) + 2 * slot_elems(c, c) + 4 * kRows * kLDH;
}

// cur = bf16(bf16(acc) + b) + cur [+ cross_bias] on the tile's real rows:
// the FFs' y + cur with y = bf16(h . W2) + b2, or the attention's
// (cur + bf16(o . Wo)) + bo (+ cb), each add rounded to bf16.
template <int NT, bool kAttn>
__device__ __forceinline__ void add_to_stream(const float (&acc)[NT][4], bf16* cur_s, int ld,
                                              const bf16* __restrict__ bias,
                                              const bf16* __restrict__ cb, int rows, int ts,
                                              int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * 16 + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = (wn * NT + j) * 8 + 2 * t;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(cur_s + r * ld + n);
      const __nv_bfloat162 cv = *p;
      const float cur[2] = {bf2f(cv.x), bf2f(cv.y)};
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float prod = round_bf16(acc[j][2 * h + e]);
        const float bn = bf2f(bias[n + e]);
        if (kAttn) {
          y[e] = round_bf16(round_bf16(cur[e] + prod) + bn);
          if (cb != nullptr) y[e] = round_bf16(y[e] + bf2f(cb[(r % ts) * c + n + e]));
        } else {
          y[e] = round_bf16(round_bf16(prod + bn) + cur[e]);
        }
      }
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(y[0], y[1]);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    temporal_full_kernel(const bf16* __restrict__ x, FFW ffin, AttnW at, FFW ff,
                         const bf16* __restrict__ cross_bias, bf16* __restrict__ out, int f,
                         int s, int heads, int inner, int ts, int exact, float eps,
                         float scale) {
  constexpr int c = NT * 16;
  constexpr int ld = ld_of(c);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cur_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* a_s = cur_s + kRows * ld;
  bf16* slot0 = a_s + kRows * ld;
  bf16* slot1 = slot0 + slot_elems(c, c);
  bf16* h_s = slot1 + slot_elems(c, c);  // GEGLU chunk (64 x kLDI) or O_h (64 x kLDH)
  bf16* q_s = h_s + kRows * kLDH;
  bf16* k_s = q_s + kRows * kLDH;
  bf16* v_s = k_s + kRows * kLDH;

  const int s0 = blockIdx.x * ts, bi = blockIdx.y;
  const int rows = f * ts;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const bool gelu_exact = exact != 0;
  auto grow = [&](int r) -> int64_t { return (int64_t(bi) * f + r / ts) * s + s0 + r % ts; };

  for (int i = threadIdx.x; i < kRows * (c / 8); i += kThreads) {
    const int r = i / (c / 8), cc = (i % (c / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(x + grow(r) * c + cc);
    *reinterpret_cast<uint4*>(cur_s + r * ld + cc) = v;
  }
  __syncthreads();
  auto norm = [&](const bf16* w, const bf16* b) {
    layer_norm_tile(a_s, ld, [&](int r) -> const bf16* { return cur_s + r * ld; }, rows, c, w,
                    b, eps);
  };

  float acc[NT][4];
  // ffin: cur = x + FF_in(LN_in(x))
  norm(ffin.ln_w, ffin.ln_b);
  ff_tile<NT, true>(acc, a_s, c, slot0, slot1, h_s, ffin.wg, ffin.bg, ffin.w2, inner,
                    gelu_exact);
  add_to_stream<NT, false>(acc, cur_s, ld, ffin.b2, nullptr, rows, ts, c);
  __syncthreads();

  // attn: per head, tiles Wq_h, Wk_h, Wv_h (64 x c) and Wo[:, h*64 + {0, 32}] (c x 32)
  norm(at.ln_w, at.ln_b);
  zero_acc(acc);
  const int ia = heads * kHD;
  stream_tiles(
      5 * heads, slot0, slot1,
      [&](int tile, bf16* dst) {
        const int h = tile / 5, part = tile % 5;
        if (part < 3) {
          const bf16* w = part == 0 ? at.wq : (part == 1 ? at.wk : at.wv);
          async_tile(dst, ld, w + int64_t(h * kHD) * c, c, kHD, c);
        } else {
          async_tile(dst, kLDI, at.wo + h * kHD + (part - 3) * kKI, ia, c, kKI);
        }
      },
      [&](int tile, const bf16* w_s) {
        const int part = tile % 5;
        if (part < 3) {
          float p4[4][4];
          zero_acc(p4);
          mma_rows64(p4, a_s, ld, w_s, ld, c, wm, wn, lane);
          bf16* dst = part == 0 ? q_s : (part == 1 ? k_s : v_s);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = rows64_col(i, wn) + 2 * t4;
            const int r = wm * 16 + g;
            *reinterpret_cast<uint32_t*>(dst + r * kLDH + col) = pack_bf16(p4[i][0], p4[i][1]);
            *reinterpret_cast<uint32_t*>(dst + (r + 8) * kLDH + col) =
                pack_bf16(p4[i][2], p4[i][3]);
          }
        } else {
          if (part == 3) {
            frame_attention_64(q_s, k_s, v_s, kLDH, f, ts, scale, kWarps,
                               [&](int r, int l, float o0, float o1) {
                                 h_s[r * kLDH + l] = f2bf(o0);
                                 h_s[r * kLDH + l + 32] = f2bf(o1);
                               });
            __syncthreads();
          }
          mma_out<NT>(acc, h_s + (part - 3) * kKI, kLDH, w_s, kLDI, kKI, wm, wn, lane);
        }
      });
  add_to_stream<NT, true>(acc, cur_s, ld, at.bo,
                          cross_bias == nullptr ? nullptr
                                                : cross_bias + (int64_t(bi) * s + s0) * c,
                          rows, ts, c);
  __syncthreads();

  // ff: out = cur + FF(LN3(cur))
  norm(ff.ln_w, ff.ln_b);
  ff_tile<NT, true>(acc, a_s, c, slot0, slot1, h_s, ff.wg, ff.bg, ff.w2, inner, gelu_exact);
  add_to_stream<NT, false>(acc, cur_s, ld, ff.b2, nullptr, rows, ts, c);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * (c / 8); i += kThreads) {
    const int r = i / (c / 8), cc = (i % (c / 8)) * 8;
    *reinterpret_cast<uint4*>(out + grow(r) * c + cc) =
        *reinterpret_cast<const uint4*>(cur_s + r * ld + cc);
  }
}

template <int NT>
cudaError_t launch(const void* x, const FFW& ffin, const AttnW& at, const FFW& ff,
                   const void* cross_bias, void* out, int b, int f, int s, int heads, int inner,
                   int ts, int exact, float eps, float scale, cudaStream_t st) {
  constexpr int smem = full_smem_elems(NT * 16) * 2;
  cudaError_t e = cudaFuncSetAttribute(temporal_full_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(s / ts, b);
  temporal_full_kernel<NT><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), ffin, at, ff, static_cast<const bf16*>(cross_bias),
      static_cast<bf16*>(out), f, s, heads, inner, ts, exact, eps, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, f, s, c); LayerNorm weights (c,); FF weights wg (2*inner, c),
// bg (2*inner,), w2 (c, inner), b2 (c,); wq, wk, wv (heads*64, c); wo
// (c, heads*64); bo (c,); cross_bias (b, s, c) or null. All bf16, contiguous.
extern "C" int cak_temporal_full(
    const void* x, const void* lnin_w, const void* lnin_b, const void* ffin_wg,
    const void* ffin_bg, const void* ffin_w2, const void* ffin_b2, const void* ln1_w,
    const void* ln1_b, const void* wq, const void* wk, const void* wv, const void* wo,
    const void* bo, const void* ln3_w, const void* ln3_b, const void* ff_wg, const void* ff_bg,
    const void* ff_w2, const void* ff_b2, const void* cross_bias, void* out, int b, int f,
    int s, int c, int heads, int inner, int ts, int exact, float eps, float scale,
    void* stream) {
  auto p = [](const void* v) { return static_cast<const bf16*>(v); };
  const FFW ffin{p(lnin_w), p(lnin_b), p(ffin_wg), p(ffin_bg), p(ffin_w2), p(ffin_b2)};
  const AttnW at{p(ln1_w), p(ln1_b), p(wq), p(wk), p(wv), p(wo), p(bo)};
  const FFW ff{p(ln3_w), p(ln3_b), p(ff_wg), p(ff_bg), p(ff_w2), p(ff_b2)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f * ts > kRows || f > 32 || s % ts || inner % kKI || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
#define CAK_FULL_CASE(C)                                                                     \
  case C:                                                                                    \
    return static_cast<int>(launch<C / 16>(x, ffin, at, ff, cross_bias, out, b, f, s, heads, \
                                           inner, ts, exact, eps, scale, st));
    CAK_FULL_CASE(64)
    CAK_FULL_CASE(128)
    CAK_FULL_CASE(192)
    CAK_FULL_CASE(256)
    CAK_FULL_CASE(320)
#undef CAK_FULL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
