// K3: the attention part of TemporalBasicTransformerBlock on (b, f, s, c):
//   out = x + to_out(attn_over_frames(LN1(x) Wq, LN1(x) Wk, LN1(x) Wv)) + cross_bias
//
// Replaces: ctrl_adapter_tpu/ops/fused_temporal.py, temporal_block ->
//   _pallas_temporal_block (Pallas body _kernel) in its "hybrid" mode, where
//   the kernel is the LN1 -> Q,K,V -> frame attention -> out-proj -> +residual
//   -> +cross-bias sub-block and the GEGLU feed-forwards stay plain ops.
//
// What bounds it on the H100: the projections. Per row of c channels the block
// does 2*c*ia*3 (QKV) + 2*ia*c (out) flops against ~4*c bytes of x/out, i.e.
// ~2*ia flop per byte (640-2560), above the ~295 flop/byte ridge, so tensor
// cores bound it; the frame attention itself (f <= 32 keys per query) is
// ~f/(2c) of the projection flops.
//
// Design, two launches:
//  (a) temporal_qkv_attn_kernel, one CTA of 8 warps per (spatial tile of TS
//      positions, head, batch). Its f*TS rows (<= 128) get LN1 statistics in
//      fp32 over the full c-row (two passes, var clamped at 0). The QKV
//      projection for the head streams over c in chunks of 64: each chunk of
//      LN1(x) (normalised, affine, rounded to bf16 like the reference) and of
//      the 192 rows of [Wq; Wk; Wv] for the head is staged in shared memory
//      and multiplied on mma.sync.m16n8k16 (fp32 accumulate), so a full
//      (f*TS) x c tile never has to fit in shared memory (it would not at
//      c = 1280). Q/K/V, rounded to bf16, then overwrite the same shared
//      memory, and each warp runs the f x f softmax attention of one
//      (position, query frame) at a time in fp32 (lane j scores key frame j;
//      common.cuh:frame_attention_64, shared with K3 "full"), writing O
//      (b, f, s, ia) in bf16. No masked dense (f*TS)^2 score matrix.
//  (b) out_proj_kernel: a tiled mma.sync GEMM (M = b*f*s, K = ia, N = c) whose
//      epilogue adds bo, the residual x and cross_bias[b, s], rounding to bf16
//      at the same points as the reference (ops/fused_temporal.py
//      _xla_temporal_block): bf16(o Wo), +bo, +x, +cross_bias.
// Shapes: head_dim 64, c % 64 == 0, f <= 32, s % TS == 0.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHD = 64;     // head dim
constexpr int kKC = 64;     // channels per streamed chunk
constexpr int kLD = 72;     // padded leading dim of staged tiles
constexpr int kNQKV = 192;  // 3 * head dim rows of [Wq; Wk; Wv] per head
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int MB>
constexpr int qkv_smem_bytes() {
  constexpr int mp = MB * 16;
  constexpr int phase1 = (mp + kNQKV) * kLD * 2;
  constexpr int phase2 = 3 * mp * kLD * 2;
  return 2 * 128 * 4 + (phase1 > phase2 ? phase1 : phase2);
}

template <int MB>
__global__ void __launch_bounds__(kThreads)
    temporal_qkv_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w,
                             const bf16* __restrict__ ln_b, const bf16* __restrict__ wq,
                             const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                             bf16* __restrict__ o, int f, int s, int c, int ia, int ts,
                             float eps, float scale) {
  constexpr int MP = MB * 16;
  constexpr int NB_PER_WARP = kNQKV / 8 / kWarps;  // 3
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* mean = reinterpret_cast<float*>(smem_raw);
  float* rstd = mean + 128;
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw + 2 * 128 * 4);
  bf16* as = tiles;             // phase 1: LN1(x) chunk, MP x kLD
  bf16* ws = tiles + MP * kLD;  // phase 1: weight chunk, kNQKV x kLD
  bf16* qs = tiles;             // phase 2: Q, K, V, each MP x kLD
  bf16* kss = tiles + MP * kLD;
  bf16* vs = tiles + 2 * MP * kLD;

  const int s0 = blockIdx.x * ts;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = f * ts;

  auto row_ptr = [&](int r) -> const bf16* {
    const int fi = r / ts, si = r % ts;
    return x + ((int64_t(bi) * f + fi) * s + s0 + si) * c;
  };

  // LN1 statistics per row: mean, then the mean squared deviation.
  for (int r = warp; r < rows; r += kWarps) {
    const bf16* xr = row_ptr(r);
    float acc = 0.f;
    for (int i = lane * 8; i < c; i += 256) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += bf2f(e[j]);
    }
    const float mu = warp_sum(acc) / c;
    float sq = 0.f;
    for (int i = lane * 8; i < c; i += 256) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = bf2f(e[j]) - mu;
        sq += d * d;
      }
    }
    const float var = fmaxf(warp_sum(sq) / c, 0.f);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  float acc[MB][NB_PER_WARP][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < NB_PER_WARP; ++j)
      acc[mb][j][0] = acc[mb][j][1] = acc[mb][j][2] = acc[mb][j][3] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kKC) {
    // Stage LN1(x)[:, k0:k0+64] (bf16, as the reference rounds it) ...
    for (int i = threadIdx.x; i < MP * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8), cc = (i % (kKC / 8)) * 8;
      uint4 outv = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        uint4 raw = *reinterpret_cast<const uint4*>(row_ptr(r) + k0 + cc);
        uint4 wraw = *reinterpret_cast<const uint4*>(ln_w + k0 + cc);
        uint4 braw = *reinterpret_cast<const uint4*>(ln_b + k0 + cc);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
        const bf16* we = reinterpret_cast<const bf16*>(&wraw);
        const bf16* be = reinterpret_cast<const bf16*>(&braw);
        bf16* ov = reinterpret_cast<bf16*>(&outv);
        const float mu = mean[r], rs = rstd[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ov[j] = f2bf((bf2f(e[j]) - mu) * rs * bf2f(we[j]) + bf2f(be[j]));
      }
      *reinterpret_cast<uint4*>(as + r * kLD + cc) = outv;
    }
    // ... and rows [head*64, head*64+64) of Wq, Wk, Wv (each (ia, c)).
    for (int i = threadIdx.x; i < kNQKV * (kKC / 8); i += kThreads) {
      const int nrow = i / (kKC / 8), cc = (i % (kKC / 8)) * 8;
      const int which = nrow / kHD, d = nrow % kHD;
      const bf16* w = which == 0 ? wq : (which == 1 ? wk : wv);
      *reinterpret_cast<uint4*>(ws + nrow * kLD + cc) =
          *reinterpret_cast<const uint4*>(w + int64_t(head * kHD + d) * c + k0 + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t bfr[NB_PER_WARP][2];
#pragma unroll
      for (int j = 0; j < NB_PER_WARP; ++j)
        load_b_frag_nk(bfr[j][0], bfr[j][1], ws, kLD, (warp * NB_PER_WARP + j) * 8, kk * 16,
                       lane);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        uint32_t a[4];
        load_a_frag(a, as, kLD, mb * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < NB_PER_WARP; ++j) mma_16816(acc[mb][j], a, bfr[j][0], bfr[j][1]);
      }
    }
    __syncthreads();
  }

  // Q, K, V rounded to bf16 into shared memory (overwrites the staging tiles).
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int j = 0; j < NB_PER_WARP; ++j) {
        const int col = (warp * NB_PER_WARP + j) * 8 + 2 * t4;
        const int which = col / kHD, d = col % kHD;
        bf16* dst = which == 0 ? qs : (which == 1 ? kss : vs);
        const int r = mb * 16 + g;
        *reinterpret_cast<uint32_t*>(dst + r * kLD + d) =
            pack_bf16(acc[mb][j][0], acc[mb][j][1]);
        *reinterpret_cast<uint32_t*>(dst + (r + 8) * kLD + d) =
            pack_bf16(acc[mb][j][2], acc[mb][j][3]);
      }
  }
  __syncthreads();

  // Frame attention: one (position si, query frame i) per warp iteration.
  frame_attention_64(qs, kss, vs, kLD, f, ts, scale, kWarps,
                     [&](int r, int l, float o0, float o1) {
                       bf16* orow = o + ((int64_t(bi) * f + r / ts) * s + s0 + r % ts) * ia +
                                    head * kHD;
                       orow[l] = f2bf(o0);
                       orow[l + 32] = f2bf(o1);
                     });
}

constexpr int kBM = 64, kBN = 64, kBKo = 32, kLDo = kBKo + 8;

// out = bf16(bf16(bf16(bf16(O Wo^T) + bo) + x) + cross_bias[b, s])
__global__ void __launch_bounds__(128)
    out_proj_kernel(const bf16* __restrict__ om, const bf16* __restrict__ wo,
                    const bf16* __restrict__ bo, const bf16* __restrict__ x,
                    const bf16* __restrict__ cross_bias, bf16* __restrict__ out, int64_t M,
                    int N, int K, int fs, int s) {
  __shared__ __align__(16) bf16 as[kBM * kLDo];
  __shared__ __align__(16) bf16 bs[kBN * kLDo];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBKo) {
    for (int i = threadIdx.x; i < kBM * (kBKo / 8); i += 128) {
      const int r = i / (kBKo / 8), cc = (i % (kBKo / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(om + (m0 + r) * K + k0 + cc);
      *reinterpret_cast<uint4*>(as + r * kLDo + cc) = v;
      *reinterpret_cast<uint4*>(bs + r * kLDo + cc) =
          *reinterpret_cast<const uint4*>(wo + int64_t(n0 + r) * K + k0 + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKo / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, as, kLDo, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        uint32_t b0, b1;
        load_b_frag_nk(b0, b1, bs, kLDo, j * 8, kk * 16, lane);
        mma_16816(acc[j], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t m = m0 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
    const int64_t bi = m / fs;
    const int si = int(m % s);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * t4;
      float r2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float y = round_bf16(acc[j][2 * h + e]);
        y = round_bf16(y + bf2f(bo[n + e]));
        y = round_bf16(bf2f(x[m * N + n + e]) + y);
        if (cross_bias != nullptr)
          y = round_bf16(y + bf2f(cross_bias[(bi * s + si) * N + n + e]));
        r2[e] = y;
      }
      *reinterpret_cast<uint32_t*>(out + m * N + n) = pack_bf16(r2[0], r2[1]);
    }
  }
}

template <int MB>
cudaError_t launch_qkv(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                       const void* wk, const void* wv, void* o, int b, int f, int s, int c,
                       int heads, int ts, float eps, float scale, cudaStream_t st) {
  constexpr int smem = qkv_smem_bytes<MB>();
  cudaError_t e = cudaFuncSetAttribute(temporal_qkv_attn_kernel<MB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(s / ts, heads, b);
  temporal_qkv_attn_kernel<MB><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv), static_cast<bf16*>(o), f, s,
      c, heads * kHD, ts, eps, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, f, s, c); ln_w, ln_b, bo: (c,); wq, wk, wv: (heads*64, c);
// wo: (c, heads*64); o: (b, f, s, heads*64) scratch; cross_bias: (b, s, c) or
// null. All bf16, contiguous. ts divides s, f * ts <= 128, f <= 32, c % 64 == 0.
extern "C" int cak_temporal_attention(const void* x, const void* ln_w, const void* ln_b,
                                      const void* wq, const void* wk, const void* wv,
                                      void* o, const void* wo, const void* bo,
                                      const void* cross_bias, void* out, int b, int f,
                                      int s, int c, int heads, int ts, float eps,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mb = (f * ts + 15) / 16;
  cudaError_t e;
  switch (mb) {
#define CAK_QKV_CASE(MBV)                                                                  \
  case MBV:                                                                                \
    e = launch_qkv<MBV>(x, ln_w, ln_b, wq, wk, wv, o, b, f, s, c, heads, ts, eps, scale, \
                        st);                                                               \
    break;
    CAK_QKV_CASE(1)
    CAK_QKV_CASE(2)
    CAK_QKV_CASE(3)
    CAK_QKV_CASE(4)
    CAK_QKV_CASE(5)
    CAK_QKV_CASE(6)
    CAK_QKV_CASE(7)
    CAK_QKV_CASE(8)
#undef CAK_QKV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t M = int64_t(b) * f * s;
  const int ia = heads * kHD;
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), c / kBN);
  out_proj_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(x), static_cast<const bf16*>(cross_bias),
      static_cast<bf16*>(out), M, c, ia, f * s, s);
  return static_cast<int>(cudaGetLastError());
}
