// K2: non-causal flash attention forward, softmax(Q K^T / sqrt(H)) V, bf16 in
// and out, fp32 softmax.
//
// Replaces: ctrl_adapter_tpu/ops/flash_attention.py, attention_bnth -> the
// Pallas TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention.
//
// What bounds it on the H100: flops. At the SVD shapes (T = 4096 or 1024,
// H = 64) one (b, n) pair does 4*T*T*H flops against 4*T*H*2 bytes of Q/K/V/O,
// i.e. ~T/2 flop per byte, far above the ~295 flop/byte ridge, so the tensor
// cores bound it (and, in this first version, the exp and the shared-memory
// traffic of the softmax). The T x T logits never reach device memory.
//
// Design: one CTA of 4 warps per (b*n, 64-row Q tile); each warp owns 16 query
// rows and keeps its Q fragments in registers for the whole pass. K/V tiles of
// 64 rows are double-buffered through shared memory with cp.async (rows padded
// by 8 elements against bank conflicts). Q K^T and P V run on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the S accumulator fragments
// are re-packed in registers as the A operand of P V, so P never touches
// shared memory. Online softmax in fp32 registers with exp2 and a per-row
// running max and sum. Inputs may be strided views with a unit last stride
// (e.g. (B, T, N, H) projections viewed as (B, N, T, H)), so the caller needs
// no head-split transposes. Shapes: T % 64 == 0, H in {64, 128}.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPad = 8;
constexpr int kThreads = 128;

template <int HD>
constexpr int smem_bytes() {
  return 2 /*stages*/ * 2 /*K,V*/ * kBK * (HD + kPad) * int(sizeof(bf16));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N, int T,
                     int64_t qsb, int64_t qsn, int64_t qst, int64_t ksb, int64_t ksn,
                     int64_t kst, int64_t vsb, int64_t vsn, int64_t vst, int64_t osb,
                     int64_t osn, int64_t ost, float scale_log2) {
  constexpr int LD = HD + kPad;
  constexpr int KF = HD / 16;  // k-steps over the head dim
  constexpr int DB = HD / 8;   // n-blocks of the output
  constexpr int SB = kBK / 8;  // n-blocks of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + 2 * kBK * LD;

  const int bh = blockIdx.y;
  const int b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + b * qsb + n * qsn;
  const bf16* kb = k + b * ksb + n * ksn;
  const bf16* vb = v + b * vsb + n * vsn;

  // Q fragments for rows r0 and r0 + 8 of this warp.
  const int r0 = q0 + warp * 16 + g;
  uint32_t qf[KF][4];
#pragma unroll
  for (int kk = 0; kk < KF; ++kk) {
    const bf16* p = qb + int64_t(r0) * qst + kk * 16 + 2 * t4;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * qst);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * qst + 8);
  }

  auto load_tile = [&](int stage, int kv0) {
    bf16* kd = ks + stage * kBK * LD;
    bf16* vd = vs + stage * kBK * LD;
    constexpr int CH = HD / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      cp_async16(kd + r * LD + c, kb + int64_t(kv0 + r) * kst + c);
      cp_async16(vd + r * LD + c, vb + int64_t(kv0 + r) * vst + c);
    }
    cp_async_commit();
  };

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
  float acc[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int n_tiles = T / kBK;
  load_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, (it + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kd = ks + st * kBK * LD;
    const bf16* vd = vs + st * kBK * LD;

    // S = Q K^T for 16 rows x 64 keys.
    float s[SB][4];
#pragma unroll
    for (int nb = 0; nb < SB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        uint32_t b0, b1;
        load_b_frag_nk(b0, b1, kd, LD, nb * 8, kk * 16, lane);
        mma_16816(s[nb], qf[kk], b0, b1);
      }
    }

    // Online softmax; h = 0 for row r0 (c0, c1), h = 1 for row r0 + 8 (c2, c3).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int nb = 0; nb < SB; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * h], s[nb][2 * h + 1]) * scale_log2);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_run[h] - mx);
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < SB; ++nb) {
        const float p0 = exp2f(s[nb][2 * h] * scale_log2 - mx);
        const float p1 = exp2f(s[nb][2 * h + 1] * scale_log2 - mx);
        s[nb][2 * h] = p0;
        s[nb][2 * h + 1] = p1;
        rs += p0 + p1;
      }
      l_run[h] = l_run[h] * alpha + rs;
      m_run[h] = mx;
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        acc[d][2 * h] *= alpha;
        acc[d][2 * h + 1] *= alpha;
      }
    }

    // O += P V; P's accumulator fragments become A fragments in registers.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        const bf16* vp = vd + (kk * 16 + 2 * t4) * LD + d * 8 + g;
        const uint32_t b0 = pack_bf16_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16_raw(vp[8 * LD], vp[9 * LD]);
        mma_16816(acc[d], a, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }

  bf16* ob = o + b * osb + n * osn;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = r0 + 8 * h;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      *reinterpret_cast<uint32_t*>(ob + int64_t(row) * ost + d * 8 + 2 * t4) =
          pack_bf16(acc[d][2 * h] * inv, acc[d][2 * h + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int N,
                   int T, const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(T / kBQ, B * N);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, T, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, N, T, H) bf16 views with unit last stride; strides (in
// elements) of the b, n and t axes for q, k, v, o in that order.
extern "C" int cak_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int N, int T, int H, int64_t qsb, int64_t qsn,
                                   int64_t qst, int64_t ksb, int64_t ksn, int64_t kst,
                                   int64_t vsb, int64_t vsn, int64_t vst, int64_t osb,
                                   int64_t osn, int64_t ost, float scale, void* stream) {
  const int64_t st[12] = {qsb, qsn, qst, ksb, ksn, kst, vsb, vsn, vst, osb, osn, ost};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (H == 64) {
    e = launch<64>(q, k, v, o, B, N, T, st, scale, s);
  } else if (H == 128) {
    e = launch<128>(q, k, v, o, B, N, T, st, scale, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
