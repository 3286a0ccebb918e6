// Device pieces of the LayerNorm -> GEGLU feed-forward sub-block, shared by K4
// (ln_ff.cu) and K3 "full" (temporal_full.cu), which run the same
// LN -> [value; gate] -> value * gelu(gate) -> W2 computation on rows of a
// different origin.
//
// One CTA of 8 warps owns a tile of kRows = 64 rows with all of their channels:
// a row's LayerNorm needs the whole row, and the (rows, 8C) GEGLU intermediate
// never leaves the CTA. LN(x) sits in shared memory as bf16; the GEGLU weights
// stream through a ring of two shared-memory slots (cp.async, the next tile
// loading while the current one is multiplied) in chunks of kKI inner columns:
//   - a "rows" tile: the kKI value rows and the kKI gate rows of Wg (2*kKI x C),
//   - an "out" tile: kKI columns of W2 for every output channel (Cout x kKI).
// The (64 x Cout) fp32 accumulator of W2 lives in registers: warp (wm, wn) =
// (warp % 4, warp / 4) holds rows wm*16..+16 and columns wn*Cout/2..+Cout/2,
// NT = Cout/16 mma n-tiles of 8. Products run on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate), fragments come from ldmatrix.
#pragma once

#include <math.h>

#include "common.cuh"

namespace lnff {

constexpr int kRows = 64;       // rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKI = 32;         // inner columns per streamed chunk
constexpr int kLDI = kKI + 8;   // leading dim of an (x, kKI) tile

// Leading dim of a (x, c) tile: rows 16 bytes apart modulo 128, so the eight
// rows an ldmatrix reads fall in distinct banks.
__host__ __device__ constexpr int ld_of(int c) { return c + 8; }

// Elements of one ring slot: a rows tile (64 x c) or an out tile (cout x kKI).
__host__ __device__ constexpr int slot_elems(int c, int cout) {
  return kRows * ld_of(c) > cout * kLDI ? kRows * ld_of(c) : cout * kLDI;
}

__device__ __forceinline__ float gelu(float g, bool exact) {
  if (exact) return 0.5f * g * (1.f + erff(g * 0.7071067811865476f));
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

// rows x cols bf16 (cols % 8 == 0, 16-byte aligned rows) from global memory
// (row stride lds) into shared memory (row stride ldd), 16 bytes per cp.async.
__device__ __forceinline__ void async_tile(bf16* dst, int ldd, const bf16* src, int64_t lds,
                                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, cc = (i % per_row) * 8;
    cp_async16(dst + r * ldd + cc, src + r * lds + cc);
  }
}

// Stream n weight tiles through the two slots: issue(t, slot) starts the
// cp.async copies of tile t, compute(t, slot) uses it once it has landed.
// Every thread of the CTA calls this with the same n.
template <class Issue, class Compute>
__device__ __forceinline__ void stream_tiles(int n, bf16* slot0, bf16* slot1, Issue issue,
                                             Compute compute) {
  issue(0, slot0);
  cp_async_commit();
  for (int t = 0; t < n; ++t) {
    bf16* cur = (t & 1) ? slot1 : slot0;
    if (t + 1 < n) {
      issue(t + 1, (t & 1) ? slot0 : slot1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(t, cur);
    __syncthreads();
  }
}

// LayerNorm of the tile's rows into a_s (bf16, row stride lda): fp32
// statistics, two passes (mean, then mean squared deviation clamped at 0),
// y = (x - mean) * rstd * w + b rounded to bf16. row(r) points at row r
// (global or shared memory); rows >= nrows are zero. c % 8 == 0.
template <class Row>
__device__ __forceinline__ void layer_norm_tile(bf16* a_s, int lda, Row row, int nrows, int c,
                                                const bf16* __restrict__ w,
                                                const bf16* __restrict__ b, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    bf16* dst = a_s + r * lda;
    if (r >= nrows) {
      for (int i = lane * 8; i < c; i += 256)
        *reinterpret_cast<uint4*>(dst + i) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16* xr = row(r);
    float acc = 0.f;
    for (int i = lane * 8; i < c; i += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += bf2f(e[j]);
    }
    const float mu = warp_sum(acc) / c;
    float sq = 0.f;
    for (int i = lane * 8; i < c; i += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = bf2f(e[j]) - mu;
        sq += d * d;
      }
    }
    const float rs = rsqrtf(fmaxf(warp_sum(sq) / c, 0.f) + eps);
    for (int i = lane * 8; i < c; i += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const uint4 braw = *reinterpret_cast<const uint4*>(b + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      const bf16* we = reinterpret_cast<const bf16*>(&wraw);
      const bf16* be = reinterpret_cast<const bf16*>(&braw);
      uint4 outv;
      bf16* ov = reinterpret_cast<bf16*>(&outv);
#pragma unroll
      for (int j = 0; j < 8; ++j) ov[j] = f2bf((bf2f(e[j]) - mu) * rs * bf2f(we[j]) + bf2f(be[j]));
      *reinterpret_cast<uint4*>(dst + i) = outv;
    }
  }
}

// Column of n-tile i (0..3) of warp column wn in a 64-column product: the
// warp holds columns wn*16..+16 of both 32-column halves, so the value and
// gate halves of a GEGLU chunk land in the same thread.
__device__ __forceinline__ int rows64_col(int i, int wn) {
  return (i >> 1) * 32 + wn * 16 + (i & 1) * 8;
}

// acc[i] += A[wm*16..+16, 0:c] . W[rows64_col(i, wn)..+8, 0:c]^T for a 64-row
// weight tile W (row-major, k = c contiguous) in shared memory.
__device__ __forceinline__ void mma_rows64(float (&acc)[4][4], const bf16* a_s, int lda,
                                           const bf16* w_s, int ldw, int c, int wm, int wn,
                                           int lane) {
#pragma unroll 4
  for (int k0 = 0; k0 < c; k0 += 16) {
    uint32_t a[4], b[4];
    ldmatrix_a(a, a_s, lda, wm * 16, k0, lane);
    ldmatrix_b2(b, w_s, ldw, wn * 16, k0, lane);
    mma_16816(acc[0], a, b[0], b[1]);
    mma_16816(acc[1], a, b[2], b[3]);
    ldmatrix_b2(b, w_s, ldw, 32 + wn * 16, k0, lane);
    mma_16816(acc[2], a, b[0], b[1]);
    mma_16816(acc[3], a, b[2], b[3]);
  }
}

// acc[j] += H[wm*16..+16, 0:kk] . W[(wn*NT + j)*8..+8, 0:kk]^T: the W2 (or
// out-projection) product of one chunk, W an (NT*16 x kk) tile.
template <int NT>
__device__ __forceinline__ void mma_out(float (&acc)[NT][4], const bf16* h_s, int ldh,
                                        const bf16* w_s, int ldw, int kk, int wm, int wn,
                                        int lane) {
  for (int k0 = 0; k0 < kk; k0 += 16) {
    uint32_t a[4];
    ldmatrix_a(a, h_s, ldh, wm * 16, k0, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_b2(b, w_s, ldw, (wn * NT + j) * 8, k0, lane);
      mma_16816(acc[j], a, b[0], b[1]);
      mma_16816(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// h = value * gelu(gate) of one chunk (inner columns j0..j0+kKI) into h_s
// (64 x kKI, row stride kLDI). kBf16Steps rounds as the TPU's temporal kernel
// does (every product and bias add in bf16: ops/fused_temporal.py:147-157);
// otherwise fp32 up to h, as its ln_ff_residual kernel (ops/fused_block.py:96-100).
template <bool kBf16Steps>
__device__ __forceinline__ void geglu_to_smem(const float (&acc)[4][4], bf16* h_s,
                                              const bf16* __restrict__ bg, int inner, int j0,
                                              bool exact, int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = wn * 16 + i * 8 + 2 * t;
    const float bv[2] = {bf2f(bg[j0 + col]), bf2f(bg[j0 + col + 1])};
    const float bgt[2] = {bf2f(bg[inner + j0 + col]), bf2f(bg[inner + j0 + col + 1])};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = acc[i][2 * h + e], gt = acc[2 + i][2 * h + e];
        if (kBf16Steps) {
          v = round_bf16(round_bf16(v) + bv[e]);
          gt = round_bf16(round_bf16(gt) + bgt[e]);
          out[e] = v * round_bf16(gelu(gt, exact));
        } else {
          out[e] = (v + bv[e]) * gelu(gt + bgt[e], exact);
        }
      }
      *reinterpret_cast<uint32_t*>(h_s + (wm * 16 + g + 8 * h) * kLDI + col) =
          pack_bf16(out[0], out[1]);
    }
  }
}

// The feed-forward of the tile: acc = GEGLU(a_s) . W2^T over all inner chunks
// (no bias), with a_s = LN(x) (64 x c, row stride ld_of(c)). wg: (2*inner, c)
// = [value rows; gate rows], bg: (2*inner,), w2: (NT*16, inner), all bf16 in
// nn.Linear layout. Slots hold slot_elems(c, NT*16) elements each; h_s 64 x kLDI.
template <int NT, bool kBf16Steps>
__device__ __forceinline__ void ff_tile(float (&acc)[NT][4], const bf16* a_s, int c,
                                        bf16* slot0, bf16* slot1, bf16* h_s,
                                        const bf16* __restrict__ wg,
                                        const bf16* __restrict__ bg,
                                        const bf16* __restrict__ w2, int inner, bool exact) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2;
  const int ld = ld_of(c);
  zero_acc(acc);
  stream_tiles(
      2 * (inner / kKI), slot0, slot1,
      [&](int t, bf16* dst) {
        const int j0 = (t >> 1) * kKI;
        if ((t & 1) == 0) {
          async_tile(dst, ld, wg + int64_t(j0) * c, c, kKI, c);
          async_tile(dst + kKI * ld, ld, wg + int64_t(inner + j0) * c, c, kKI, c);
        } else {
          async_tile(dst, kLDI, w2 + j0, inner, NT * 16, kKI);
        }
      },
      [&](int t, const bf16* w_s) {
        if ((t & 1) == 0) {
          float g4[4][4];
          zero_acc(g4);
          mma_rows64(g4, a_s, ld, w_s, ld, c, wm, wn, lane);
          geglu_to_smem<kBf16Steps>(g4, h_s, bg, inner, (t >> 1) * kKI, exact, wm, wn, lane);
        } else {
          mma_out<NT>(acc, h_s, kLDI, w_s, kLDI, kKI, wm, wn, lane);
        }
      });
}

}  // namespace lnff
