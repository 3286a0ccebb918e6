// The frame attention of the temporal transformer block on mma.sync, shared by
// K3 "full" (temporal_full.cu) and K3 "hybrid" (temporal_attention.cu): per
// (position, head), the f <= 32 query frames against the f key frames.
//
// Q, K and V sit in shared memory as 128-byte rows of 64 bf16 columns (one
// head), swizzled as TMA's and wgmma's 128-byte mode lays them out (16-byte
// chunks XOR row % 8), with the frames of one position in consecutive rows.
#pragma once

#include "common.cuh"

constexpr int kAtom = 128;  // bytes of one swizzled row of 64 bf16 columns

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte rows
// swizzled as TMA's 128-byte mode does: chunks XOR row % 8.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kAtom + ((chunk ^ (row % 8)) << 4);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// One warp, one position: the f query rows base .. base + f - 1 of Q against
// the key rows base .. base + f - 1 of K (16-row query tiles, 8-key blocks;
// keys >= f masked), softmax per query row across the 4 lanes that hold it,
// then P . V. sq, sk, sv are shared addresses; the rows up to base + 15 (f <=
// 16) or base + 31 must be finite. Rounds as the TPU kernel does: bf16 logits,
// times the scale in bf16, fp32 softmax (the SFU's exp, one reciprocal per
// row), bf16 probabilities, fp32 P . V.
// out(i, d, o0, o1) gets dims d, d + 1 of query frame i; a query tile's rows
// of Q are read before any of its outputs is passed on.
template <class Out>
__device__ __forceinline__ void frame_attention_position(uint32_t sq, uint32_t sk, uint32_t sv,
                                                         int base, int f, float scale,
                                                         Out out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m_tiles = (f + 15) / 16;  // 16-row query tiles (and 16-key P . V steps)
  for (int mt = 0; mt < m_tiles; ++mt) {
    float sc[4][4];  // logits: 16 rows x 32 keys
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sq + swz(base + 16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int nb = 0; nb < 4; nb += 2) {
        if (8 * nb < f) {
          uint32_t b[4];
          ldsm_x4(b, sk + swz(base + 8 * nb + (lane & 7) + (lane >> 4) * 8,
                              2 * kk + ((lane >> 3) & 1)));
          mma_16816(sc[nb], a, b[0], b[1]);
          mma_16816(sc[nb + 1], a, b[2], b[3]);
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 8 * nb + 2 * t4 + (i & 1);
        const float l = key < f ? round_bf16(round_bf16(sc[nb][i]) * scale) : -INFINITY;
        sc[nb][i] = l;
        mx[i >> 1] = fmaxf(mx[i >> 1], l);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = __expf(sc[nb][i] - mx[i >> 1]);  // ex2.approx: ~2 ulp
        sc[nb][i] = e;
        sum[i >> 1] += e;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    uint32_t pa[2][4];  // bf16 P as the A operand, keys 16*ks ..
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      pa[ks][0] = pack_bf16(sc[2 * ks][0] * inv[0], sc[2 * ks][1] * inv[0]);
      pa[ks][1] = pack_bf16(sc[2 * ks][2] * inv[1], sc[2 * ks][3] * inv[1]);
      pa[ks][2] = pack_bf16(sc[2 * ks + 1][0] * inv[0], sc[2 * ks + 1][1] * inv[0]);
      pa[ks][3] = pack_bf16(sc[2 * ks + 1][2] * inv[1], sc[2 * ks + 1][3] * inv[1]);
    }
#pragma unroll
    for (int db = 0; db < 8; db += 2) {  // output dims 8*db .. 8*db + 15
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (16 * ks < f) {
          uint32_t b[4];
          ldsm_x4_trans(b, sv + swz(base + 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    db + (lane >> 4)));
          mma_16816(o[0], pa[ks], b[0], b[1]);
          mma_16816(o[1], pa[ks], b[2], b[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * mt + g + 8 * h;
        if (i < f) {
          out(i, 8 * db + 2 * t4, o[0][2 * h], o[0][2 * h + 1]);
          out(i, 8 * db + 8 + 2 * t4, o[1][2 * h], o[1][2 * h + 1]);
        }
      }
    }
  }
}
