// The LayerNorm -> GEGLU feed-forward on Hopper, shared by K3 "full"
// (temporal_full.cu, twice per block) and K4 (ln_ff.cu); K5 (geglu.cu) runs on
// its weight ring (Ring) and its consumers' turns (PingPong):
//   acc = (value * gelu(gate)) . W2^T,   [value; gate] = A . Wg^T + bg,
// for a tile of 128 rows whose LayerNormed rows sit in shared memory (the A
// tile: bf16, 64-column blocks of 128 rows, 128-byte swizzled, the wgmma A
// operand). The caller adds b2 and the residual.
//
// - The producer (one thread) streams the FF's weights through a ring of
//   shared-memory slots by TMA (128-byte swizzle, a full and an empty mbarrier
//   per slot), in the order the consumers use them (load_ff_tile): per 64 inner
//   columns, value and gate rows 0..31 of the step (a 64-row tile of Wg), rows
//   32..63, then the W2 columns of the step (COUT rows x 64).
// - Two consumer warpgroups of 64 rows each (ff_products) run G = A . Wg^T on
//   wgmma (m64n64k16, both operands in shared memory: 32 value and 32 gate
//   columns), the GEGLU in registers, and acc += h . W2^T with h as the
//   register A operand (wgmma m64nCBk16, COUT in NO column blocks of CB); the
//   64 x COUT fp32 accumulator stays in registers across the inner width.
// - With kPingPong (K4) the two warpgroups take turns issuing their products
//   (named barriers 2 and 3), so one warpgroup's GEGLU runs on the CUDA cores
//   while the other's products run on the tensor cores; each product has its
//   own turn (first Wg half, second Wg half, W2), so no more than one
//   product's registers are in flight at a time, which keeps the consumers
//   within their 240 registers beside the 64 x COUT accumulator. K3 full, whose
//   ring has two slots, runs both warpgroups in step: turns would keep each
//   slot busy for longer, and its refills are what it waits for.
// Rounding is a template parameter. kBf16Steps rounds every product and bias
// add to bf16, as the TPU temporal kernel does (ops/fused_temporal.py:147-157);
// otherwise value, gate and h stay fp32 up to h, which is rounded once to
// bf16, as the TPU ln_ff_residual kernel does (ops/fused_block.py:96-100).
// gelu is the tanh form (the SFU's tanh) or, with the runtime flag `exact`
// (uniform across a launch), the erf form.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ffw {

constexpr int kRowBytes = 128;  // one swizzle atom: a row of 64 bf16 columns
constexpr int kTileRows = 128;  // rows of the A tile: two consumer warpgroups of 64

// The W2 product (and K3 full's out-projection) in kNO column blocks of
// kCB <= 160 (wgmma N).
template <int COUT>
struct OutBlocks {
  static constexpr int kNO = COUT == 320 ? 2 : (COUT == 256 ? 2 : (COUT == 192 ? 3 : 1));
  static constexpr int kCB = COUT / kNO;
};

// Tanh-approximated GELU (the bf16 rule of the TPU kernels) with the SFU's tanh
// (tanh.approx.f32, relative error ~2^-11, below the bf16 rounding that follows it).
__device__ __forceinline__ float gelu_fast(float g) {
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return 0.5f * g * (1.f + th);
}

// Exact GELU, 0.5 g (1 + erf(g / sqrt(2))), with erf from Abramowitz and Stegun
// 7.1.26 (|error| <= 1.5e-7, far below the bf16 rounding that follows) on the
// SFU's exp and reciprocal: no branches and few registers, where erff's
// branches would spill beside the 64 x COUT accumulator.
__device__ __forceinline__ float gelu_erf(float g) {
  const float x = fabsf(g) * 0.7071067811865476f;
  const float t = __fdividef(1.f, 1.f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f +
                                                                         t * 1.061405429f))));
  const float erf_x = 1.f - poly * __expf(-x * x);
  return 0.5f * g * (1.f + copysignf(erf_x, g));
}

template <bool kExact>
__device__ __forceinline__ float gelu(float g) {
  return kExact ? gelu_erf(g) : gelu_fast(g);
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024, 1);
}

template <int CB>
__device__ __forceinline__ void wgmma_rs_cb(float (&d)[CB / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (CB == 64) {
    wgmma_rs_n64<0>(d, a, db);
  } else if constexpr (CB == 128) {
    wgmma_rs_n128<0>(d, a, db);
  } else {
    wgmma_rs_n160<0>(d, a, db);
  }
}

template <int CB>
__device__ __forceinline__ void wgmma_ss_cb(float (&d)[CB / 2], uint64_t da, uint64_t db) {
  if constexpr (CB == 64) {
    wgmma_ss_n64<0>(d, da, db, 1);
  } else if constexpr (CB == 128) {
    wgmma_ss_n128<0>(d, da, db, 1);
  } else {
    wgmma_ss_n160<0>(d, da, db, 1);
  }
}

// A ring of `depth` slots of `slot_bytes`: the full mbarrier of slot s at
// bars + 8s (one arrival, the producer's, and the TMA bytes), the empty one at
// bars + 8 (depth + s) (one arrival per consumer warpgroup that reads the
// slot). Producer and consumers each keep their own copy, at the slot of their
// next tile (s) and that slot's phase parity.
struct Ring {
  uint32_t slots, bars;
  int depth, slot_bytes, s;
  uint32_t phase;

  __device__ Ring(uint32_t slots_, uint32_t bars_, int depth_, int slot_bytes_)
      : slots(slots_), bars(bars_), depth(depth_), slot_bytes(slot_bytes_), s(0), phase(0) {}

  // One thread, before the block's first barrier: `readers` consumer
  // warpgroups release each tile.
  __device__ void init(int readers) const {
    for (int i = 0; i < depth; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (depth + i), readers);
    }
  }

  __device__ uint32_t full_bar() const { return bars + 8 * s; }
  __device__ uint32_t empty_bar() const { return bars + 8 * (depth + s); }
  __device__ uint32_t slot() const { return slots + s * slot_bytes; }
  __device__ void advance() {
    const bool wrap = s + 1 == depth;
    s = wrap ? 0 : s + 1;
    phase ^= wrap;
  }

  // Producer: wait until the slot is free (in the first round the parity of
  // the phase before the barrier's first reads as complete), arm its full
  // barrier with the tile's bytes; then load into slot() on full_bar(), advance().
  __device__ uint32_t acquire(int bytes) const {
    mbar_wait(empty_bar(), phase ^ 1);
    mbar_expect_tx(full_bar(), bytes);
    return slot();
  }

  // Consumer: wait for the tile; release it (the leader thread of each
  // warpgroup arrives) once the products that read it are done.
  __device__ uint32_t wait() const {
    mbar_wait(full_bar(), phase);
    return slot();
  }
  __device__ void release(bool leader) {
    if (leader) mbar_arrive(empty_bar());
    advance();
  }
};

// With kOn, the two consumer warpgroups issue in turns (named barriers 2 and
// 3): of `total` turns, warpgroup 0 takes turns 0, 2, 4, ..., warpgroup 1
// turns 1, 3, ..., and each turn waits for the one before it. The arrive that
// no turn would wait for is skipped. Without kOn, begin() and end() do
// nothing.
template <bool kOn>
struct PingPong {
  int wc, next, total;  // next: the index of this warpgroup's next turn

  __device__ PingPong(int wc_, int total_) : wc(wc_), next(wc_), total(total_) {
    if (kOn && wc == 1 && total > 0) named_bar_arrive(2, 256);  // warpgroup 0's turn 0
  }
  __device__ void begin() const {
    if (kOn) named_bar_sync(2 + wc, 256);
  }
  __device__ void end() {
    if (!kOn) return;
    if (next + 1 < total) named_bar_arrive(3 - wc, 256);
    next += 2;
  }
};

// Weight tile u of an FF into the ring, in the order ff_products reads them:
// per 64 inner columns (step u / 3), the value and gate rows 0..31 of the
// step (part 0), rows 32..63 (part 1), then the step's W2 columns (part 2).
// An FF has 3 * inner / 64 tiles. wg: a 3-D map of Wg (2 * inner, c) as (c,
// inner, [value, gate]) with box {64, 32, 2}; w2: a 2-D map of W2 (COUT,
// inner) with box {64, kCB}.
template <int COUT>
__device__ __forceinline__ void load_ff_tile(Ring& ring, const CUtensorMap* wg,
                                             const CUtensorMap* w2, int c, int u) {
  constexpr int NO = OutBlocks<COUT>::kNO, CB = OutBlocks<COUT>::kCB;
  const int step = u / 3, part = u % 3;
  if (part < 2) {
    const uint32_t dst = ring.acquire(128 * c);
    for (int cb = 0; cb < c / 64; ++cb)
      tma_load_3d(dst + cb * 64 * kRowBytes, wg, ring.full_bar(), cb * 64, 64 * step + 32 * part,
                  0);
  } else {  // NO blocks of CB rows
    const uint32_t dst = ring.acquire(128 * COUT);
    for (int o = 0; o < NO; ++o)
      tma_load_2d(dst + o * CB * kRowBytes, w2, ring.full_bar(), 64 * step, o * CB);
  }
  ring.advance();
}

// h = value * gelu(gate) for 32 inner columns (half `half` of a 64-column
// step) from the Wg product g (columns 0..31 value, 32..63 gate), into the
// register A operand hf of the W2 product (k-steps 2 * half, 2 * half + 1).
// bv, bgt: this thread's value and gate bias pairs.
template <bool kBf16Steps, bool kExact>
__device__ __forceinline__ void geglu_regs(const float (&g)[32], uint32_t (&hf)[4][4], int half,
                                           const __nv_bfloat162 (&bv)[4],
                                           const __nv_bfloat162 (&bgt)[4]) {
#pragma unroll
  for (int jb = 0; jb < 4; ++jb)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float v0 = g[4 * jb + 2 * h2], v1 = g[4 * jb + 2 * h2 + 1];
      const float g0 = g[4 * (jb + 4) + 2 * h2], g1 = g[4 * (jb + 4) + 2 * h2 + 1];
      uint32_t out;
      if constexpr (kBf16Steps) {
        // value = bf16(bf16(x.Wv) + bv), gate likewise, h = bf16(value *
        // bf16(gelu(gate))): bf16 pair adds and products round once each
        const __nv_bfloat162 v2 = __hadd2(__floats2bfloat162_rn(v0, v1), bv[jb]);
        const float2 gt = __bfloat1622float2(__hadd2(__floats2bfloat162_rn(g0, g1), bgt[jb]));
        __nv_bfloat162 h = __hmul2(v2, __floats2bfloat162_rn(gelu<kExact>(gt.x), gelu<kExact>(gt.y)));
        out = *reinterpret_cast<uint32_t*>(&h);
      } else {
        const float2 bvf = __bfloat1622float2(bv[jb]), bgf = __bfloat1622float2(bgt[jb]);
        out = pack_bf16((v0 + bvf.x) * gelu<kExact>(g0 + bgf.x),
                        (v1 + bvf.y) * gelu<kExact>(g1 + bgf.y));
      }
      // n-block jb of the 32 columns: k-step jb / 2, register 2 * (jb % 2) + h2
      hf[2 * half + jb / 2][2 * (jb % 2) + h2] = out;
    }
}

// g = A . W^T over NB 64-column blocks (c = 64 NB): a0 this warpgroup's rows of
// the A tile, w a 64-row Wg tile; every k-step unrolled.
template <int NB>
__device__ __forceinline__ void wg_product(float (&g)[32], uint32_t a0, uint32_t w) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss_n64<0>(g, sw128_desc(a0 + (kk / 4) * kTileRows * kRowBytes + (kk % 4) * 32),
                    sw128_desc(w + (kk / 4) * 64 * kRowBytes + (kk % 4) * 32), kk > 0);
}

// acc += GEGLU(A . Wg^T + bg) . W2^T for this warpgroup's 64 rows (wc) of the
// A tile at sA (c in {64, ..., 320} columns, uniform across the launch), the
// FF's weights from the ring (inner / 64 steps of three tiles). bg: (2 *
// inner,) = [value; gate] bias. Both consumer warpgroups call it together.
template <int COUT, bool kBf16Steps, bool kPingPong>
__device__ __forceinline__ void ff_products(
    float (&acc)[OutBlocks<COUT>::kNO][OutBlocks<COUT>::kCB / 2], Ring& ring, uint32_t sA,
    int wc, int c, int inner, const bf16* __restrict__ bg, bool exact) {
  constexpr int NO = OutBlocks<COUT>::kNO, CB = OutBlocks<COUT>::kCB;
  const int t4 = threadIdx.x & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const int n_ff = inner / 64;
  auto fence_acc = [&]() {
#pragma unroll
    for (int o = 0; o < NO; ++o) fence_regs(acc[o]);
  };
  uint32_t hf[4][4];  // h, 64 rows x 64 inner columns: the A operand of W2
  float g[32];        // the Wg product of one half step
  auto issue_w2 = [&](uint32_t w) {
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs_cb<CB>(acc[o], hf[ks], sw128_desc(w + o * CB * kRowBytes + ks * 32));
  };
  // one straight run of wgmma per width (a k-step behind a test of c would
  // make ptxas fence every one); the switch is uniform across the launch
  auto issue_wg = [&](uint32_t w) {
    const uint32_t a0 = sA + wc * 64 * kRowBytes;
    switch (c / 64) {
      case 1: wg_product<1>(g, a0, w); break;
      case 2: wg_product<2>(g, a0, w); break;
      case 3: wg_product<3>(g, a0, w); break;
      case 4: wg_product<4>(g, a0, w); break;
      default: wg_product<5>(g, a0, w); break;
    }
  };

  PingPong<kPingPong> turns(wc, 2 * 3 * n_ff);
  for (int step = 0; step < n_ff; ++step) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // this thread's bias pairs, loaded before the products
      const int j0 = 64 * step + 32 * half + 2 * t4;
      __nv_bfloat162 bv[4], bgt[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        bv[jb] = *reinterpret_cast<const __nv_bfloat162*>(bg + j0 + 8 * jb);
        bgt[jb] = *reinterpret_cast<const __nv_bfloat162*>(bg + inner + j0 + 8 * jb);
      }
      const uint32_t w = ring.wait();  // the tile first, then the turn and the fence
      turns.begin();
      wgmma_fence();
      issue_wg(w);
      wgmma_commit();
      turns.end();
      wgmma_wait<0>();
      fence_regs(g);
      ring.release(leader);
      if (exact) {
        geglu_regs<kBf16Steps, true>(g, hf, half, bv, bgt);
      } else {
        geglu_regs<kBf16Steps, false>(g, hf, half, bv, bgt);
      }
    }
    const uint32_t w = ring.wait();
    turns.begin();
    fence_acc();
    fence_regs(hf);
    wgmma_fence();
    issue_w2(w);
    wgmma_commit();
    turns.end();
    wgmma_wait<0>();
    fence_acc();
    fence_regs(hf);
    ring.release(leader);
  }
}

}  // namespace ffw
