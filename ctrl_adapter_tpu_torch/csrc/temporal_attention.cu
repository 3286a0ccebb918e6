// K3 "hybrid": the attention part of TemporalBasicTransformerBlock on (b, f, s, c):
//   out = x + to_out(attn_over_frames(LN1(x) Wq, LN1(x) Wk, LN1(x) Wv)) + bo (+ cross_bias[b, s])
//
// Replaces: ctrl_adapter_tpu/ops/fused_temporal.py, temporal_block ->
//   _pallas_temporal_block (Pallas body _kernel) in its "hybrid" mode, where
//   the kernel is the LN1 -> Q,K,V -> frame attention -> out-proj -> +residual
//   -> +cross-bias sub-block and the GEGLU feed-forwards stay plain ops.
//
// What bounds it on the H100: the projections. Per row of c channels the block
// does 2*c*ia*3 (QKV) + 2*ia*c (out) flops against ~4*c bytes of x and out,
// ~2*ia flop per byte (640-2560), above the ~295 flop/byte ridge: the tensor
// cores bound it. The frame attention (f <= 32 keys per query) is ~f/(2c) of
// the projection flops but runs on mma.sync and the CUDA cores.
//
// Design, two launches; the host plan (ops/fused_temporal.py:hybrid_plan)
// fixes the tile, the head groups, the grids and the shared memory, and
// cak_temporal_attention refuses a plan that differs from HybridCfg / OutCfg.
//  (a) hybrid_qkv_attn_kernel: one CTA of 288 threads per tile of ts positions
//      and group of heads, 128 tile rows: row p * fp + i is frame i of position
//      p (fp = f rounded up to 16; rows with i >= f are zero padding), so each
//      consumer warpgroup's 64 rows hold whole positions. The producer warp
//      loads the raw x tile by TMA (a box of the fp frames of one position
//      and 64 channels, frames >= f zero-filled by the tensor map's bounds);
//      the consumers then LayerNorm each row once, in registers (fp32 mean,
//      then the mean squared deviation, clamped at 0; the output rounded to
//      bf16), into the resident 128-byte-swizzled A tile of all c channels
//      (c <= 512, and up to 704 with the Q/K/V tiles on the weight ring,
//      "alias"). Wider rows ("streamed") normalise each 64-channel column
//      block again per head into a two-slot staging tile. The producer warp
//      streams, for each head, the 32-channel K-chunks of [Wq; Wk; Wv] (192 x
//      32, TMA, 64-byte swizzle) through a four-slot ring, so that three
//      chunks are in flight while one is multiplied; the two consumer
//      warpgroups of 64 rows run wgmma m64n192k16 from the A tile, one chunk
//      in flight behind the next, into 96 fp32 accumulators a thread. Q, K, V
//      go to shared memory in bf16; each warpgroup then runs the mma.sync
//      frame attention (frame_attention.cuh, a warp per position) over its
//      own positions, writes O over its Q rows and copies O (b, f, s, ia) out
//      in bf16 with 16-byte stores.
//  (b) out_proj_kernel<NT>: a TMA + wgmma GEMM (M = b*f*s, N = c, K = ia),
//      128 x NT tiles, a three-slot ring fed by a producer warp, two CTAs an
//      SM; its epilogue rounds as the reference (ops/fused_temporal.py
//      _xla_temporal_block): bf16(O Wo), +bo, +x, +cross_bias, each a bf16 add.
// Shapes: head_dim 64, c % 64 == 0, f <= 32, s % ts == 0.
#include "frame_attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 128;               // tile rows: two consumer warpgroups of 64
constexpr int kThreads = 288;            // two consumer warpgroups + the producer warp
constexpr int kHD = 64;                  // head dim
constexpr int kChunk = 32;               // channels per ring slot (64-byte rows)
constexpr int kStages = 4;               // ring slots
constexpr int kSlot = 3 * 64 * 2 * kChunk;  // ring slot: 64 rows each of Wq, Wk, Wv
constexpr int kQKV = 3 * kRows * kAtom;  // the Q, K and V tiles of one head
constexpr int kBlock = kRows * kAtom;    // one 64-channel column block of the A tile
constexpr int kSmemMax = 232448;
enum Mode { kResident = 0, kAlias = 1, kStreamed = 2 };

// Shared memory of the QKV kernel, byte offsets from a 1024-aligned base: the
// A tile (or the two staging blocks), the ring, the Q/K/V tiles (on the ring
// in "alias"), per-row mean and rstd, 128 bytes of mbarriers; 1 KiB alignment
// slack.
struct HybridCfg {
  int ring, qkv, stats, bar, smem;
  __host__ __device__ HybridCfg(int mode, int c) {
    ring = mode == kStreamed ? 2 * kBlock : kRows * c * 2;
    qkv = mode == kAlias ? ring : ring + kStages * kSlot;  // kStages * kSlot == kQKV
    stats = qkv + kQKV;
    bar = stats + 2 * kRows * 4;
    smem = bar + 128 + 1024;
  }
};

// The widest layout that fits: resident A tile, then resident with Q/K/V on the ring.
int mode_for(int c) {
  if (HybridCfg(kResident, c).smem <= kSmemMax) return kResident;
  if (HybridCfg(kAlias, c).smem <= kSmemMax) return kAlias;
  return kStreamed;
}

struct QkvMaps {  // Wq, Wk, Wv: (ia, c), 32 x 64 boxes; x: (b, f, s, c), 64 x 1 x fp x 1
  CUtensorMap wq, wk, wv, x;
};

struct QkvArgs {
  const bf16 *x, *ln_w, *ln_b;
  bf16* o;
  int f, s, c, ia, ts, fp, hpc;
  float eps, scale;
};

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024, 1);
}

// a K-major tile of 64-byte rows in TMA's 64-byte swizzle (8-row atoms of 512 B)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return wgmma_desc(addr, 16, 512, 2);
}

// Byte offset of 8-channel chunk ch of row r in a tile of 64-channel column
// blocks of kRows 128-byte swizzled rows (the wgmma A operand layout).
__device__ __forceinline__ int a_off(int r, int ch) {
  return (ch / 8) * kBlock + swz(r, ch % 8);
}

// LN1 of eight channels: (x - mean) * rstd * w + b, rounded to bf16.
__device__ __forceinline__ uint4 ln8(uint4 v, float mu, float rs, uint4 wr, uint4 br) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  const bf16* we = reinterpret_cast<const bf16*>(&wr);
  const bf16* be = reinterpret_cast<const bf16*>(&br);
  uint4 out;
  bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) ov[j] = f2bf((bf2f(e[j]) - mu) * rs * bf2f(we[j]) + bf2f(be[j]));
  return out;
}

__device__ __forceinline__ float sum8(uint4 v, float mu, bool sq) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = bf2f(e[j]) - mu;
    acc += sq ? d * d : bf2f(e[j]);
  }
  return acc;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    hybrid_qkv_attn_kernel(const __grid_constant__ QkvMaps maps, const QkvArgs a) {
  const HybridCfg L(MODE, a.c);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* gbase = smem_raw + (base - raw);
  float* mean_s = reinterpret_cast<float*>(gbase + L.stats);
  float* rstd_s = mean_s + kRows;
  const uint32_t bar = base + L.bar;
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 8 * kStages + 8 * st; };
  const uint32_t xbar = bar + 16 * kStages;  // the x tile has landed

  const int wg = warpgroup_index();  // 0, 1: consumers; 2: the producer warp
  const int f = a.f, ts = a.ts, fp = a.fp, c = a.c;
  const int s0 = blockIdx.x * ts, h0 = blockIdx.y * a.hpc, bi = blockIdx.z;
  const int nkb = c / kChunk;  // K-chunks per head

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival per consumer warpgroup
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (MODE != kStreamed) {
      // the raw x tile, a TMA box of the fp frames of one position and 64
      // channels per (position, column block): rows p * fp + i, frames >= f
      // filled with zeros by the tensor map's bounds
      const int lane = threadIdx.x & 31, n = ts * (c / 64);
      if (lane == 0) mbar_expect_tx(xbar, n * fp * kAtom);
      __syncwarp();
      for (int k = lane; k < n; k += 32) {
        const int p = k % ts, kb = k / ts;
        tma_load_4d(base + kb * kBlock + p * fp * kAtom, &maps.x, xbar, kb * 64, s0 + p, 0, bi);
      }
    }
    if (threadIdx.x == 256) {
      for (int t = 0; t < a.hpc * nkb; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), kSlot);
        const uint32_t dst = base + L.ring + st * kSlot;
        const int h = h0 + t / nkb, k0 = (t % nkb) * kChunk;
        tma_load_2d(dst, &maps.wq, full(st), k0, h * kHD);
        tma_load_2d(dst + kSlot / 3, &maps.wk, full(st), k0, h * kHD);
        tma_load_2d(dst + 2 * kSlot / 3, &maps.wv, full(st), k0, h * kHD);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wc = wg;  // tile rows 64*wc .. +64
  const int ctid = threadIdx.x, wtid = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3, warp8 = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nch = c / 8;  // 16-byte chunks per row
  auto team_sync = [&]() { named_bar_sync(1, 256); };
  auto wg_sync = [&]() { named_bar_sync(2 + wc, 128); };
  // the x row of tile row r, or -1 for a padding row
  auto xrow = [&](int r) -> int64_t {
    const int p = r / fp, i = r % fp;
    return (i < f && p < ts) ? (int64_t(bi) * f + i) * a.s + s0 + p : -1;
  };

  if (MODE != kStreamed) {
    // LN1 in place, a warp per row, two rows at a time: the row's chunks in
    // registers (lane + 32 q, q < kPer), the mean, then the mean squared
    // deviation, then (x - mean) * rstd * w + b rounded to bf16
    constexpr int kPer = 3;  // c <= 768
    uint4 w8[kPer], b8[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int ch = min(lane + 32 * q, nch - 1);
      w8[q] = *reinterpret_cast<const uint4*>(a.ln_w + ch * 8);
      b8[q] = *reinterpret_cast<const uint4*>(a.ln_b + ch * 8);
    }
    for (int r = kRows - 1 - ctid; r >= ts * fp; r -= 256)  // rows past the last position
      for (int ch = 0; ch < nch; ++ch)
        *reinterpret_cast<uint4*>(gbase + a_off(r, ch)) = make_uint4(0u, 0u, 0u, 0u);
    mbar_wait(xbar, 0);
    for (int r0 = warp8; r0 < ts * fp; r0 += 16) {
      uint4 v[2][kPer];
      float mu[2], rs[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + 8 * u;
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          v[u][q] = lane + 32 * q < nch && r < ts * fp
                        ? *reinterpret_cast<const uint4*>(gbase + a_off(r, lane + 32 * q))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kPer; ++q) sum += sum8(v[u][q], 0.f, false);
        mu[u] = warp_sum(sum) / c;
        float sq = 0.f;
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          if (lane + 32 * q < nch) sq += sum8(v[u][q], mu[u], true);
        rs[u] = rsqrtf(fmaxf(warp_sum(sq) / c, 0.f) + a.eps);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + 8 * u;
        if (r >= ts * fp || r % fp >= f) continue;  // padding rows stay zero
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          if (lane + 32 * q < nch)
            *reinterpret_cast<uint4*>(gbase + a_off(r, lane + 32 * q)) =
                ln8(v[u][q], mu[u], rs[u], w8[q], b8[q]);
      }
    }
    fence_async_smem();
    team_sync();
  } else {
    // LN1 statistics from device memory, a warp per row
    for (int r = warp8; r < kRows; r += 8) {
      const int64_t gr = xrow(r);
      if (gr < 0) continue;
      const bf16* xr = a.x + gr * c;
      float sum = 0.f;
      for (int ch = lane; ch < nch; ch += 32)
        sum += sum8(*reinterpret_cast<const uint4*>(xr + ch * 8), 0.f, false);
      const float mu = warp_sum(sum) / c;
      float sq = 0.f;
      for (int ch = lane; ch < nch; ch += 32)
        sq += sum8(*reinterpret_cast<const uint4*>(xr + ch * 8), mu, true);
      const float var = fmaxf(warp_sum(sq) / c, 0.f);
      if (lane == 0) {
        mean_s[r] = mu;
        rstd_s[r] = rsqrtf(var + a.eps);
      }
    }
    team_sync();
  }

  const uint32_t sQ = base + L.qkv, sK = sQ + kBlock, sV = sQ + 2 * kBlock;
  unsigned char* q_g = gbase + L.qkv;
  // this warpgroup's positions: its 64 rows hold positions p_lo .. p_hi - 1
  const int p_lo = 64 * wc / fp, p_hi = min(64 * (wc + 1) / fp, ts);
  auto release = [&](int t) {
    if (wtid == 0) mbar_arrive(empty(t % kStages));
  };
  int t = 0;  // ring tiles consumed
  for (int hh = 0; hh < a.hpc; ++hh) {
    const int h = h0 + hh;
    float acc[96];  // Q | K | V of this warpgroup's 64 rows (m64n192 layout)
    for (int kb = 0; kb < nkb; ++kb, ++t) {
      // 64-channel column block kb / 2 of the A tile, its half kb % 2
      uint32_t blk = base + (kb / 2) * kBlock;
      if (MODE == kStreamed) {  // LN1 of column block kb / 2 of this warpgroup's rows
        const int sb = (kb / 2) & 1;
        blk = base + sb * kBlock;
        if (kb % 2 == 0) {
          for (int idx = wtid; idx < 64 * 8; idx += 128) {
            const int r = 64 * wc + idx / 8, ch = kb / 2 * 8 + idx % 8;
            const int64_t gr = xrow(r);
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (gr >= 0)
              v = ln8(*reinterpret_cast<const uint4*>(a.x + gr * c + ch * 8), mean_s[r],
                      rstd_s[r], *reinterpret_cast<const uint4*>(a.ln_w + ch * 8),
                      *reinterpret_cast<const uint4*>(a.ln_b + ch * 8));
            *reinterpret_cast<uint4*>(gbase + sb * kBlock + swz(r, idx % 8)) = v;
          }
          fence_async_smem();
          wg_sync();
        }
      }
      mbar_wait(full(t % kStages), (t / kStages) & 1);
      const uint32_t w = base + L.ring + (t % kStages) * kSlot;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_n192<0>(acc, sw128_desc(blk + wc * 64 * kAtom + (kb % 2) * 64 + kk * 32),
                         sw64_desc(w + kk * 32), kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk is done: free its slot
      // "alias" keeps the head's last kStages slots, where Q, K and V go next
      if (kb > 0 && !(MODE == kAlias && kb > nkb - kStages)) release(t - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (MODE != kAlias) release(t - 1);
    if (MODE == kAlias) team_sync();  // both warpgroups are done with the weights
    // Q, K, V rounded to bf16, rows as in the tile (position-major)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 64 * wc + warp * 16 + g + 8 * h2;
#pragma unroll
      for (int j = 0; j < 24; ++j)
        *reinterpret_cast<uint32_t*>(q_g + (j / 8) * kBlock + swz(r, j % 8) + 4 * t4) =
            pack_bf16(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
    }
    wg_sync();
    for (int p = p_lo + warp; p < p_hi; p += 4)  // a warp per position; O over its Q rows
      frame_attention_position(sQ, sK, sV, p * fp, f, a.scale,
                               [&](int i, int d, float o0, float o1) {
                                 *reinterpret_cast<uint32_t*>(q_g + swz(p * fp + i, d / 8) +
                                                              (d % 8) * 2) = pack_bf16(o0, o1);
                               });
    wg_sync();
    for (int idx = wtid; idx < (p_hi - p_lo) * f * 8; idx += 128) {
      const int p = p_lo + idx / (f * 8), i = (idx / 8) % f, j = idx % 8;
      *reinterpret_cast<uint4*>(a.o + ((int64_t(bi) * f + i) * a.s + s0 + p) * a.ia + h * kHD +
                                j * 8) = *reinterpret_cast<const uint4*>(q_g + swz(p * fp + i, j));
    }
    wg_sync();  // O read out before the next head's Q lands on it
    if (MODE == kAlias) {  // the ring is the weights' again
      fence_async_smem();
      team_sync();
      for (int k = kStages; k > 0; --k) release(t - k);
    }
  }
}

// ------------------------------------------------------------ out-projection
constexpr int kOutStages = 3;

template <int NT>
struct OutCfg {  // a stage: 128 rows of O and NT rows of Wo, 64 channels each
  static constexpr int kStage = kBlock + NT * kAtom;
  static constexpr int kBar = kOutStages * kStage;
  static constexpr int kSmem = kBar + 64 + 1024;
};

struct OutMaps {  // O (M, ia): 64 x 128 boxes; Wo (c, ia): 64 x NT boxes
  CUtensorMap o, wo;
};

struct OutArgs {
  const bf16 *bo, *x, *cross_bias;
  bf16* out;
  int64_t M;
  int N, K, fs, s;
};

template <int NT>
__device__ __forceinline__ void wgmma_ss_nt(float (&d)[NT / 2], uint64_t da, uint64_t db,
                                            int scale_d) {
  if constexpr (NT == 64) {
    wgmma_ss_n64<0>(d, da, db, scale_d);
  } else {
    wgmma_ss_n128<0>(d, da, db, scale_d);
  }
}

// out = bf16(bf16(bf16(bf16(O Wo^T) + bo) + x) + cross_bias[b, s])
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    out_proj_kernel(const __grid_constant__ OutMaps maps, const OutArgs a) {
  using K = OutCfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + K::kBar;
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 32 + 8 * st; };
  const int wg = warpgroup_index();
  // the column tiles of one row tile are neighbours in the grid: O's row tile
  // is read from device memory once and from L2 by the others
  const int64_t m0 = int64_t(blockIdx.y) * kRows;
  const int n0 = blockIdx.x * NT;
  const int nk = a.K / 64;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kOutStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {
      for (int t = 0; t < nk; ++t) {
        const int st = t % kOutStages;
        if (t >= kOutStages) mbar_wait(empty(st), ((t / kOutStages) & 1) ^ 1);
        mbar_expect_tx(full(st), K::kStage);
        const uint32_t dst = base + st * K::kStage;
        tma_load_2d(dst, &maps.o, full(st), t * 64, static_cast<int>(m0));
        tma_load_2d(dst + kBlock, &maps.wo, full(st), t * 64, n0);
      }
    }
    return;
  }

  const int wc = wg, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[NT / 2];
  for (int t = 0; t < nk; ++t) {
    const int st = t % kOutStages;
    mbar_wait(full(st), (t / kOutStages) & 1);
    const uint32_t sa = base + st * K::kStage, sb = sa + kBlock;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_nt<NT>(acc, sw128_desc(sa + wc * 64 * kAtom + kk * 32), sw128_desc(sb + kk * 32),
                      t > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && (threadIdx.x & 127) == 0) mbar_arrive(empty((t - 1) % kOutStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the epilogue, 8 column blocks at a time with their x and cross-bias loads
  // in flight together (restrict: the stores to out cannot alias them)
  const bf16* __restrict__ xg = a.x;
  const bf16* __restrict__ cbg = a.cross_bias;
  bf16* __restrict__ og = a.out;
  constexpr int JB = 8;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int64_t m = m0 + wc * 64 + warp * 16 + g + 8 * h2;
    if (m >= a.M) continue;
    const int64_t cb_row = (m / a.fs * a.s + m % a.s) * a.N;  // cross_bias[b, s]
#pragma unroll
    for (int j0 = 0; j0 < NT / 8; j0 += JB) {
      __nv_bfloat162 xv[JB], cv[JB];
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int n = n0 + (j0 + j) * 8 + 2 * t4;
        xv[j] = *reinterpret_cast<const __nv_bfloat162*>(xg + m * a.N + n);
        cv[j] = cbg != nullptr ? *reinterpret_cast<const __nv_bfloat162*>(cbg + cb_row + n)
                               : __floats2bfloat162_rn(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int n = n0 + (j0 + j) * 8 + 2 * t4;
        const int i = 4 * (j0 + j) + 2 * h2;
        __nv_bfloat162 y = __hadd2(__floats2bfloat162_rn(acc[i], acc[i + 1]),
                                   *reinterpret_cast<const __nv_bfloat162*>(a.bo + n));
        y = __hadd2(xv[j], y);
        if (cbg != nullptr) y = __hadd2(y, cv[j]);
        *reinterpret_cast<__nv_bfloat162*>(og + m * a.N + n) = y;
      }
    }
  }
}

template <int MODE>
cudaError_t launch_qkv(const QkvMaps& maps, const QkvArgs& a, dim3 grid, int smem,
                       cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(hybrid_qkv_attn_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  hybrid_qkv_attn_kernel<MODE><<<grid, kThreads, smem, st>>>(maps, a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_out(const void* o, const void* wo, const OutArgs& a, int ia, dim3 grid,
                       int smem, cudaStream_t st) {
  if (smem != OutCfg<NT>::kSmem) return cudaErrorInvalidValue;
  OutMaps maps;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t o_dims[2] = {uint64_t(ia), uint64_t(a.M)}, o_strides[1] = {uint64_t(ia) * 2};
  const uint32_t o_box[2] = {64, kRows};
  const uint64_t w_dims[2] = {uint64_t(ia), uint64_t(a.N)}, w_strides[1] = {uint64_t(ia) * 2};
  const uint32_t w_box[2] = {64, NT};
  if (!encode_bf16_map(&maps.o, o, 2, o_dims, o_strides, o_box, sw) ||
      !encode_bf16_map(&maps.wo, wo, 2, w_dims, w_strides, w_box, sw))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(out_proj_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  out_proj_kernel<NT><<<grid, kThreads, smem, st>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, f, s, c); ln_w, ln_b, bo: (c,); wq, wk, wv: (heads*64, c);
// wo: (c, heads*64); o: (b, f, s, heads*64) scratch; cross_bias: (b, s, c) or
// null. All bf16, contiguous, 16-byte aligned. The plan of
// ops/fused_temporal.py:hybrid_plan: ts positions per tile, the layout `mode`
// (0 resident, 1 alias, 2 streamed), hpc heads per CTA, the QKV grid (s / ts,
// heads / hpc, b) and shared memory; the out-projection's column tile out_n,
// grid (c / out_n, ceil(b*f*s / 128)) and shared memory.
extern "C" int cak_temporal_attention(const void* x, const void* ln_w, const void* ln_b,
                                      const void* wq, const void* wk, const void* wv,
                                      void* o, const void* wo, const void* bo,
                                      const void* cross_bias, void* out, int b, int f,
                                      int s, int c, int heads, int ts, int mode, int hpc,
                                      int grid_x, int grid_y, int grid_z, int smem, int out_n,
                                      int out_grid_x, int out_grid_y, int out_smem, float eps,
                                      float scale, void* stream) {
  const int fp = (f + 15) / 16 * 16;
  const int64_t M = int64_t(b) * f * s;
  if (f < 1 || f > 32 || ts < 1 || fp * ts > kRows || s % ts || c < 64 || c % 64 ||
      heads < 1 || hpc < 1 || heads % hpc || grid_x * ts != s || grid_y * hpc != heads ||
      grid_z != b || mode != mode_for(c) || smem != HybridCfg(mode, c).smem ||
      out_n != (c % 128 == 0 ? 128 : 64) || out_grid_x * out_n != c ||
      int64_t(out_grid_y) != (M + kRows - 1) / kRows || out_grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ia = heads * kHD;
  QkvMaps maps;
  const uint64_t dims[2] = {uint64_t(c), uint64_t(ia)}, strides[1] = {uint64_t(c) * 2};
  const uint32_t box[2] = {kChunk, 64};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_64B;
  const uint64_t x_dims[4] = {uint64_t(c), uint64_t(s), uint64_t(f), uint64_t(b)};
  const uint64_t x_strides[3] = {uint64_t(c) * 2, uint64_t(s) * c * 2, uint64_t(f) * s * c * 2};
  const uint32_t x_box[4] = {64, 1, uint32_t(fp), 1};
  if (!encode_bf16_map(&maps.wq, wq, 2, dims, strides, box, sw) ||
      !encode_bf16_map(&maps.wk, wk, 2, dims, strides, box, sw) ||
      !encode_bf16_map(&maps.wv, wv, 2, dims, strides, box, sw) ||
      !encode_bf16_map(&maps.x, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = [](const void* v) { return static_cast<const bf16*>(v); };
  const QkvArgs qa{p(x), p(ln_w), p(ln_b), static_cast<bf16*>(o), f, s, c, ia, ts, fp, hpc,
                   eps, scale};
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaError_t e = mode == kResident ? launch_qkv<kResident>(maps, qa, grid, smem, st)
                  : mode == kAlias  ? launch_qkv<kAlias>(maps, qa, grid, smem, st)
                                    : launch_qkv<kStreamed>(maps, qa, grid, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const OutArgs oa{p(bo), p(x), p(cross_bias), static_cast<bf16*>(out), M, c, ia, f * s, s};
  const dim3 ogrid(out_grid_x, out_grid_y);
  e = out_n == 128 ? launch_out<128>(o, wo, oa, ia, ogrid, out_smem, st)
                   : launch_out<64>(o, wo, oa, ia, ogrid, out_smem, st);
  return static_cast<int>(e);
}
