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
// (2, 14, 4096, 320), 0.67 ms at the bf16 tensor-core peak. Every CTA needs
// all of the block's weights (5.75 MB at c = 320) from L2.
//
// Design (Hopper, warp-specialised; 384 threads, one CTA per tile of ts
// positions x f frames = up to 128 rows, row r = frame r / ts, position r % ts):
// - warpgroup 0 is the producer: one thread streams every weight tile of the
//   block, in the order the consumers use them, through a two-slot ring of
//   128*c-byte tiles (TMA, 128-byte swizzle, a full and an empty mbarrier per
//   slot). The tiles: per 64 inner columns of an FF, two 64-row [value; gate]
//   tiles of Wg (32 columns each) and one (c x 64) tile of W2 (ff_wgmma.cuh:
//   load_ff_tile); per head, the 64 rows of Wq, Wk, Wv and the 64 columns of Wo.
// - warpgroups 1 and 2 are consumers, 64 rows each. A part starts from the
//   LayerNormed residual stream in the A tile (bf16, shared memory, 128-byte
//   swizzled K-major: the wgmma A operand), then:
//   - FF (ff_wgmma.cuh:ff_products, shared with K4): G = LN . Wg^T on wgmma
//     (m64n64k16, both operands in shared memory); GEGLU in registers (bf16
//     pair adds and products; the SFU's tanh, or erf under `exact`), its
//     result as the register A operand of acc += h . W2^T (wgmma m64nNk16,
//     N = c split into 1-3 blocks); the 64 x c fp32 accumulator stays in
//     registers across the inner width;
//   - attn: per head Q, K, V = LN . W^T on wgmma, stored to shared memory
//     position-major; the frame attention on mma.sync, one warp per position
//     (frame_attention.cuh); O into a swizzled tile; acc += O . Wo_h^T on
//     wgmma.
//   A part ends by staging its product, rounded to bf16, in the A tile; then
//   one pass with a warp per row (four rows' loads in flight at once) adds
//   bias, residual and cross bias in bf16, writes the row to the output
//   buffer, which holds the residual stream between parts, and LayerNorms it
//   in registers into the A tile for the next part.
// Rounding follows the TPU kernel (ops/fused_temporal.py:147-157, 193): every
// product is rounded to bf16 and every bias and residual add is a bf16 add.
// Shapes: head_dim 64, c in {64, ..., 320} (c % 64 == 0), inner % 64 == 0,
// f * ts + (-f mod 16) <= 128, s % ts == 0. The host plan
// (ops/fused_temporal.py:full_plan) chooses ts, the grid and the shared memory;
// cak_temporal_full refuses a plan that does not match FullCfg.
#include "ff_wgmma.cuh"
#include "frame_attention.cuh"

namespace {

using ffw::sw128_desc;

constexpr int kRowsT = 128;     // tile rows: two consumer warpgroups of 64
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kHD = 64;         // head dim

template <int C>
struct FullCfg {
  // the out-projections (W2, Wo) in kNO column blocks of kCB <= 160 (wgmma N)
  static constexpr int kNO = ffw::OutBlocks<C>::kNO;
  static constexpr int kCB = ffw::OutBlocks<C>::kCB;
  static constexpr int kTile = 128 * C;  // bytes of every weight tile
  static constexpr int kRing = kRowsT * C * 2;  // the A tile (LN output) at 0
  static constexpr int kO = kRing + 2 * kTile;
  static constexpr int kQ = kO + kRowsT * kHD * 2;
  static constexpr int kK = kQ + kRowsT * kAtom;
  static constexpr int kV = kK + kRowsT * kAtom;
  static constexpr int kBar = kV + kRowsT * kAtom;
  static constexpr int kSmem = kBar + 32 + 1024;  // + alignment slack
};

struct FullMaps {  // TMA maps of the weight matrices
  CUtensorMap ffin_wg, ffin_w2, wq, wk, wv, wo, ff_wg, ff_w2;
};

struct FullArgs {
  const bf16* x;
  bf16* out;
  const bf16* cross_bias;
  const bf16 *lnin_w, *lnin_b, *ffin_bg, *ffin_b2;
  const bf16 *ln1_w, *ln1_b, *bo;
  const bf16 *ln3_w, *ln3_b, *ff_bg, *ff_b2;
  int f, s, heads, inner, ts, exact;
  float eps, scale;
};

// Eight bf16 pair-wise adds, each rounded once (a bf16 add).
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  __nv_bfloat162* pa = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) pa[i] = __hadd2(pa[i], pb[i]);
  return a;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    temporal_full_kernel(const __grid_constant__ FullMaps maps, const FullArgs a) {
  using K = FullCfg<C>;
  constexpr int NO = K::kNO, CB = K::kCB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sA = base, sRing = base + K::kRing, sO = base + K::kO;
  bf16* o_g = reinterpret_cast<bf16*>(gbase + K::kO);
  unsigned char* qkv_g = gbase + K::kQ;  // Q, K, V tiles, kRowsT * kAtom bytes each
  const uint32_t bar = base + K::kBar;

  const int wg = warpgroup_index();
  const int f = a.f, ts = a.ts, rows = f * ts;
  const int s0 = blockIdx.x * ts, bi = blockIdx.y;

  ffw::Ring ring(sRing, bar, 2, K::kTile);
  if (threadIdx.x == 0) {
    ring.init(2);  // both consumer warpgroups read every weight tile
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // one loop over the block's tiles: ffin's, then per head Wq, Wk, Wv and
      // Wo, then ff's (each part's loads inlined once)
      const int n_ff = 3 * (a.inner / 64), attn0 = n_ff, ff0 = n_ff + 4 * a.heads;
      for (int t = 0; t < ff0 + n_ff; ++t) {
        if (t < attn0 || t >= ff0) {
          const bool in = t < attn0;
          ffw::load_ff_tile<C>(ring, in ? &maps.ffin_wg : &maps.ff_wg,
                               in ? &maps.ffin_w2 : &maps.ff_w2, C, in ? t : t - ff0);
          continue;
        }
        const int h = (t - attn0) / 4, part = (t - attn0) % 4;
        const uint32_t dst = ring.acquire(K::kTile);
        const uint32_t full = ring.full_bar();
        if (part < 3) {
          const CUtensorMap* m = part == 0 ? &maps.wq : (part == 1 ? &maps.wk : &maps.wv);
          for (int cb = 0; cb < C / 64; ++cb)
            tma_load_2d(dst + cb * 64 * kAtom, m, full, cb * 64, h * kHD);
        } else {
          for (int o = 0; o < NO; ++o)
            tma_load_2d(dst + o * CB * kAtom, &maps.wo, full, h * kHD, o * CB);
        }
        ring.advance();
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wc = wg - 1;  // tile rows 64*wc .. +64
    const int ctid = threadIdx.x - 128;
    const int warp8 = ctid / 32, warp = warp8 & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    for (int i = ctid; i < 3 * (kRowsT - rows) * 8; i += 256) {
      const int plane = i / ((kRowsT - rows) * 8), rem = i % ((kRowsT - rows) * 8);
      *reinterpret_cast<uint4*>(qkv_g + plane * kRowsT * kAtom + (rows + rem / 8) * kAtom +
                                (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    const bool leader = (ctid & 127) == 0;
    auto team_sync = [&]() { named_bar_sync(1, 256); };
    auto grow = [&](int r) -> int64_t {
      return (int64_t(bi) * f + r / ts) * a.s + s0 + r % ts;
    };
    // descriptors: A rows of this warpgroup (k-step kk of 16 channels), a
    // 64-row weight tile, column block o of a W2 / Wo tile, the O tile
    auto desc_a = [&](int kk) {
      return sw128_desc(sA + (kk / 4) * kRowsT * kAtom + wc * 64 * kAtom + (kk % 4) * 32);
    };
    auto desc_w64 = [&](uint32_t w, int kk) {
      return sw128_desc(w + (kk / 4) * 64 * kAtom + (kk % 4) * 32);
    };
    auto desc_wcb = [&](uint32_t w, int o, int ks) {
      return sw128_desc(w + o * CB * kAtom + ks * 32);
    };
    auto desc_o = [&](int ks) { return sw128_desc(sO + wc * 64 * kAtom + ks * 32); };

    unsigned char* a_b = gbase;  // the A tile
    // byte offset of 8-channel chunk ch of row r in the A tile
    auto a_off = [&](int r, int ch) {
      return (ch / 8) * kRowsT * kAtom + r * kAtom + (((ch % 8) ^ (r % 8)) << 4);
    };

    // The part's product (this warpgroup's 64 rows x C, fp32) rounded to bf16
    // into its rows of the A tile, which its products no longer read.
    auto stage = [&](float (&acc)[NO][CB / 2]) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = wc * 64 + warp * 16 + g + 8 * h2;
#pragma unroll
        for (int o = 0; o < NO; ++o)
#pragma unroll
          for (int jb = 0; jb < CB / 8; ++jb) {
            const int col = o * CB + jb * 8 + 2 * t4;
            *reinterpret_cast<uint32_t*>(a_b + a_off(r, col / 8) + (col % 8) * 2) =
                pack_bf16(acc[o][4 * jb + 2 * h2], acc[o][4 * jb + 2 * h2 + 1]);
          }
      }
      team_sync();
    };

    // One pass over the tile's rows, warp w taking rows w, w + 8, ..., kRB of
    // them with their loads in flight together. mode 0: y = src's row; mode 1
    // (FF): y = (p + bias) + src; mode 2 (attn): y = (src + p) + bias (+ the
    // cross bias); p the staged product, each add a bf16 add; modes 1 and 2
    // write y to out. With ln_w, LN(y) replaces the row in the A tile (fp32
    // mean, then the mean squared deviation clamped at 0, (y - mean) * rstd *
    // w + b rounded to bf16; padding rows zero), the next part's A operand.
    auto row_pass = [&](int mode, const bf16* src, const bf16* __restrict__ bias,
                        const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b) {
      constexpr int NCH = C / 8, PER = (NCH + 31) / 32, kRB = 4;
      uint4 bb[PER], lw[PER], lb[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int ch = min(lane + 32 * p, NCH - 1);
        bb[p] = mode ? *reinterpret_cast<const uint4*>(bias + ch * 8) : make_uint4(0, 0, 0, 0);
        lw[p] = ln_w ? *reinterpret_cast<const uint4*>(ln_w + ch * 8) : make_uint4(0, 0, 0, 0);
        lb[p] = ln_w ? *reinterpret_cast<const uint4*>(ln_b + ch * 8) : make_uint4(0, 0, 0, 0);
      }
      for (int r0 = warp8; r0 < kRowsT; r0 += 8 * kRB) {
        uint4 y[kRB][PER], pr[kRB][PER], cb[kRB][PER];
#pragma unroll
        for (int i = 0; i < kRB; ++i) {  // loads first, so that they overlap
          const int r = r0 + 8 * i;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const int ch = lane + 32 * p;
            y[i][p] = pr[i][p] = cb[i][p] = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows && ch < NCH) {
              y[i][p] = *reinterpret_cast<const uint4*>(src + grow(r) * C + ch * 8);
              if (mode) pr[i][p] = *reinterpret_cast<const uint4*>(a_b + a_off(r, ch));
              if (mode == 2 && a.cross_bias != nullptr)
                cb[i][p] = *reinterpret_cast<const uint4*>(
                    a.cross_bias + (int64_t(bi) * a.s + s0 + r % ts) * C + ch * 8);
            }
          }
        }
        if (mode) {
#pragma unroll
          for (int i = 0; i < kRB; ++i) {
            const int r = r0 + 8 * i;
#pragma unroll
            for (int p = 0; p < PER; ++p) {
              const int ch = lane + 32 * p;
              if (r < rows && ch < NCH) {
                y[i][p] = mode == 1 ? add8(add8(pr[i][p], bb[p]), y[i][p])
                                    : add8(add8(y[i][p], pr[i][p]), bb[p]);
                if (mode == 2 && a.cross_bias != nullptr) y[i][p] = add8(y[i][p], cb[i][p]);
                *reinterpret_cast<uint4*>(a.out + grow(r) * C + ch * 8) = y[i][p];
              }
            }
          }
        }
        if (ln_w == nullptr) continue;
        float mu[kRB], rs[kRB];
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          float sum = 0.f;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const bf16* e = reinterpret_cast<const bf16*>(&y[i][p]);
#pragma unroll
            for (int j = 0; j < 8; ++j) sum += bf2f(e[j]);
          }
          mu[i] = warp_sum(sum) / C;
          float sq = 0.f;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            if (lane + 32 * p < NCH) {
              const bf16* e = reinterpret_cast<const bf16*>(&y[i][p]);
#pragma unroll
              for (int j = 0; j < 8; ++j) sq += (bf2f(e[j]) - mu[i]) * (bf2f(e[j]) - mu[i]);
            }
          }
          rs[i] = rsqrtf(fmaxf(warp_sum(sq) / C, 0.f) + a.eps);
        }
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const int r = r0 + 8 * i;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const int ch = lane + 32 * p;
            if (ch >= NCH) continue;
            uint4 outv = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows) {
              const bf16* e = reinterpret_cast<const bf16*>(&y[i][p]);
              const bf16* we = reinterpret_cast<const bf16*>(&lw[p]);
              const bf16* be = reinterpret_cast<const bf16*>(&lb[p]);
              bf16* ov = reinterpret_cast<bf16*>(&outv);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                ov[j] = f2bf((bf2f(e[j]) - mu[i]) * rs[i] * bf2f(we[j]) + bf2f(be[j]));
            }
            *reinterpret_cast<uint4*>(a_b + a_off(r, ch)) = outv;
          }
        }
      }
      fence_async_smem();
      team_sync();
    };

    auto zero = [&](float (&acc)[NO][CB / 2]) {
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int i = 0; i < CB / 2; ++i) acc[o][i] = 0.f;
    };
    auto fence_acc = [&](float (&acc)[NO][CB / 2]) {
#pragma unroll
      for (int o = 0; o < NO; ++o) fence_regs(acc[o]);
    };
    // p (64 rows x 64 columns) = A . W^T for a 64-row weight tile in the ring
    auto rows64 = [&](float (&p)[32]) {
      const uint32_t w = ring.wait();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) wgmma_ss_n64<0>(p, desc_a(kk), desc_w64(w, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p);
      ring.release(leader);
    };

    // ffin: cur = x + FF_in(LN_in(x)), then LN1(cur) into the A tile
    row_pass(0, a.x, nullptr, a.lnin_w, a.lnin_b);
    {
      float acc[NO][CB / 2];
      zero(acc);
      ffw::ff_products<C, true, false>(acc, ring, sA, wc, C, a.inner, a.ffin_bg, a.exact != 0);
      stage(acc);
    }
    row_pass(1, a.x, a.ffin_b2, a.ln1_w, a.ln1_b);

    // attn: cur = cur + O . Wo^T + bo (+ cross bias), then LN3(cur)
    {
      float acc[NO][CB / 2];
      zero(acc);
      for (int h = 0; h < a.heads; ++h) {
#pragma unroll 1
        for (int part = 0; part < 3; ++part) {
          float p[32];
          rows64(p);
          unsigned char* dst = qkv_g + part * kRowsT * kAtom;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = wc * 64 + warp * 16 + g + 8 * h2;
            if (r >= rows) continue;
            const int pr = (r % ts) * f + r / ts;  // position-major rows
#pragma unroll
            for (int jb = 0; jb < 8; ++jb)
              *reinterpret_cast<uint32_t*>(dst + swz(pr, jb) + 4 * t4) =
                  pack_bf16(p[4 * jb + 2 * h2], p[4 * jb + 2 * h2 + 1]);
          }
        }
        team_sync();
        for (int p = warp8; p < ts; p += 8)  // one warp per position
          frame_attention_position(
              base + K::kQ, base + K::kK, base + K::kV, p * f, f, a.scale,
              [&](int i, int d, float o0, float o1) {
                *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(o_g) +
                                             swz(i * ts + p, d / 8) + (d % 8) * 2) =
                    pack_bf16(o0, o1);
              });
        fence_async_smem();
        team_sync();
        const uint32_t w = ring.wait();
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int o = 0; o < NO; ++o)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ffw::wgmma_ss_cb<CB>(acc[o], desc_o(ks), desc_wcb(w, o, ks));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        ring.release(leader);
      }
      stage(acc);
    }
    row_pass(2, a.out, a.bo, a.ln3_w, a.ln3_b);

    // ff: out = cur + FF(LN3(cur))
    {
      float acc[NO][CB / 2];
      zero(acc);
      ffw::ff_products<C, true, false>(acc, ring, sA, wc, C, a.inner, a.ff_bg, a.exact != 0);
      stage(acc);
    }
    row_pass(1, a.out, a.ff_b2, nullptr, nullptr);
  }
}

template <int C>
bool make_maps(FullMaps* m, const void* ffin_wg, const void* ffin_w2, const void* wq,
               const void* wk, const void* wv, const void* wo, const void* ff_wg,
               const void* ff_w2, int heads, int inner) {
  constexpr uint32_t CB = FullCfg<C>::kCB;
  const uint64_t ia = uint64_t(heads) * kHD, in = uint64_t(inner), c = C;
  auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // Wg (2*inner, c) as (c, inner, [value, gate]): 64 columns x 32 rows x 2
  auto wg_map = [&](CUtensorMap* mp, const void* p) {
    const uint64_t dims[3] = {c, in, 2}, strides[2] = {c * 2, in * c * 2};
    const uint32_t box[3] = {64, 32, 2};
    return encode_bf16_map(mp, p, 3, dims, strides, box, sw);
  };
  auto w2_map = [&](CUtensorMap* mp, const void* p) {  // W2 (c, inner): 64 x kCB
    const uint64_t dims[2] = {in, c}, strides[1] = {in * 2};
    const uint32_t box[2] = {64, CB};
    return encode_bf16_map(mp, p, 2, dims, strides, box, sw);
  };
  auto wqkv_map = [&](CUtensorMap* mp, const void* p) {  // (ia, c): 64 x 64
    const uint64_t dims[2] = {c, ia}, strides[1] = {c * 2};
    const uint32_t box[2] = {64, 64};
    return encode_bf16_map(mp, p, 2, dims, strides, box, sw);
  };
  const uint64_t wo_dims[2] = {ia, c}, wo_strides[1] = {ia * 2};  // Wo (c, ia): 64 x kCB
  const uint32_t wo_box[2] = {64, CB};
  return wg_map(&m->ffin_wg, ffin_wg) && w2_map(&m->ffin_w2, ffin_w2) &&
         wqkv_map(&m->wq, wq) && wqkv_map(&m->wk, wk) && wqkv_map(&m->wv, wv) &&
         encode_bf16_map(&m->wo, wo, 2, wo_dims, wo_strides, wo_box, sw) &&
         wg_map(&m->ff_wg, ff_wg) && w2_map(&m->ff_w2, ff_w2);
}

// Launches the plan's grid (s / ts, b) with its shared memory, which must be
// FullCfg<C>'s.
template <int C>
cudaError_t launch(const void* const* w, const FullArgs& a, dim3 grid, int smem,
                   cudaStream_t st) {
  if (smem != FullCfg<C>::kSmem) return cudaErrorInvalidValue;
  FullMaps maps;
  if (!make_maps<C>(&maps, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], a.heads, a.inner))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(temporal_full_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  temporal_full_kernel<C><<<grid, kThreads, smem, st>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, f, s, c); LayerNorm weights (c,); FF weights wg (2*inner, c),
// bg (2*inner,), w2 (c, inner), b2 (c,); wq, wk, wv (heads*64, c); wo
// (c, heads*64); bo (c,); cross_bias (b, s, c) or null. All bf16, contiguous,
// 16-byte aligned. exact: erf gelu, else tanh. The plan of
// ops/fused_temporal.py:full_plan: ts positions per CTA, grid (grid_x, grid_y)
// = (s / ts, b), smem bytes of shared memory.
extern "C" int cak_temporal_full(
    const void* x, const void* lnin_w, const void* lnin_b, const void* ffin_wg,
    const void* ffin_bg, const void* ffin_w2, const void* ffin_b2, const void* ln1_w,
    const void* ln1_b, const void* wq, const void* wk, const void* wv, const void* wo,
    const void* bo, const void* ln3_w, const void* ln3_b, const void* ff_wg, const void* ff_bg,
    const void* ff_w2, const void* ff_b2, const void* cross_bias, void* out, int b, int f,
    int s, int c, int heads, int inner, int ts, int grid_x, int grid_y, int smem, int exact,
    float eps, float scale, void* stream) {
  auto p = [](const void* v) { return static_cast<const bf16*>(v); };
  const FullArgs a{p(x),      static_cast<bf16*>(out), p(cross_bias), p(lnin_w), p(lnin_b),
                   p(ffin_bg), p(ffin_b2),             p(ln1_w),      p(ln1_b),  p(bo),
                   p(ln3_w),  p(ln3_b),                p(ff_bg),      p(ff_b2),  f,
                   s,         heads,                   inner,         ts,        exact,
                   eps,       scale};
  const void* w[8] = {ffin_wg, ffin_w2, wq, wk, wv, wo, ff_wg, ff_w2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rows past the last position's frames up to a multiple of 16 are read as padding
  if (f * ts + (15 - (f + 15) % 16) > kRowsT || f > 32 || ts < 1 || s % ts || inner % 64 ||
      heads < 1 || grid_x * ts != s || grid_y != b)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, grid_y);
  switch (c) {
#define CAK_FULL_CASE(C) \
  case C:                \
    return static_cast<int>(launch<C>(w, a, grid, smem, st));
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
