// K4: the feed-forward residual sub-block on (M, c) rows,
//   out = [x +] W2 . (value * gelu(gate)) + b2,  [value; gate] = LN(x) . Wg^T + bg.
//
// Replaces: ctrl_adapter_tpu/ops/fused_block.py, ln_ff_residual ->
//   _pallas_ln_ff_residual (Pallas body _kernel): LN statistics in fp32, an
//   fp32 accumulator over inner-width chunks, so the (M, 8c) intermediate never
//   reaches memory.
//
// What bounds it on the H100: per row 2*c*2I (GEGLU) + 2*I*cout (W2) flops
// against 2*(c + cout) bytes of x and out, I = 4c: ~12*c flop per byte (3,840
// at c = 320), far above the ~295 flop/byte ridge, so the tensor cores bound
// it (0.285 ms at (114688, 320)). Every 128-row tile multiplies by all the
// weights (2.46 MB at c = 320), so the weights cross L2 once per tile: ~2.2 GB
// per call at the main path's 114,688 rows. Clusters of two CTAs whose TMA
// multicast halved those reads ran 9-19 % slower than one CTA with a deeper
// ring (the refill of a shared slot waits for both CTAs' consumers), and
// were removed.
//
// Design (Hopper, warp-specialised; 384 threads, one CTA per 128-row tile):
// - warpgroup 0 is the producer: one thread loads the tile's x by TMA into
//   the A tile (128 x c, 64-column blocks, 128-byte swizzled: the wgmma A
//   layout; rows past M read as zero), then streams Wg and W2 through a ring
//   of `depth` slots of 128*max(c, cout) bytes, 3 at c = cout = 320 (TMA,
//   128-byte swizzle; ff_wgmma.cuh:load_ff_tile).
// - warpgroups 1 and 2 are consumers, 64 rows each. Each LayerNorms its rows
//   of the x tile in place, a warp per row, eight rows at a time (fp32 mean,
//   then the mean squared deviation clamped at 0, rounded to bf16), and starts
//   ff_wgmma.cuh:ff_products without waiting for the other: fp32 rounding up
//   to h (per 64 inner columns G = A . Wg^T on wgmma, GEGLU in fp32 registers,
//   acc += h . W2^T with h as the register A operand, the two warpgroups in
//   ping-pong). In the epilogue
//   a warpgroup reloads its 64 rows of x by TMA into its own, now idle, rows
//   of the A tile, adds b2 and x to the fp32 accumulator, rounds once, writes
//   the sums over x there and stores them by TMA.
// Shapes: c and cout multiples of 64 up to 320 (the 64 x cout fp32
// accumulator), inner % 64 == 0, any M; with the residual cout == c. The host
// plan (ops/fused_block.py:plan) chooses the grid, the ring depth and the
// shared memory; cak_ln_ff refuses a plan that does not match these functions
// of the shapes.
#include "ff_wgmma.cuh"

namespace {

constexpr int kRows = ffw::kTileRows;  // rows per CTA
constexpr int kThreads = 384;          // producer warpgroup + two consumer warpgroups
constexpr int kMaxDepth = 4;
constexpr int kSmemMax = 232448;       // shared memory a block may use on an H100

// A ring slot holds one Wg tile (64 rows x c) or one W2 tile (cout x 64).
__host__ __device__ constexpr int slot_bytes(int c, int cout) { return 128 * (c > cout ? c : cout); }
// The A tile, 2 * kMaxDepth + 3 mbarriers and 1 KiB of alignment slack.
__host__ __device__ constexpr int fixed_bytes(int c) { return 256 * c + 16 * kMaxDepth + 24 + 1024; }
int ring_depth(int c, int cout) {
  const int d = (kSmemMax - fixed_bytes(c)) / slot_bytes(c, cout);
  return d < kMaxDepth ? d : kMaxDepth;
}
int smem_bytes(int c, int cout, int depth) { return fixed_bytes(c) + depth * slot_bytes(c, cout); }

struct Args {
  const bf16 *x, *ln_w, *ln_b, *bg, *b2;
  bf16* out;
  int64_t M;
  int c, inner, residual, exact, depth;
  float eps;
};

template <int COUT>
__global__ void __launch_bounds__(kThreads, 1)
    ln_ff_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap xh_map,
                 const __grid_constant__ CUtensorMap out_map,
                 const __grid_constant__ CUtensorMap wg_map,
                 const __grid_constant__ CUtensorMap w2_map, const Args a) {
  constexpr int NO = ffw::OutBlocks<COUT>::kNO, CB = ffw::OutBlocks<COUT>::kCB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* a_b = smem_raw + (base - raw);  // the A tile
  const int c = a.c;
  const int slot = slot_bytes(c, COUT);
  const uint32_t sA = base, sRing = base + 256 * c, bars = sRing + a.depth * slot;
  const uint32_t x_full = bars + 8 * 2 * kMaxDepth;
  const int wg = warpgroup_index();
  const int64_t m0 = int64_t(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(a.M - m0 < 0 ? 0 : (a.M - m0 < kRows ? a.M - m0 : kRows));

  ffw::Ring ring(sRing, bars, a.depth, slot);
  if (threadIdx.x == 0) {
    ring.init(2);  // both consumer warpgroups read every weight tile
    for (int i = 0; i < 3; ++i) mbar_init(x_full + 8 * i, 1);  // x, then each warpgroup's rows again
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(x_full, 256 * c);
      for (int cb = 0; cb < c / 64; ++cb)
        tma_load_2d(sA + cb * kRows * ffw::kRowBytes, &x_map, x_full, cb * 64, int(m0));
      for (int u = 0; u < 3 * (a.inner / 64); ++u)
        ffw::load_ff_tile<COUT>(ring, &wg_map, &w2_map, c, u);
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wc = wg - 1;  // tile rows 64*wc .. +64
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;

    auto a_off = [&](int r, int ch) {  // 16-byte chunk ch of row r, 128-byte swizzled
      return (ch / 8) * kRows * ffw::kRowBytes + r * ffw::kRowBytes + (((ch % 8) ^ (r % 8)) << 4);
    };

    // LN(x) in place in this warpgroup's rows of the A tile: warp w of it takes
    // rows 64 wc + w, + 4, ..., eight at a time
    {
      constexpr int PER = 2, kRB = 8;  // 16-byte chunks per lane (c <= 512); rows in flight
      const int nch = c / 8;
      uint4 lw[PER], lb[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int ch = min(lane + 32 * p, nch - 1);
        lw[p] = *reinterpret_cast<const uint4*>(a.ln_w + ch * 8);
        lb[p] = *reinterpret_cast<const uint4*>(a.ln_b + ch * 8);
      }
      mbar_wait(x_full, 0);
      for (int r0 = 64 * wc + warp; r0 < 64 * wc + 64; r0 += 4 * kRB) {
        uint4 y[kRB][PER];
        float mu[kRB], rs[kRB];
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const int r = r0 + 4 * i;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const int ch = lane + 32 * p;
            y[i][p] = ch < nch ? *reinterpret_cast<const uint4*>(a_b + a_off(r, ch))
                               : make_uint4(0u, 0u, 0u, 0u);
          }
        }
        // the rows' sums side by side, so that their shuffles overlap
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          float sum = 0.f;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const bf16* e = reinterpret_cast<const bf16*>(&y[i][p]);
#pragma unroll
            for (int j = 0; j < 8; ++j) sum += bf2f(e[j]);
          }
          mu[i] = sum;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < kRB; ++i) mu[i] += __shfl_xor_sync(0xffffffffu, mu[i], o);
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          mu[i] /= c;
          float sq = 0.f;
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            if (lane + 32 * p < nch) {
              const bf16* e = reinterpret_cast<const bf16*>(&y[i][p]);
#pragma unroll
              for (int j = 0; j < 8; ++j) sq += (bf2f(e[j]) - mu[i]) * (bf2f(e[j]) - mu[i]);
            }
          }
          rs[i] = sq;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < kRB; ++i) rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], o);
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const int r = r0 + 4 * i;
          const float rstd = rsqrtf(fmaxf(rs[i] / c, 0.f) + a.eps);
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const int ch = lane + 32 * p;
            if (ch >= nch) continue;
            uint4 outv = make_uint4(0u, 0u, 0u, 0u);  // rows past M: zero
            if (r < nrows) {
              const bf16* e = reinterpret_cast<const bf16*>(&y[i][p]);
              const bf16* we = reinterpret_cast<const bf16*>(&lw[p]);
              const bf16* be = reinterpret_cast<const bf16*>(&lb[p]);
              bf16* ov = reinterpret_cast<bf16*>(&outv);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                ov[j] = f2bf((bf2f(e[j]) - mu[i]) * rstd * bf2f(we[j]) + bf2f(be[j]));
            }
            *reinterpret_cast<uint4*>(a_b + a_off(r, ch)) = outv;
          }
        }
      }
    }
    fence_async_smem();
    named_bar_sync(4 + wc, 128);  // this warpgroup's rows of the A tile are written

    float acc[NO][CB / 2];
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) acc[o][i] = 0.f;
    ffw::ff_products<COUT, false, true>(acc, ring, sA, wc, c, a.inner, a.bg, a.exact != 0);

    // + b2 (+ x) in fp32, one rounding. This warpgroup's rows of the A tile are
    // free once its products are done: x's rows come back into them by TMA,
    // the sums are written over them and go out with TMA stores (out's rows
    // past M are not written). Where cout > c they do not fit, and the
    // warpgroup stores from registers.
    const bool leader = (threadIdx.x & 127) == 0;
    const int r_wg = wc * 64;  // this warpgroup's first row of the tile
    const uint32_t x2 = x_full + 8 * (1 + wc);
    if (COUT <= c) {
      if (a.residual) {
        if (leader) {
          mbar_expect_tx(x2, 128 * c);
          for (int cb = 0; cb < c / 64; ++cb)
            tma_load_2d(sA + cb * kRows * ffw::kRowBytes + r_wg * ffw::kRowBytes, &xh_map, x2,
                        cb * 64, int(m0) + r_wg);
        }
        mbar_wait(x2, 0);
      }
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int jb = 0; jb < CB / 8; ++jb) {
          const int col = o * CB + jb * 8 + 2 * t4;
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b2 + col));
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = r_wg + warp * 16 + g + 8 * h2;
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                a_b + a_off(r, col / 8) + (col % 8) * 2);
            const float2 xv = a.residual ? __bfloat1622float2(*p) : make_float2(0.f, 0.f);
            *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[o][4 * jb + 2 * h2] + b.x + xv.x,
                                                        acc[o][4 * jb + 2 * h2 + 1] + b.y + xv.y);
          }
        }
      fence_async_smem();
      named_bar_sync(4 + wc, 128);
      if (leader) {
        for (int cb = 0; cb < COUT / 64; ++cb)
          tma_store_2d(&out_map, sA + cb * kRows * ffw::kRowBytes + r_wg * ffw::kRowBytes, cb * 64,
                       int(m0) + r_wg);
        bulk_commit();
        bulk_wait_read<0>();
      }
    } else {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r_wg + warp * 16 + g + 8 * h2;
        if (r >= nrows) continue;
        bf16* row = a.out + (m0 + r) * COUT;
#pragma unroll
        for (int o = 0; o < NO; ++o)
#pragma unroll
          for (int jb = 0; jb < CB / 8; ++jb) {
            const int col = o * CB + jb * 8 + 2 * t4;
            const float2 b =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b2 + col));
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(acc[o][4 * jb + 2 * h2] + b.x, acc[o][4 * jb + 2 * h2 + 1] + b.y);
          }
      }
    }
  }
}

template <int COUT>
cudaError_t launch(const void* wg, const void* w2, const Args& a, int grid, int smem,
                   cudaStream_t st) {
  constexpr uint32_t CB = ffw::OutBlocks<COUT>::kCB;
  const uint64_t c = a.c, in = a.inner;
  CUtensorMap x_map, xh_map, out_map, wg_map, w2_map;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // x (M, c): 64 columns x 128 rows (the tile), 64 x 64 (a warpgroup's rows);
  // out (M, cout): 64 x 64. Rows past M read as zero and are not written.
  const uint64_t x_dims[2] = {c, uint64_t(a.M)}, x_strides[1] = {c * 2};
  const uint32_t x_box[2] = {64, kRows}, half_box[2] = {64, kRows / 2};
  const uint64_t o_dims[2] = {COUT, uint64_t(a.M)}, o_strides[1] = {COUT * 2};
  // Wg (2*inner, c) as (c, inner, [value, gate]): 64 columns x 32 rows x 2
  const uint64_t wg_dims[3] = {c, in, 2}, wg_strides[2] = {c * 2, in * c * 2};
  const uint32_t wg_box[3] = {64, 32, 2};
  // W2 (cout, inner): 64 inner columns x kCB rows
  const uint64_t w2_dims[2] = {in, COUT}, w2_strides[1] = {in * 2};
  const uint32_t w2_box[2] = {64, CB};
  if (!encode_bf16_map(&x_map, a.x, 2, x_dims, x_strides, x_box, sw) ||
      !encode_bf16_map(&xh_map, a.x, 2, x_dims, x_strides, half_box, sw) ||
      !encode_bf16_map(&out_map, a.out, 2, o_dims, o_strides, half_box, sw) ||
      !encode_bf16_map(&wg_map, wg, 3, wg_dims, wg_strides, wg_box, sw) ||
      !encode_bf16_map(&w2_map, w2, 2, w2_dims, w2_strides, w2_box, sw))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ln_ff_kernel<COUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ln_ff_kernel<COUT><<<grid, kThreads, smem, st>>>(x_map, xh_map, out_map, wg_map, w2_map, a);
  return cudaGetLastError();
}

}  // namespace

// x: (M, c); ln_w, ln_b: (c,); wg: (2*inner, c); bg: (2*inner,); w2: (cout, inner);
// b2: (cout,); out: (M, cout). All bf16, contiguous, 16-byte aligned. exact:
// erf gelu, else tanh. The plan of ops/fused_block.py:plan: grid CTAs (128 rows
// each), a ring of depth slots, smem bytes of shared memory.
extern "C" int cak_ln_ff(const void* x, const void* ln_w, const void* ln_b, const void* wg,
                         const void* bg, const void* w2, const void* b2, void* out, int64_t M,
                         int c, int inner, int cout, int residual, int exact, float eps, int grid,
                         int depth, int smem, void* stream) {
  auto p = [](const void* v) { return static_cast<const bf16*>(v); };
  const int64_t tiles = (M + kRows - 1) / kRows;
  if (M < 1 || c < 64 || c > 320 || c % 64 || cout < 64 || cout > 320 || cout % 64 ||
      inner < 64 || inner % 64 || (residual && cout != c) || grid != tiles ||
      depth != ring_depth(c, cout) ||
      depth < 2 || smem != smem_bytes(c, cout, depth))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{p(x), p(ln_w), p(ln_b), p(bg), p(b2), static_cast<bf16*>(out), M, c, inner,
               residual, exact, depth, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
#define CAK_LN_FF_CASE(COUT) \
  case COUT:                 \
    return static_cast<int>(launch<COUT>(wg, w2, a, grid, smem, st));
    CAK_LN_FF_CASE(64)
    CAK_LN_FF_CASE(128)
    CAK_LN_FF_CASE(192)
    CAK_LN_FF_CASE(256)
    CAK_LN_FF_CASE(320)
#undef CAK_LN_FF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
