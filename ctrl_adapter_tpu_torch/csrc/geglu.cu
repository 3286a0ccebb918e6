// K5: out = value * gelu(gate), [value; gate] = x . W^T + b, on (M, c) rows;
// only the half-width product (M, D) is written.
//
// Replaces: ctrl_adapter_tpu/ops/fused_ff.py, geglu -> _pallas_geglu (Pallas
//   body _kernel): fp32 accumulation, bias and gelu in fp32, one rounding.
//
// What bounds it on the H100: 2*c*2D flops per row against 2*c + 2*D bytes
// (~c flop per byte, 320-640 on the GEGLU shapes), just above the ~295
// flop/byte ridge: the tensor cores bound it (0.190 ms at (114688, 320 ->
// 2x1280) and (28672, 640 -> 2x2560)), and writing the (M, D) output takes
// more than half of that time. K is short (c = 320 or 640: 5 or 10 stages of
// 64 channels), so the GEGLU epilogue is a large share of a tile.
//
// Design (Hopper, warp-specialised, persistent; 384 threads, one CTA per SM
// walking tiles of 128 rows x 64 outputs, column tiles of a row tile on
// neighbouring CTAs so that x is read from L2):
// - warpgroup 0 is the producer: one thread loads, per 64 channels of a tile,
//   the x chunk (128 x 64) and the matching 64 value rows and 64 gate rows of
//   W (TMA, 128-byte swizzle; rows and channels past the tensors read as zero)
//   into a ring of kStages slots (ff_wgmma.cuh: Ring, one reader per slot);
// - warpgroups 1 and 2 are consumers and take the CTA's tiles in turn. A tile's
//   product runs on wgmma m64n128k16 for each 64-row half: value and gate are
//   the two 64-column blocks of one product, so each thread holds both halves
//   of its outputs (128 fp32 accumulators). The two warpgroups issue their
//   products in turns (ff_wgmma.cuh: PingPong, a turn per tile), so one's
//   epilogue runs while the other's products run;
// - the epilogue adds the bias, computes value * gelu(gate) in fp32 (the SFU's
//   tanh, or erf under `exact`), rounds once, writes the 128 x 64 tile to this
//   warpgroup's staging buffer (128-byte swizzled rows) and stores it with one
//   TMA store (rows past M are not written).
// Shapes: c % 8 == 0 (TMA strides), D % 64 == 0, any M. The host plan
// (ops/fused_ff.py:plan) chooses the grid and the shared memory; cak_geglu
// refuses a plan that does not match.
#include <type_traits>

#include "ff_wgmma.cuh"

namespace {

constexpr int kBM = 128;                            // rows of a tile
constexpr int kBD = 64;                             // outputs of a tile (and as many gates)
constexpr int kBK = 64;                             // channels per stage
constexpr int kThreads = 384;
constexpr int kStages = 5;
constexpr int kXBytes = kBM * kBK * 2;              // x chunk: 16 KB
constexpr int kStage = kXBytes + 2 * kBD * kBK * 2;  // + [value; gate] rows of W: 32 KB
constexpr int kOut = kBM * kBD * 2;                 // a warpgroup's staging buffer: 16 KB
constexpr int kBar = kStages * kStage + 2 * kOut;
constexpr int kSmem = kBar + 16 * kStages + 1024;  // + mbarriers and alignment slack

struct Args {
  const bf16* bias;
  int d, exact, n_col, n_tiles, k_chunks;
};

__global__ void __launch_bounds__(kThreads, 1)
    geglu_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* gbase = smem_raw + (base - raw);
  const int wg = warpgroup_index();
  // this CTA's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...; tile t covers
  // rows 128 * (t / n_col) and outputs 64 * (t % n_col)
  const int my_tiles = (a.n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  ffw::Ring ring(base, base + kBar, kStages, kStage);  // a stage per 64 channels of a tile

  if (threadIdx.x == 0) {
    ring.init(1);  // one consumer warpgroup reads a stage
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();  // its tile arithmetic and three maps spill at 24
    if (threadIdx.x == 0) {
      for (int i = 0; i < my_tiles; ++i) {
        const int t = blockIdx.x + i * gridDim.x;
        const int r0 = (t / a.n_col) * kBM, d0 = (t % a.n_col) * kBD;
        for (int k = 0; k < a.k_chunks; ++k) {
          const uint32_t dst = ring.acquire(kStage), full = ring.full_bar();
          tma_load_2d(dst, &tm_x, full, k * kBK, r0);
          tma_load_2d(dst + kXBytes, &tm_w, full, k * kBK, d0);                          // value
          tma_load_2d(dst + kXBytes + kBD * kBK * 2, &tm_w, full, k * kBK, a.d + d0);  // gate
          ring.advance();
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<232>();  // 2 x 128 x 232 + 128 x 40 registers: the SM's 64 K
    const int wc = wg - 1;  // takes the CTA's tiles wc, wc + 2, ...
    const int tid = threadIdx.x & 127, warp = tid / 32, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool leader = tid == 0;
    const uint32_t s_out = base + kStages * kStage + wc * kOut;
    unsigned char* out_b = gbase + kStages * kStage + wc * kOut;
    // `ring` at the next stage to wait for, `done` one stage behind it, at the
    // next to release; both step over the other warpgroup's tiles' stages
    ffw::Ring done = ring;
    auto skip_tile = [&](ffw::Ring& r) {
      for (int k = 0; k < a.k_chunks; ++k) r.advance();
    };
    ffw::PingPong<true> turns(wc, my_tiles);  // a turn per tile: its products' issue
    if (wc == 1) {
      skip_tile(ring);
      skip_tile(done);
    }

    for (int i = wc; i < my_tiles; i += 2) {
      const int t = blockIdx.x + i * gridDim.x;
      const int r0 = (t / a.n_col) * kBM, d0 = (t % a.n_col) * kBD;
      float acc[2][64];  // 64-row halves; columns 0..63 value, 64..127 gate

      turns.begin();
      for (int k = 0; k < a.k_chunks; ++k) {
        const uint32_t sx = ring.wait(), sw = sx + kXBytes;
        ring.advance();
        if (k > 0) {
          fence_regs(acc[0]);
          fence_regs(acc[1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_ss_n128<0>(acc[h], ffw::sw128_desc(sx + h * 64 * ffw::kRowBytes + kk * 32),
                             ffw::sw128_desc(sw + kk * 32), k > 0 || kk > 0);
        wgmma_commit();
        if (k > 0) {  // the previous stage's products are done: release it
          wgmma_wait<1>();
          done.release(leader);
        }
      }
      turns.end();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      done.release(leader);
      skip_tile(ring);  // the other warpgroup's next tile
      skip_tile(done);

      // epilogue: the staging buffer is free once its last store has read it
      if (leader) bulk_wait_read<0>();
      named_bar_sync(4 + wc, 128);
      __nv_bfloat162 bv[8], bgt[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bv[j] = *reinterpret_cast<const __nv_bfloat162*>(a.bias + d0 + 8 * j + 2 * t4);
        bgt[j] = *reinterpret_cast<const __nv_bfloat162*>(a.bias + a.d + d0 + 8 * j + 2 * t4);
      }
      auto epilogue = [&](auto exact) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = 64 * h + 16 * warp + g + 8 * h2;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 bvf = __bfloat1622float2(bv[j]), bgf = __bfloat1622float2(bgt[j]);
              const float v0 = acc[h][4 * j + 2 * h2] + bvf.x, v1 = acc[h][4 * j + 2 * h2 + 1] + bvf.y;
              const float g0 = acc[h][4 * (j + 8) + 2 * h2] + bgf.x;
              const float g1 = acc[h][4 * (j + 8) + 2 * h2 + 1] + bgf.y;
              *reinterpret_cast<uint32_t*>(out_b + r * ffw::kRowBytes + ((j ^ (r % 8)) << 4) +
                                           4 * t4) =
                  pack_bf16(v0 * ffw::gelu<decltype(exact)::value>(g0),
                            v1 * ffw::gelu<decltype(exact)::value>(g1));
            }
          }
      };
      if (a.exact) {
        epilogue(std::true_type{});
      } else {
        epilogue(std::false_type{});
      }
      fence_async_smem();
      named_bar_sync(4 + wc, 128);
      if (leader) {
        tma_store_2d(&tm_out, s_out, d0, r0);
        bulk_commit();
      }
    }
    if (leader) bulk_wait<0>();
  }
}

}  // namespace

// x: (M, c); w: (2*d, c) = [value rows; gate rows]; bias: (2*d,); out: (M, d).
// All bf16, contiguous, 16-byte aligned. exact: erf gelu, else tanh. The plan
// of ops/fused_ff.py:plan: `grid` persistent CTAs over the ceil(M / 128) *
// (d / 64) tiles, smem bytes of shared memory.
extern "C" int cak_geglu(const void* x, const void* w, const void* bias, void* out, int64_t M,
                         int c, int d, int exact, int grid, int smem, void* stream) {
  const int64_t tiles = (M + kBM - 1) / kBM * (d / kBD);
  if (M < 1 || c < 8 || c % 8 || d < kBD || d % kBD || tiles > (int64_t(1) << 30) || grid < 1 ||
      grid > tiles || smem != kSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w, tm_out;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t x_dims[2] = {uint64_t(c), uint64_t(M)}, x_strides[1] = {uint64_t(c) * 2};
  const uint32_t x_box[2] = {kBK, kBM};
  const uint64_t w_dims[2] = {uint64_t(c), uint64_t(2 * d)}, w_strides[1] = {uint64_t(c) * 2};
  const uint32_t w_box[2] = {kBK, kBD};
  const uint64_t o_dims[2] = {uint64_t(d), uint64_t(M)}, o_strides[1] = {uint64_t(d) * 2};
  const uint32_t o_box[2] = {kBD, kBM};
  if (!encode_bf16_map(&tm_x, x, 2, x_dims, x_strides, x_box, sw) ||
      !encode_bf16_map(&tm_w, w, 2, w_dims, w_strides, w_box, sw) ||
      !encode_bf16_map(&tm_out, out, 2, o_dims, o_strides, o_box, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(geglu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const bf16*>(bias), d, exact, d / kBD, static_cast<int>(tiles),
               (c + kBK - 1) / kBK};
  geglu_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(tm_x, tm_w, tm_out, a);
  return static_cast<int>(cudaGetLastError());
}
