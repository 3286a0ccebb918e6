// K2: non-causal flash attention forward, softmax(Q K^T / sqrt(H)) V, bf16 in
// and out, fp32 softmax.
//
// Replaces: ctrl_adapter_tpu/ops/flash_attention.py, attention_bnth -> the
// Pallas TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention.
//
// What bounds it on the H100: flops. At the SVD shapes (T = 4096 or 1024,
// H = 64) one (b, n) pair does 4*T*T*H flops against 4*T*H*2 bytes of Q/K/V/O,
// ~T/2 flop per byte, far above the ~295 flop/byte ridge: the tensor cores
// bound it (0.61 ms at (28, 5, 4096, 64)). At H = 64 the softmax's exp2 work
// (T*T per pair, on the SFU's 16 a clock per SM) is as long as the MMAs, so it
// has to run beside them. The T x T logits never reach device memory.
//
// Design (Hopper, warp-specialised; 384 threads; persistent: one CTA per SM
// walks the 128-row Q tiles of all (b, n) pairs):
// - warpgroup 0 is the producer: it gives up registers (setmaxnreg) and one
//   thread issues TMA loads (4-D tensor maps over the strided (B, N, T, H)
//   views, 128-byte swizzle, 64-column boxes) of each Q tile, once the last
//   tile's QK^T products are done, and of the 128-row K and V tiles into a
//   ring of kStages slots, each slot with a K-full, a V-full and an empty
//   mbarrier, so the next tile's loads overlap this tile's last products;
// - warpgroups 1 and 2 are consumers, 64 query rows each. Per K/V tile:
//   S = Q K^T on wgmma (m64n128k16, Q and K from shared memory, K-major),
//   online softmax in fp32 registers (exp2, running max and sum), P packed to
//   bf16 in registers as the A operand of O += P V (wgmma m64nHk16, V from
//   shared memory MN-major, transposed by the instruction);
// - each consumer issues S_j and P_{j-1} V_{j-1} back to back and runs the
//   softmax of S_j while P_{j-1} V_{j-1} is in flight; the two consumers take
//   turns issuing (named barriers 1 and 2, ping-pong), so one warpgroup's
//   softmax runs beside the other's MMAs;
// - the output is normalised in registers and stored to the (B, T, N, H)
//   buffer through its (B, N, T, H) strides; where an LSE buffer is given
//   (training), each row's log-sum-exp of the scaled logits, (m + log2 l) ln 2,
//   goes to it in fp32 for the backward (csrc/flash_attention_bwd.cu); with a
//   null pointer nothing more is written.
// Head dims 40 and 80 run the same code at HD = 64 and 128
// (flash_fwd_narrow_kernel): the tensor maps declare the true H columns and
// keep 64-column boxes, so TMA fills the columns past H with zeros (it reads
// nothing of the next head's), Q K^T over them is exact, P V gives zero
// columns there, and the epilogue stores H / 8 column groups; the padded
// products cost about as long as the exp2 work, which bounds these shapes.
// Shapes: T % 128 == 0, H in {40, 64, 80, 128}; the views need 16-byte aligned bases
// and byte strides that are multiples of 16 (TMA), which ops/flash_attention.py
// checks. The host plan (ops/flash_attention.py:plan) chooses the grid and the
// shared memory; cak_flash_attention refuses a plan that does not match Cfg.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;       // query rows per CTA (two consumer warpgroups)
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRowBytes = 128; // one swizzle atom: 64 bf16 columns

template <int HD>
struct Cfg {
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kCols = HD / 64;                   // 64-column blocks per row
  static constexpr int kTile = kBN * HD * 2;              // bytes of one K or V tile (and Q)
  static constexpr int kK = kTile;                        // Q at 0
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kSmem = kBar + 8 * (2 + 3 * kStages) + 1024;  // + alignment slack
};

// 2^x on the SFU (ex2.approx, flush to zero): the softmax's only transcendental.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Descriptor of a K-major operand whose rows are 128-byte swizzled atoms
// (8-row groups 1024 bytes apart), k-step kk of 16 columns.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  const uint32_t addr = tile + (kk / 4) * rows * kRowBytes + (kk % 4) * 32;
  return wgmma_desc(addr, 16, 1024, 1);
}

// The kernel at Cfg<HD> for a true head dim HT <= HD (the header's "Head dims
// 40 and 80"): only HT columns are stored.
template <int HD, int HT>
__device__ __forceinline__ void flash_fwd(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v, bf16* __restrict__ o,
                                          float* __restrict__ lse, int N, int T, int n_work,
                                          int64_t osb, int64_t osn, int64_t ost,
                                          float scale_log2) {
  static_assert(HT % 8 == 0 && HT <= HD, "stores whole 8-column groups of the tile");
  using C = Cfg<HD>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t sQ = base, sK = base + C::kK, sV = base + C::kV;
  const uint32_t q_full = base + C::kBar, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 16 + 8 * s; };
  auto v_full = [&](int s) { return q_full + 16 + 8 * (S + s); };
  auto empty = [&](int s) { return q_full + 16 + 8 * (2 * S + s); };

  const int q_tiles = T / kBM, n_tiles = T / kBN;
  // work item w: Q tile w % q_tiles of (b, n) pair w / q_tiles; this CTA takes
  // blockIdx.x, blockIdx.x + gridDim.x, ...
  const int my_work = (n_work - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int g = 0;  // K/V tiles loaded so far
      for (int i = 0; i < my_work; ++i) {
        const int w = blockIdx.x + i * gridDim.x;
        const int bh = w / q_tiles, b = bh / N, n = bh % N, q0 = (w % q_tiles) * kBM;
        if (i > 0) mbar_wait(q_empty, (i - 1) & 1);  // the last tile's S products are done
        mbar_expect_tx(q_full, C::kTile);
        for (int cb = 0; cb < C::kCols; ++cb)
          tma_load_4d(sQ + cb * kBM * kRowBytes, &tm_q, q_full, cb * 64, q0, n, b);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty(s), ((g / S) & 1) ^ 1);
          mbar_expect_tx(k_full(s), C::kTile);
          for (int cb = 0; cb < C::kCols; ++cb)
            tma_load_4d(sK + s * C::kTile + cb * kBN * kRowBytes, &tm_k, k_full(s), cb * 64,
                        j * kBN, n, b);
          mbar_expect_tx(v_full(s), C::kTile);
          for (int cb = 0; cb < C::kCols; ++cb)
            tma_load_4d(sV + s * C::kTile + cb * kBN * kRowBytes, &tm_v, v_full(s), cb * 64,
                        j * kBN, n, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wc = wg - 1;  // rows q0 + 64*wc .. +64 of each Q tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int bar_mine = 1 + wc, bar_other = 2 - wc;
    const uint32_t sQw = sQ + wc * 64 * kRowBytes;

    float o_acc[HD / 2];
    float s_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s_acc[i] = 0.f;
    uint32_t p_frag[kBN / 16][4];
    float m_run[2], l_run[2];  // running max (exp2 units), per-thread partial row sums

    // Section k of this warpgroup waits for the other's section k - 1 (or,
    // for warpgroup 1's first, for warpgroup 2's start): they alternate, across
    // the CTA's tiles. Warpgroup 2 skips its arrive after its last section, so
    // every arrive meets a sync.
    int section = 0;
    const int sections = my_work * (n_tiles + 1);
    auto turn_begin = [&]() { named_bar_sync(bar_mine, 256); };
    auto turn_end = [&]() {
      ++section;
      if (wc == 0 || section < sections) named_bar_arrive(bar_other, 256);
    };
    if (wc == 1) named_bar_arrive(bar_other, 256);

    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n128<0>(s_acc, kmajor_desc(sQw, kBM, kk),
                         kmajor_desc(sK + s * C::kTile, kBN, kk), kk > 0);
    };
    auto issue_pv = [&](int s) {
      // V (keys x H) MN-major: 8-key groups 1024 bytes apart (SBO), 64-column
      // blocks kBN rows apart (LBO); k-step kk starts at key 16*kk.
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv =
            wgmma_desc(sV + s * C::kTile + kk * 16 * kRowBytes, kBN * kRowBytes, 1024, 1);
        if constexpr (HD == 64) {
          wgmma_rs_n64<1>(o_acc, p_frag[kk], dv);
        } else {
          wgmma_rs_n128<1>(o_acc, p_frag[kk], dv);
        }
      }
    };
    // Softmax of the scores in s_acc: returns the rescale factor of the old
    // accumulator per row half and leaves P (unnormalised) in s_acc.
    auto softmax = [&](float (&alpha)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s_acc[4 * j + 2 * h], s_acc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx * scale_log2);
        alpha[h] = fast_exp2(m_run[h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(fmaf(s_acc[4 * j + 2 * h + e], scale_log2, -m_new));
            s_acc[4 * j + 2 * h + e] = p;
            rs += p;
          }
        }
        l_run[h] = l_run[h] * alpha[h] + rs;
        m_run[h] = m_new;
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        p_frag[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
        p_frag[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        p_frag[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        p_frag[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
    };

    int g = 0;  // K/V tiles consumed so far
    for (int i = 0; i < my_work; ++i) {
      const int w = blockIdx.x + i * gridDim.x;
      const int bh = w / q_tiles, b = bh / N, n = bh % N, q0 = (w % q_tiles) * kBM;
#pragma unroll
      for (int d = 0; d < HD / 2; ++d) o_acc[d] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      mbar_wait(q_full, i & 1);

      // K/V tile 0: S_0 and its softmax
      mbar_wait(k_full(g % S), (g / S) & 1);
      turn_begin();
      wgmma_fence();
      issue_s(g % S);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (n_tiles == 1) mbar_arrive(q_empty);  // Q read for the last time
      {
        float alpha[2];
        softmax(alpha);
      }
      pack_p();

      for (int j = 1; j < n_tiles; ++j) {
        const int s = (g + j) % S, sp = (g + j - 1) % S;
        mbar_wait(k_full(s), ((g + j) / S) & 1);
        turn_begin();
        fence_regs(o_acc);
        fence_regs(p_frag);
        wgmma_fence();
        issue_s(s);
        wgmma_commit();
        mbar_wait(v_full(sp), ((g + j - 1) / S) & 1);
        issue_pv(sp);
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();  // S_j done, P_{j-1} V_{j-1} may still run
        fence_regs(s_acc);
        if (j == n_tiles - 1) mbar_arrive(q_empty);
        float alpha[2];
        softmax(alpha);
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(p_frag);
        mbar_arrive(empty(sp));
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          o_acc[4 * d + 0] *= alpha[0];
          o_acc[4 * d + 1] *= alpha[0];
          o_acc[4 * d + 2] *= alpha[1];
          o_acc[4 * d + 3] *= alpha[1];
        }
        pack_p();
      }

      // the last P V
      const int sl = (g + n_tiles - 1) % S;
      mbar_wait(v_full(sl), ((g + n_tiles - 1) / S) & 1);
      turn_begin();
      fence_regs(o_acc);
      fence_regs(p_frag);
      wgmma_fence();
      issue_pv(sl);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(empty(sl));
      g += n_tiles;

      bf16* ob = o + b * osb + n * osn;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_run[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;
        const int row = q0 + wc * 64 + warp * 16 + g8 + 8 * h;
        if (lse != nullptr && t4 == 0)
          lse[(int64_t(b) * N + n) * T + row] = (m_run[h] + __log2f(l)) * 0.6931471805599453f;
#pragma unroll
        for (int d = 0; d < HT / 8; ++d) {
          *reinterpret_cast<uint32_t*>(ob + int64_t(row) * ost + d * 8 + 2 * t4) =
              pack_bf16(o_acc[4 * d + 2 * h] * inv, o_acc[4 * d + 2 * h + 1] * inv);
        }
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int N, int T, int n_work, int64_t osb,
                     int64_t osn, int64_t ost, float scale_log2) {
  flash_fwd<HD, HD>(tm_q, tm_k, tm_v, o, lse, N, T, n_work, osb, osn, ost, scale_log2);
}

// Head dims 40 and 80 (the SD-v1.5 ControlNet's 8 heads at 320 and 640
// channels) on the tiles of HD = 64 and 128; a name of its own, so that a
// trace tells it from the kernel above.
template <int HD, int HT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                            float* __restrict__ lse, int N, int T, int n_work, int64_t osb,
                            int64_t osn, int64_t ost, float scale_log2) {
  flash_fwd<HD, HT>(tm_q, tm_k, tm_v, o, lse, N, T, n_work, osb, osn, ost, scale_log2);
}

// The (B, N, T, H) view at `p` with element strides sb, sn, st as a 4-D map
// (H, T, N, B) of 64-column x 128-row boxes.
bool make_map(CUtensorMap* map, const void* p, int B, int N, int T, int H, int64_t sb,
              int64_t sn, int64_t st) {
  const uint64_t dims[4] = {uint64_t(H), uint64_t(T), uint64_t(N), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(st) * 2, uint64_t(sn) * 2, uint64_t(sb) * 2};
  const uint32_t box[4] = {64, kBN, 1, 1};
  return encode_bf16_map(map, p, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launches the plan's grid of persistent CTAs (1 .. n_work) with its shared
// memory, which must be Cfg<HD>'s; head dim HT, maps of HT columns.
template <int HD, int HT = HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int N, int T, int grid, int smem, const int64_t* st, float scale,
                   cudaStream_t stream) {
  const int n_work = (T / kBM) * B * N;  // Q tiles over all (b, n) pairs
  if (smem != Cfg<HD>::kSmem || grid < 1 || grid > n_work) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, N, T, HT, st[0], st[1], st[2]) ||
      !make_map(&mk, k, B, N, T, HT, st[3], st[4], st[5]) ||
      !make_map(&mv, v, B, N, T, HT, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  if constexpr (HT == HD) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), lse, N, T, n_work, st[9], st[10], st[11], scale_log2);
  } else {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_narrow_kernel<HD, HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    flash_fwd_narrow_kernel<HD, HT><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), lse, N, T, n_work, st[9], st[10], st[11], scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, N, T, H) bf16 views with unit last stride; strides (in
// elements) of the b, n and t axes for q, k, v, o in that order. lse: null, or
// a contiguous (B, N, T) fp32 buffer for the rows' log-sum-exp. grid and smem:
// the plan of ops/flash_attention.py:plan.
extern "C" int cak_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int N, int T, int H, int grid, int smem,
                                   int64_t qsb, int64_t qsn,
                                   int64_t qst, int64_t ksb, int64_t ksn, int64_t kst,
                                   int64_t vsb, int64_t vsn, int64_t vst, int64_t osb,
                                   int64_t osn, int64_t ost, float scale, void* stream) {
  const int64_t st[12] = {qsb, qsn, qst, ksb, ksn, kst, vsb, vsn, vst, osb, osn, ost};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T % kBM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (H == 64) {
    e = launch<64>(q, k, v, o, static_cast<float*>(lse), B, N, T, grid, smem, st, scale, s);
  } else if (H == 128) {
    e = launch<128>(q, k, v, o, static_cast<float*>(lse), B, N, T, grid, smem, st, scale, s);
  } else if (H == 40) {
    e = launch<64, 40>(q, k, v, o, static_cast<float*>(lse), B, N, T, grid, smem, st, scale, s);
  } else if (H == 80) {
    e = launch<128, 80>(q, k, v, o, static_cast<float*>(lse), B, N, T, grid, smem, st, scale, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
