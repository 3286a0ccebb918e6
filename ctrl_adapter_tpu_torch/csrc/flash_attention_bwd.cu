// K2 backward: the gradients of non-causal attention, softmax(s Q K^T) V with
// s = H^-1/2, from the forward's output O, its row log-sum-exp L and dO:
//   P = exp(s Q K^T - L),  D = rowsum(dO o O),  dV = P^T dO,
//   dS = P o (dO V^T - D),  dQ = s dS K,  dK = s dS^T Q.
// bf16 in and out, fp32 accumulation; the T x T matrices never reach device
// memory.
//
// Replaces: the custom VJP of jax.experimental.pallas.ops.tpu.flash_attention
// (its _flash_attention_bwd_dkv and _flash_attention_bwd_dq pallas_calls),
// reached from ctrl_adapter_tpu/ops/flash_attention.py:97 under grad.
//
// What bounds it on the H100: flops. Five T x T x H products per (b, n) pair
// (S, dP, dV, dQ, dK: 10 T^2 H flop) against ~16 T H bytes of Q, K, V, O, dO,
// dQ, dK, dV: ~T/2 flop per byte at H = 64, far above the ~295 flop/byte ridge
// (0.760 ms at (14, 5, 4096, 64) on the tensor cores' 989 TFLOP/s).
//
// Design: one pass over the keys that does the five products once each
// (FlashAttention-3's backward), warp-specialised on wgmma and TMA. Three
// launches on the stream:
// 1. pre-pass: D = rowsum(dO o O) in fp32 (H/8 threads a row, 16-byte loads),
//    the fp32 dQ scratch (B, N, T, H), the turn counters and the ticket
//    zeroed;
// 2. main kernel, T / 128 x B * N CTAs. Each takes its work item, (b, n, key
//    block), from a ticket (an atomic add) as it starts, key blocks fastest,
//    so the CTAs of one (b, n) pair run together and its dQ scratch stays in
//    L2. A CTA holds 128 keys (K and V loaded once by TMA, 128-byte swizzle)
//    and streams all T queries in tiles of QT (128 at H = 64, 64 at H =
//    128), starting at a tile of its own (below); 384 threads:
//    - warpgroup 0, the producer, gives up registers; one thread loads each
//      Q and dO tile by TMA (4-D maps over the strided views) and its L and D
//      by 1-D bulk copies into a two-slot ring (full / empty mbarriers);
//      another, the dQ writer, adds the consumers' dQ partials into the
//      scratch in turn (below);
//    - warpgroups 1 and 2, the consumers, own 64 keys each. Per tile:
//      S^T = K Q^T and dP^T = V dO^T (SS wgmma, K-major), P^T = exp2(s log2e
//      S^T - L log2e) and dS^T = P^T o (dP^T - D) in fp32 registers, packed
//      to bf16 straight from the accumulators as the A operand of dV += P^T dO
//      and dK += dS^T Q (RS wgmma, dO and Q MN-major). dS^T also goes to
//      shared memory (bf16, swizzled, two buffers); after a named barrier
//      between the consumers, dQ_partial = dS K over all 128 keys (SS wgmma,
//      A = dS^T read MN-major with the transpose-A immediate, B = K
//      MN-major): each consumer takes 64 queries at H = 64, 64 columns of H
//      at H = 128. The partial (fp32, 64 x 64) is staged in shared memory and
//      handed to the writer (stg_full / stg_empty mbarriers). One slot a
//      consumer: a second would put the layout 80 bytes over the 232,448 a
//      block may have, so a consumer waits at the stage until the writer has
//      read its last partial;
//    - dK (x s) and dV leave as bf16 through their (B, N, T, H) strides; each
//      CTA owns its keys, so they need no atomics and are the same bit for
//      bit from run to run;
// 3. convert: dQ = s * scratch, rounded to bf16, into the (B, N, T, H) view.
//
// dQ in a fixed order. Every query tile of a (b, n) pair gets the partials of
// its T / 128 key blocks added in one order, set by the indices alone, so two
// calls give the same bits (as the TPU kernel, whose dQ kernel owns a block of
// queries and sums over the key blocks in grid order). The key blocks are cut
// into groups of G consecutive ones (the host plan: the largest divisor of T /
// 128 that is not above the SM count; all of them up to T = 16384 on an H100).
// Key block j, member l = j % G of group c = j / G, walks the nq = T / QT
// query tiles from tile l span, span = nq / G, round to the start. At tile i
// its step is s = (i - l span) mod nq, and its turn there is c G + s / span:
// the groups in order, and within a group member i / span first (integer
// division), then the member before it, and so on round the group. The writer,
// at step s, spins with an acquire load until the tile's int32 counter reads
// its turn, issues the two consumers' reduce-adds, waits for their completion
// (not only for the read of the staging slots), fences the async proxy and
// adds 1 to the counter with release semantics. So the adds to one tile never
// overlap and come in turn order; with the start rotated, the CTAs of a group
// reach each tile one after the other and, at step s, wait only for their
// neighbour's step s - span, done span steps earlier.
//
// No deadlock. A CTA takes the next ticket as it starts, so the items with
// lower tickets (all earlier pairs, and the earlier groups and members of its
// own pair) belong to CTAs that have started. A CTA waits only on its group
// and on the earlier groups of its pair. By induction over the tickets'
// groups: once the groups before one have finished, the CTAs still running are
// that group's members that have started, fewer than G, which is at most the
// SM count, and one CTA fits an SM (the shared memory allows one), so the next
// CTA starts and takes the group's next ticket, until the whole group is
// resident. Inside a resident group, by induction over the steps: the writer
// at step s waits for its neighbour's step s - span, which needs only steps
// below s; the producer and the consumers wait on nothing outside their CTA,
// and on their writer only for its last step. The argument needs the card's
// SMs for this kernel alone up to G CTAs; another kernel running beside it on
// the card delays it until that kernel ends, and no kernel of the port waits
// on this one. A wait that outlasts ~2^34 cycles traps instead of hanging the
// card.
//
// Shapes: T % 128 == 0, H in {64, 128}; Q, K, V, dO need 16-byte aligned
// bases and byte strides that are multiples of 16 (TMA), O and the outputs
// 16-byte aligned rows, which ops/flash_attention.py checks. L and D are
// contiguous (B, N, T) fp32. The host plan (ops/flash_attention.py:bwd_plan)
// gives the query tile, the shared memory and G; cak_flash_attention_bwd
// refuses a plan that does not match BwdCfg.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 128;      // keys per CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kRowBytes = 128;  // one swizzle atom: 64 bf16 or 32 fp32 columns
constexpr int kPrepThreads = 256;

template <int HD>
struct BwdCfg {
  static constexpr int kQT = HD == 64 ? 128 : 64;  // queries per streamed tile
  static constexpr int kCols = HD / 64;            // 64-column blocks of a row
  static constexpr int kKV = kKeys * HD * 2;       // bytes of K (or V)
  static constexpr int kQTile = kQT * HD * 2;      // bytes of a Q (or dO) tile
  static constexpr int kDSBuf = kKeys * kQT * 2;   // bytes of dS^T (bf16)
  static constexpr int kStg = 64 * 64 * 4;         // a consumer's fp32 dQ partial
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;              // [slot][col block][kQT rows][128 B]
  static constexpr int kDO = kQ + 2 * kQTile;
  static constexpr int kDS = kDO + 2 * kQTile;     // [buffer][query block][128 keys][128 B]
  static constexpr int kSt = kDS + 2 * kDSBuf;     // [consumer][32-col half][64 rows][128 B]
  static constexpr int kL = kSt + 2 * kStg;        // [slot][kQT] fp32
  static constexpr int kD = kL + 2 * kQT * 4;      // [slot][kQT] fp32
  // kv_full, full[2], empty[2], stg_full[2], stg_empty[2]
  static constexpr int kBar = kD + 2 * kQT * 4;
  static constexpr int kTicket = kBar + 8 * 9;     // this CTA's work item (int32)
  static constexpr int kSmem = kTicket + 8 + 1024;  // + alignment slack
};

struct View {
  int64_t sb, sn, st;  // element strides of the b, n and t axes (h: 1)
};

template <class E>
__device__ __forceinline__ E* row_ptr(E* p, const View& w, int b, int n, int t) {
  return p + b * w.sb + n * w.sn + int64_t(t) * w.st;
}

// 2^x on the SFU (ex2.approx, flush to zero), as the forward's softmax.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Descriptor of a K-major operand whose rows are 128-byte swizzled atoms
// (8-row groups 1024 bytes apart, 64-column blocks `rows` rows apart), k-step
// kk of 16 columns.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  const uint32_t addr = tile + (kk / 4) * rows * kRowBytes + (kk % 4) * 32;
  return wgmma_desc(addr, 16, 1024, 1);
}

// Descriptor of an MN-major operand (rows along K, 64-element blocks along
// M or N `rows` rows apart), k-step kk of 16 rows.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return wgmma_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes, 1024, 1);
}

// Pre-pass: D = rowsum(dO o O) of every (b, n, t) row, H/8 threads a row, and
// that row of the fp32 dQ scratch zeroed; the counter of each query tile
// (rows / QT of them, then the ticket) zeroed.
template <int HD>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, View vo,
                          View vdo, float* __restrict__ dvec, float* __restrict__ dq_acc,
                          int* __restrict__ counters, int N, int T, int rows) {
  constexpr int kTpr = HD / 8, kQT = BwdCfg<HD>::kQT;
  const int gid = blockIdx.x * kPrepThreads + threadIdx.x;
  const int row = gid / kTpr, part = gid % kTpr;
  float acc = 0.f;
  if (row < rows) {
    const int t = row % T, bn = row / T;
    const uint4 ov = *reinterpret_cast<const uint4*>(row_ptr(o, vo, bn / N, bn % N, t) + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(row_ptr(dout, vdo, bn / N, bn % N, t) +
                                                     part * 8);
    const bf16* po = reinterpret_cast<const bf16*>(&ov);
    const bf16* pd = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(bf2f(po[i]), bf2f(pd[i]), acc);
    float4* z = reinterpret_cast<float4*>(dq_acc + int64_t(row) * HD + part * 8);
    z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (part == 0 && row % kQT == 0) counters[row / kQT] = 0;
  }
  if (gid == 0) counters[rows / kQT] = 0;  // the ticket
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) dvec[row] = acc;
}

// Convert: dQ = scale * scratch as bf16 into the (B, N, T, H) view, 8 values a
// thread.
template <int HD>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_dq_convert_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, View vdq,
                                int N, int T, int rows, float scale) {
  constexpr int kTpr = HD / 8;
  const int gid = blockIdx.x * kPrepThreads + threadIdx.x;
  const int row = gid / kTpr, part = gid % kTpr;
  if (row >= rows) return;
  const int t = row % T, bn = row / T;
  const float4* src = reinterpret_cast<const float4*>(dq_acc + int64_t(row) * HD + part * 8);
  const float4 a = src[0], c = src[1];
  const uint4 out =
      make_uint4(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
                 pack_bf16(c.x * scale, c.y * scale), pack_bf16(c.z * scale, c.w * scale));
  *reinterpret_cast<uint4*>(row_ptr(dq, vdq, bn / N, bn % N, t) + part * 8) = out;
}

struct MainArgs {
  const float* lse;
  const float* dvec;
  bf16 *dk, *dv;
  View vdk, vdv;
  int* counters;  // one per (b, n, query tile), then the ticket
  int N, T, group;
  float scale, scale_log2;
};

// Spin until the counter reads at least `turn` (acquire, GPU scope); a wait
// that outlasts ~2^34 cycles traps instead of hanging the card.
__device__ __forceinline__ void wait_turn(const int* counter, int turn) {
  const long long deadline = clock64() + (1ll << 34);
  while (ld_acquire_gpu(counter) < turn)
    if (clock64() > deadline) __trap();
}

// dK, dV of 128 keys of one (b, n) pair, and their share of dQ: T / 128 x
// B * N CTAs, each taking its (b, n, key block) from the ticket.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dq, const MainArgs a) {
  using C = BwdCfg<HD>;
  constexpr int QT = C::kQT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* gbase = smem_raw + (base - raw);  // the same, as a generic pointer
  const uint32_t sK = base + C::kK, sV = base + C::kV, sQ = base + C::kQ, sdO = base + C::kDO;
  const uint32_t kv_full = base + C::kBar;
  auto full = [&](int s) { return kv_full + 8 + 8 * s; };
  auto empty = [&](int s) { return kv_full + 24 + 8 * s; };
  auto stg_full = [&](int w) { return kv_full + 40 + 8 * w; };
  auto stg_empty = [&](int w) { return kv_full + 56 + 8 * w; };
  int* ticket = reinterpret_cast<int*>(gbase + C::kTicket);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
      mbar_init(stg_full(s), 128);
      mbar_init(stg_empty(s), 1);
    }
    mbar_fence_init();
    *ticket = atomicAdd(a.counters + int64_t(gridDim.y) * (a.T / QT), 1);
  }
  __syncthreads();

  const int nk = a.T / kKeys, item = *ticket;
  const int bn = item / nk, kb = item % nk, b = bn / a.N, n = bn % a.N, key0 = kb * kKeys;
  const int nq = a.T / QT;
  // this key block's walk: from tile `first`, its turn at step i turn0 + i / span
  const int span = nq / a.group, first = (kb % a.group) * span, turn0 = kb - kb % a.group;
  auto tile = [&](int i) { return first + i < nq ? first + i : first + i - nq; };
  const int wg = warpgroup_index();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKV);
      for (int cb = 0; cb < C::kCols; ++cb) {
        tma_load_4d(sK + cb * kKeys * kRowBytes, &tm_k, kv_full, cb * 64, key0, n, b);
        tma_load_4d(sV + cb * kKeys * kRowBytes, &tm_v, kv_full, cb * 64, key0, n, b);
      }
      const float* lse = a.lse + int64_t(bn) * a.T;
      const float* dvec = a.dvec + int64_t(bn) * a.T;
      for (int i = 0; i < nq; ++i) {
        const int s = i & 1, q0 = tile(i) * QT;
        if (i >= 2) mbar_wait(empty(s), ((i >> 1) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::kQTile + 2 * QT * 4);
        for (int cb = 0; cb < C::kCols; ++cb) {
          tma_load_4d(sQ + s * C::kQTile + cb * QT * kRowBytes, &tm_q, full(s), cb * 64, q0, n,
                      b);
          tma_load_4d(sdO + s * C::kQTile + cb * QT * kRowBytes, &tm_do, full(s), cb * 64, q0,
                      n, b);
        }
        bulk_load(base + C::kL + s * QT * 4, lse + q0, QT * 4, full(s));
        bulk_load(base + C::kD + s * QT * 4, dvec + q0, QT * 4, full(s));
      }
    } else if (threadIdx.x == 32) {
      // the dQ writer: both consumers' partials of step i, in the tile's turn
      int* counter = a.counters + int64_t(bn) * nq;
      for (int i = 0; i < nq; ++i) {
        const int t = tile(i);
        wait_turn(counter + t, turn0 + i / span);
        fence_async_global();
        for (int w = 0; w < 2; ++w) {
          mbar_wait(stg_full(w), i & 1);
          // H = 64: the consumer's 64 queries, all columns; H = 128: all 64
          // queries, its 64 columns
          const int row0 = bn * a.T + t * QT + (HD == 64 ? 64 * w : 0);
          const int col0 = HD == 64 ? 0 : 64 * w;
          const uint32_t src = base + C::kSt + w * C::kStg;
          tma_reduce_add_2d(&tm_dq, src, col0, row0);
          tma_reduce_add_2d(&tm_dq, src + 64 * kRowBytes, col0 + 32, row0);
        }
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(stg_empty(0));
        mbar_arrive(stg_empty(1));
        bulk_wait<0>();  // the adds are done in L2, not only read from shared memory
        fence_async_global();
        red_release_gpu_add(counter + t, 1);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int wc = wg - 1;  // keys key0 + 64*wc .. +64
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g8 = lane >> 2, t4 = lane & 3;
    const uint32_t sKw = sK + wc * 64 * kRowBytes, sVw = sV + wc * 64 * kRowBytes;
    // dQ_partial = dS K: at H = 64 this consumer's 64 queries of the tile
    // (query block wc of dS^T) over all H; at H = 128 all 64 queries over
    // columns 64*wc .. +64 of H (column block wc of K)
    const int qb = HD == 64 ? wc : 0, hb = HD == 64 ? 0 : wc;
    unsigned char* stg = gbase + C::kSt + wc * C::kStg;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    uint32_t p_frag[QT / 16][4], ds_frag[QT / 16][4];

    mbar_wait(kv_full, 0);
    for (int i = 0; i < nq; ++i) {
      const int s = i & 1;
      const uint32_t sQs = sQ + s * C::kQTile, sdOs = sdO + s * C::kQTile;
      mbar_wait(full(s), (i >> 1) & 1);

      // S^T = K_w Q^T, dP^T = V_w dO^T. The accumulators live in one tile
      // only (the first k-step overwrites them), so that their registers are
      // free again while dK, dV and dQ's products run.
      float st[QT / 2], dpt[QT / 2];  // -> P^T and dS^T: 64 keys x QT queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if constexpr (QT == 128) {
          wgmma_ss_n128<0>(st, kmajor_desc(sKw, kKeys, kk), kmajor_desc(sQs, QT, kk), kk > 0);
        } else {
          wgmma_ss_n64<0>(st, kmajor_desc(sKw, kKeys, kk), kmajor_desc(sQs, QT, kk), kk > 0);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if constexpr (QT == 128) {
          wgmma_ss_n128<0>(dpt, kmajor_desc(sVw, kKeys, kk), kmajor_desc(sdOs, QT, kk), kk > 0);
        } else {
          wgmma_ss_n64<0>(dpt, kmajor_desc(sVw, kKeys, kk), kmajor_desc(sdOs, QT, kk), kk > 0);
        }
      }
      wgmma_commit();

      // P^T from L (columns are queries: 8j + 2t4 and + 1 of this thread)
      const float* sl = reinterpret_cast<const float*>(gbase + C::kL + s * QT * 4);
      const float* sd = reinterpret_cast<const float*>(gbase + C::kD + s * QT * 4);
      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t4);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
        st[4 * j + 0] = fast_exp2(fmaf(st[4 * j + 0], a.scale_log2, -l0));
        st[4 * j + 1] = fast_exp2(fmaf(st[4 * j + 1], a.scale_log2, -l1));
        st[4 * j + 2] = fast_exp2(fmaf(st[4 * j + 2], a.scale_log2, -l0));
        st[4 * j + 3] = fast_exp2(fmaf(st[4 * j + 3], a.scale_log2, -l1));
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * t4);
        dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - d.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d.y);
      }
      // the accumulator layout of two n8 tiles is the A layout of one k16 step
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p_frag[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          ds_frag[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }
      }

      // dS^T (bf16) into buffer i & 1: row = key, 128-byte swizzled query
      // blocks; register e of k-step kk holds key row g8 + 8 (e & 1) of this
      // warp's 16 and queries 16 kk + 8 (e >> 1) + 2 t4, + 1
      unsigned char* dsb = gbase + C::kDS + (i & 1) * C::kDSBuf;
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 64 * wc + 16 * warp + g8 + 8 * (e & 1);
          const int chunk = (2 * kk + (e >> 1)) % 8;
          *reinterpret_cast<uint32_t*>(dsb + (kk / 4) * kKeys * kRowBytes + r * kRowBytes +
                                       ((chunk ^ g8) << 4) + 4 * t4) = ds_frag[kk][e];
        }
      }
      fence_async_smem();

      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major)
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(p_frag);
      fence_regs(ds_frag);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        if constexpr (HD == 64) {
          wgmma_rs_n64<1>(dv, p_frag[kk], mnmajor_desc(sdOs, QT, kk));
        } else {
          wgmma_rs_n128<1>(dv, p_frag[kk], mnmajor_desc(sdOs, QT, kk));
        }
      }
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        if constexpr (HD == 64) {
          wgmma_rs_n64<1>(dk, ds_frag[kk], mnmajor_desc(sQs, QT, kk));
        } else {
          wgmma_rs_n128<1>(dk, ds_frag[kk], mnmajor_desc(sQs, QT, kk));
        }
      }
      wgmma_commit();

      // dQ_partial = dS K over the 128 keys, once both consumers wrote dS^T
      named_bar_sync(1, 256);
      const uint32_t sDS = base + C::kDS + (i & 1) * C::kDSBuf + qb * kKeys * kRowBytes;
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_ss_n64<1, 1>(dq, mnmajor_desc(sDS, kKeys, kk),
                           mnmajor_desc(sK + hb * kKeys * kRowBytes, kKeys, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(empty(s));  // Q and dO of this slot read for the last time
      wgmma_wait<0>();
      fence_regs(dq);

      // stage the partial (fp32, two 32-column halves, 128-byte swizzle) once
      // the writer's reduce-adds of the last one have read the slot, and hand
      // it to the writer
      if (i > 0) mbar_wait(stg_empty(wc), (i - 1) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int chunk = 2 * (j % 4) + (t4 >> 1);
          *reinterpret_cast<float2*>(stg + (j / 4) * 64 * kRowBytes + r * kRowBytes +
                                     ((chunk ^ g8) << 4) + 8 * (t4 & 1)) =
              make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        }
      }
      fence_async_smem();
      mbar_arrive(stg_full(wc));
    }

    bf16* dkb = a.dk + b * a.vdk.sb + n * a.vdk.sn;
    bf16* dvb = a.dv + b * a.vdv.sb + n * a.vdv.sn;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = key0 + 64 * wc + 16 * warp + g8 + 8 * h;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkb + int64_t(row) * a.vdk.st + 8 * j + 2 * t4) =
            pack_bf16(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + int64_t(row) * a.vdv.st + 8 * j + 2 * t4) =
            pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The (B, N, T, H) view at `p` (element strides v) as a 4-D map (H, T, N, B)
// of 64-column x `rows`-row boxes, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* p, int B, int N, int T, int H, const View& v,
              int rows) {
  const uint64_t dims[4] = {uint64_t(H), uint64_t(T), uint64_t(N), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(v.st) * 2, uint64_t(v.sn) * 2, uint64_t(v.sb) * 2};
  const uint32_t box[4] = {64, uint32_t(rows), 1, 1};
  return encode_bf16_map(map, p, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// views: q, k, v, o, dout, dq, dk, dv.
template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* dvec, float* dq_acc, int* counters, bf16* dq,
                   bf16* dk, bf16* dv, const View* views, int B, int N, int T, int q_tile,
                   int smem, int group, float scale, cudaStream_t stream) {
  using C = BwdCfg<HD>;
  if (q_tile != C::kQT || smem != C::kSmem || group < 1 || (T / kKeys) % group)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo, mdq;
  const int rows = B * N * T;
  const uint64_t acc_dims[2] = {uint64_t(HD), uint64_t(rows)};
  const uint64_t acc_strides[1] = {uint64_t(HD) * 4};
  const uint32_t acc_box[2] = {32, 64};
  if (!make_map(&mq, q, B, N, T, HD, views[0], C::kQT) ||
      !make_map(&mk, k, B, N, T, HD, views[1], kKeys) ||
      !make_map(&mv, v, B, N, T, HD, views[2], kKeys) ||
      !make_map(&mdo, dout, B, N, T, HD, views[4], C::kQT) ||
      !encode_f32_map(&mdq, dq_acc, 2, acc_dims, acc_strides, acc_box,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;

  const int prep_blocks = (rows * (HD / 8) + kPrepThreads - 1) / kPrepThreads;
  flash_bwd_prep_kernel<HD><<<prep_blocks, kPrepThreads, 0, stream>>>(
      o, dout, views[3], views[4], dvec, dq_acc, counters, N, T, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  MainArgs m;
  m.lse = lse;
  m.dvec = dvec;
  m.dk = dk;
  m.dv = dv;
  m.vdk = views[6];
  m.vdv = views[7];
  m.counters = counters;
  m.N = N;
  m.T = T;
  m.group = group;
  m.scale = scale;
  m.scale_log2 = scale * kLog2e;
  flash_bwd_kernel<HD><<<dim3(T / kKeys, B * N), kThreads, smem, stream>>>(mq, mk, mv, mdo, mdq,
                                                                           m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_convert_kernel<HD><<<prep_blocks, kPrepThreads, 0, stream>>>(dq_acc, dq, views[5],
                                                                           N, T, rows, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, N, T, H) bf16 views with unit last stride;
// st: their b, n, t element strides in that order (24 values); lse: the
// forward's (B, N, T) fp32 row log-sum-exp; dvec: (B, N, T) fp32 scratch for
// D; dq_acc: contiguous (B, N, T, H) fp32 scratch for dQ's sums; counters:
// B * N * T / q_tile + 1 int32 (the turn counters, the ticket). q_tile, smem,
// group: the plan of ops/flash_attention.py:bwd_plan. Three launches (D and
// the zeroed scratch and counters; dK, dV and dQ's sums; dQ) on `stream`.
extern "C" int cak_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* dvec, void* dq_acc, void* counters, void* dq,
                                       void* dk, void* dv, int B, int N, int T, int H,
                                       int q_tile, int smem, int group, const int64_t* st,
                                       float scale, void* stream) {
  if (T % kKeys || T < kKeys || B * N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  View views[8];
  for (int i = 0; i < 8; ++i) views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  auto run = [&](auto hd) {
    return launch<decltype(hd)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(dvec), static_cast<float*>(dq_acc),
        static_cast<int*>(counters), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), views, B, N, T, q_tile, smem, group, scale,
        static_cast<cudaStream_t>(stream));
  };
  cudaError_t e = cudaErrorInvalidValue;
  if (H == 64) e = run(std::integral_constant<int, 64>{});
  if (H == 128) e = run(std::integral_constant<int, 128>{});
  return static_cast<int>(e);
}
