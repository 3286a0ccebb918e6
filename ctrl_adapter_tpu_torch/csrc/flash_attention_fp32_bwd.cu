// K2's backward in fp32: dQ, dK, dV of softmax(Q K^T / sqrt(H)) V from the
// forward's output O, its rows' log-sum-exp L and the output gradient dO.
//
// Replaces: ctrl_adapter_tpu/ops/flash_attention.py, the custom VJP of
// attention_bnth (the Pallas kernels _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), for float32 inputs (train.py --mixed_precision
// other than bf16). Like the TPU's, it has two main kernels: one owns a block
// of keys and sums dK and dV over all queries, the other owns a block of
// queries and sums dQ over all keys. So every gradient is a sum in a fixed
// order, and two calls give the same bits (the bf16 kernel,
// flash_attention_bwd.cu, adds dQ's partials by TMA reduce-add in the order
// its CTAs finish).
//
// What bounds it on the H100: flops. The five products of the backward (S,
// dP, dV, dQ, dK; 2 T^2 H flop each per (b, n) pair) are far above the ridge.
// They run on the tensor cores in 3xTF32 (csrc/tf32_tiles.cuh: three tf32
// wgmma a product, ~164.8 TFLOP/s of fp32-accurate products). This design
// recomputes S and dP in both main kernels, 7 products instead of 5, to keep
// the sums ordered without atomics.
//
// Three launches, one call:
// 1. tf32_split_kernel: hi / lo copies of Q, K, V and dO in their natural
//    layout and of Q^T, K^T and dO^T (tf32 wgmma reads K-major operands only:
//    dV += P^T dO needs dO^T, dK += dS^T Q needs Q^T, dQ += dS K needs K^T), in
//    a workspace of 14 B N T H fp32 that the caller allocates; and D =
//    rowsum(dO o O), (B, N, T), one warp a row in a fixed order;
// 2. fp32_bwd_dkv_kernel, grid (ceil(T / (64 kC)), B N): kC consumer
//    warpgroups of 64 keys each hold K and V (hi, lo) in shared memory; per
//    step of kStep queries: S^T = K Q^T and dP^T = V dO^T (wgmma, both
//    operands in shared memory), P^T = exp(scale S^T - L), dS^T = P^T o
//    (dP^T - D) in registers, split into tf32 A fragments, dV += P^T dO and
//    dK += dS^T Q (A from registers, B the transposed tiles; each step's
//    product summed apart and added in fp32, product_rs_add); dK scaled at
//    the end;
// 3. fp32_bwd_dq_kernel, the same grid over query blocks: the consumers hold
//    Q and dO; per step of kStep keys: S = Q K^T, dP = dO V^T, dS = P o (dP -
//    D), dQ += dS K; dQ scaled at the end.
// Each main kernel is warp-specialised: warpgroup 0's first thread issues the
// TMA loads (the fixed tiles once, then per step the natural and the
// transposed tiles, each group with a full and an empty mbarrier, so the next
// step's natural tiles load while this step's last two products run).
// H = 64: two consumers, 32-row steps (128-byte rows everywhere); H = 128: one
// consumer, 16-row steps (the transposed tiles in 64-byte swizzled rows).
// Shapes as the forward: T % 64 == 0, H in {64, 128}, 16-byte aligned bases
// and row strides. The host plan (ops/flash_attention.py:fp32_bwd_plan) gives
// both kernels' shared memory and the workspace; cak_flash_attention_fp32_bwd
// refuses other shared memory.
#include "tf32_tiles.cuh"

namespace {

using namespace tf32;

constexpr int kBufs = 14;
// workspace buffers (hi at the index, lo at the next): natural Q, K, V, dO;
// transposed Q^T, K^T, dO^T
constexpr int kQn = 0, kKn = 2, kVn = 4, kDOn = 6, kQt = 8, kKt = 10, kDOt = 12;
constexpr float kLog2e = 1.4426950408889634f;

template <int H, bool DKV>
struct Cfg {
  static constexpr int kC = H == 64 ? 2 : 1;         // consumer warpgroups, 64 rows each
  static constexpr int kThreads = 128 * (1 + kC);
  static constexpr int kStep = 2048 / H;             // streamed rows a step: 32 or 16
  static constexpr int kAtom = 4 * kStep;            // bytes of a transposed tile's row
  static constexpr int kStages = DKV ? 1 : 2;
  static constexpr int kFix = kRows * H * 4;         // one consumer's fixed tile, hi or lo
  static constexpr int kTile = kStep * H * 4;        // a streamed tile, hi or lo
  static constexpr int kTrTiles = DKV ? 4 : 2;       // Q^T, dO^T or K^T (hi, lo)
  static constexpr int kStage0 = 4 * kC * kFix;      // K, V or Q, dO (hi, lo) per consumer
  static constexpr int kStage = (4 + kTrTiles) * kTile;
  static constexpr int kBar = kStage0 + kStages * kStage;
  static constexpr int kSmem = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

struct OutView {  // (b, n, t) element strides of an output
  int64_t sb, sn, st;
};

// Barriers at bars: the fixed tiles' full; per stage s the natural tiles'
// full and empty, the transposed tiles' full and empty.
__device__ __forceinline__ uint32_t nat_full(uint32_t bars, int s) { return bars + 8 + 32 * s; }
__device__ __forceinline__ uint32_t nat_empty(uint32_t bars, int s) { return bars + 16 + 32 * s; }
__device__ __forceinline__ uint32_t tr_full(uint32_t bars, int s) { return bars + 24 + 32 * s; }
__device__ __forceinline__ uint32_t tr_empty(uint32_t bars, int s) { return bars + 32 + 32 * s; }

template <int H, bool DKV>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  using C = Cfg<H, DKV>;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(nat_full(bars, s), 1);
      mbar_init(nat_empty(bars, s), 128 * C::kC);
      mbar_init(tr_full(bars, s), 1);
      mbar_init(tr_empty(bars, s), 128 * C::kC);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread. Fixed tiles of consumer c at base + (4 c + i) kFix:
// dK/dV K hi, lo, V hi, lo; dQ Q hi, lo, dO hi, lo (rows r0 + 64 c). Stage s
// at kStage0 + s kStage: four natural tiles (dK/dV Q, dO; dQ K, V; hi, lo),
// then the transposed ones (dK/dV Q^T, dO^T; dQ K^T).
template <int H, bool DKV>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* tm_fix,
                                        const CUtensorMap* tm_nat, const CUtensorMap* tm_tr,
                                        int BN, int bn, int T, int r0) {
  using C = Cfg<H, DKV>;
  constexpr int S = C::kStages;
  const int fix[2] = {DKV ? kKn : kQn, DKV ? kVn : kDOn};
  const int nat[2] = {DKV ? kQn : kKn, DKV ? kDOn : kVn};
  const int tr[2] = {DKV ? kQt : kKt, kDOt};
  const int rows = BN * T;
  const uint32_t bars = base + C::kBar;
  mbar_expect_tx(bars, 4 * C::kC * C::kFix);
  for (int c = 0; c < C::kC; ++c)
    for (int i = 0; i < 4; ++i)
      load_nat<H>(base + (4 * c + i) * C::kFix, tm_fix, bars, fix[i / 2] + i % 2, rows,
                  bn * T + r0 + c * kRows, kRows);
  for (int j = 0; j < T / C::kStep; ++j) {
    const int s = j % S;
    const uint32_t parity = ((j / S) & 1) ^ 1;  // the slot's last use is done
    const uint32_t st = base + C::kStage0 + s * C::kStage;
    if (j >= S) mbar_wait(nat_empty(bars, s), parity);
    mbar_expect_tx(nat_full(bars, s), 4 * C::kTile);
    for (int i = 0; i < 4; ++i)
      load_nat<H>(st + i * C::kTile, tm_nat, nat_full(bars, s), nat[i / 2] + i % 2, rows,
                  bn * T + j * C::kStep, C::kStep);
    if (j >= S) mbar_wait(tr_empty(bars, s), parity);
    mbar_expect_tx(tr_full(bars, s), C::kTrTiles * C::kTile);
    for (int i = 0; i < C::kTrTiles; ++i)
      load_tr<H, C::kAtom>(st + (4 + i) * C::kTile, tm_tr, tr_full(bars, s), tr[i / 2] + i % 2,
                           BN, bn, j * C::kStep, C::kStep);
  }
}

// Rows 16 w + g8 (h = 0) and + 8 (h = 1) of a 64 x H accumulator, times
// `mul`, to the output rows r0 + those of the view at `out`.
template <int H>
__device__ __forceinline__ void store_rows(float* out, const OutView& ov, int b, int n, int r0,
                                           const float (&acc)[H / 2], float mul) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  float* ob = out + b * ov.sb + n * ov.sn;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g8 + 8 * h;
#pragma unroll
    for (int d = 0; d < H / 8; ++d)
      *reinterpret_cast<float2*>(ob + int64_t(row) * ov.st + 8 * d + 2 * t4) =
          make_float2(acc[4 * d + 2 * h] * mul, acc[4 * d + 2 * h + 1] * mul);
  }
}

template <int H>
__global__ void __launch_bounds__(Cfg<H, true>::kThreads, 1)
    fp32_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_fix,
                        const __grid_constant__ CUtensorMap tm_nat,
                        const __grid_constant__ CUtensorMap tm_tr, const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dk,
                        float* __restrict__ dv, int n_heads, int T, int BN, OutView dkv,
                        OutView dvv, float scale, float scale_log2) {
  using C = Cfg<H, true>;
  constexpr int S = C::kStages, NS = C::kStep / 2, KS = C::kStep / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kBar;
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int k0 = blockIdx.x * C::kC * kRows;
  const int wg = warpgroup_index();
  init_bars<H, true>(bars);

  if (wg == 0) {
    if constexpr (C::kC > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce<H, true>(base, &tm_fix, &tm_nat, &tm_tr, BN, bn, T, k0);
    return;
  }
  if constexpr (C::kC > 1) setmaxnreg_inc<240>();
  const int wc = wg - 1;
  const int t4 = threadIdx.x % 4;
  const uint32_t kh = base + 4 * wc * C::kFix, kl = kh + C::kFix, vh = kl + C::kFix,
                 vl = vh + C::kFix;
  const float* lrow = lse + int64_t(bn) * T;
  const float* drow = dvec + int64_t(bn) * T;
  float dk_acc[H / 2], dv_acc[H / 2];
#pragma unroll
  for (int d = 0; d < H / 2; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  float st_acc[NS], dp_acc[NS], tmp[32];  // S^T, dP^T: [key][query] of the step
  const float one[2] = {1.f, 1.f};        // product_rs_add's row scale of a plain sum
  uint32_t ph[KS][4], pl[KS][4], dh[KS][4], dl[KS][4];
  mbar_wait(bars, 0);

  for (int j = 0; j < T / C::kStep; ++j) {
    const int s = j % S;
    const uint32_t parity = (j / S) & 1;
    const uint32_t st = base + C::kStage0 + s * C::kStage;
    // this thread's query columns of the step: 8 i + 2 t4 + e
    const int q0 = j * C::kStep;
    float2 lq[KS], dq[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      lq[i] = *reinterpret_cast<const float2*>(lrow + q0 + 8 * i + 2 * t4);
      dq[i] = *reinterpret_cast<const float2*>(drow + q0 + 8 * i + 2 * t4);
    }
    mbar_wait(nat_full(bars, s), parity);
    wgmma_fence();
    product_ss<C::kStep, H>(st_acc, kh, kl, st, st + C::kTile, true);
    product_ss<C::kStep, H>(dp_acc, vh, vl, st + 2 * C::kTile, st + 3 * C::kTile, true);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st_acc);
    fence_regs(dp_acc);
    mbar_arrive(nat_empty(bars, s));

#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l2 = (e ? lq[i].y : lq[i].x) * kLog2e, d = e ? dq[i].y : dq[i].x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          const float p = exp2f(fmaf(st_acc[x], scale_log2, -l2));
          st_acc[x] = p;
          dp_acc[x] = p * (dp_acc[x] - d);  // dS^T
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      frag_of(st_acc, i, ph[i], pl[i]);
      frag_of(dp_acc, i, dh[i], dl[i]);
    }

    mbar_wait(tr_full(bars, s), parity);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    const uint32_t qth = st + 4 * C::kTile, qtl = qth + C::kTile, doth = qtl + C::kTile,
                   dotl = doth + C::kTile;
    product_rs_add<H, KS, C::kAtom>(dv_acc, ph, pl, doth, dotl, one, tmp);
    product_rs_add<H, KS, C::kAtom>(dk_acc, dh, dl, qth, qtl, one, tmp);
    mbar_arrive(tr_empty(bars, s));
  }
  const int r0 = k0 + wc * kRows;
  if (r0 < T) {
    store_rows<H>(dk, dkv, b, n, r0, dk_acc, scale);
    store_rows<H>(dv, dvv, b, n, r0, dv_acc, 1.f);
  }
}

template <int H>
__global__ void __launch_bounds__(Cfg<H, false>::kThreads, 1)
    fp32_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_fix,
                       const __grid_constant__ CUtensorMap tm_nat,
                       const __grid_constant__ CUtensorMap tm_tr, const float* __restrict__ lse,
                       const float* __restrict__ dvec, float* __restrict__ dq, int n_heads, int T,
                       int BN, OutView dqv, float scale, float scale_log2) {
  using C = Cfg<H, false>;
  constexpr int S = C::kStages, NS = C::kStep / 2, KS = C::kStep / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kBar;
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int q0 = blockIdx.x * C::kC * kRows;
  const int wg = warpgroup_index();
  init_bars<H, false>(bars);

  if (wg == 0) {
    if constexpr (C::kC > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce<H, false>(base, &tm_fix, &tm_nat, &tm_tr, BN, bn, T, q0);
    return;
  }
  if constexpr (C::kC > 1) setmaxnreg_inc<240>();
  const int wc = wg - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, g8 = lane >> 2;
  const uint32_t qh = base + 4 * wc * C::kFix, ql = qh + C::kFix, oh = ql + C::kFix,
                 ol = oh + C::kFix;
  // L (log2 units) and D of rows g8 and g8 + 8 (rows past T, in a last CTA's
  // idle consumer, read row T - 1 and store nothing)
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(q0 + wc * kRows + warp * 16 + g8 + 8 * h, T - 1);
    l2[h] = lse[int64_t(bn) * T + row] * kLog2e;
    dd[h] = dvec[int64_t(bn) * T + row];
  }
  float dq_acc[H / 2];
#pragma unroll
  for (int d = 0; d < H / 2; ++d) dq_acc[d] = 0.f;
  float s_acc[NS], dp_acc[NS], tmp[32];  // S, dP: [query][key] of the step
  const float one[2] = {1.f, 1.f};
  uint32_t dh[KS][4], dl[KS][4];
  mbar_wait(bars, 0);

  for (int j = 0; j < T / C::kStep; ++j) {
    const int s = j % S;
    const uint32_t parity = (j / S) & 1;
    const uint32_t st = base + C::kStage0 + s * C::kStage;
    mbar_wait(nat_full(bars, s), parity);
    wgmma_fence();
    product_ss<C::kStep, H>(s_acc, qh, ql, st, st + C::kTile, true);
    product_ss<C::kStep, H>(dp_acc, oh, ol, st + 2 * C::kTile, st + 3 * C::kTile, true);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    mbar_arrive(nat_empty(bars, s));

#pragma unroll
    for (int i = 0; i < KS; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h + e;
          const float p = exp2f(fmaf(s_acc[x], scale_log2, -l2[h]));
          dp_acc[x] = p * (dp_acc[x] - dd[h]);  // dS
        }
#pragma unroll
    for (int i = 0; i < KS; ++i) frag_of(dp_acc, i, dh[i], dl[i]);

    mbar_wait(tr_full(bars, s), parity);
    fence_regs(dh);
    fence_regs(dl);
    const uint32_t kth = st + 4 * C::kTile, ktl = kth + C::kTile;
    product_rs_add<H, KS, C::kAtom>(dq_acc, dh, dl, kth, ktl, one, tmp);
    mbar_arrive(tr_empty(bars, s));
  }
  const int r0 = q0 + wc * kRows;
  if (r0 < T) store_rows<H>(dq, dqv, b, n, r0, dq_acc, scale);
}

template <int H>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* dvec, float* ws, float* dq,
                       float* dk, float* dv, int b, int n, int t, int smem_dkv, int smem_dq,
                       const int64_t* s, float scale, cudaStream_t stream) {
  using Dkv = Cfg<H, true>;
  using Dq = Cfg<H, false>;
  if (smem_dkv != Dkv::kSmem || smem_dq != Dq::kSmem) return cudaErrorInvalidValue;
  const int bn = b * n;
  SplitJobs jobs{};
  jobs.job[0] = SplitJob{q, s[0], s[1], s[2], kQn, kQt, nullptr, 0, 0, 0, nullptr};
  jobs.job[1] = SplitJob{k, s[3], s[4], s[5], kKn, kKt, nullptr, 0, 0, 0, nullptr};
  jobs.job[2] = SplitJob{v, s[6], s[7], s[8], kVn, -1, nullptr, 0, 0, 0, nullptr};
  jobs.job[3] = SplitJob{dout, s[12], s[13], s[14], kDOn, kDOt, o, s[9], s[10], s[11], dvec};
  cudaError_t e = launch_split<H>(jobs, 4, ws, bn, n, t, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap m_fix, m_nat, m_tr;
  if (!nat_map(&m_fix, ws, kBufs, bn, t, H, kRows) ||
      !nat_map(&m_nat, ws, kBufs, bn, t, H, Dkv::kStep) ||
      !tr_map(&m_tr, ws, kBufs, bn, t, H, Dkv::kStep))
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fp32_bwd_dkv_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dkv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fp32_bwd_dq_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dq);
  if (e != cudaSuccess) return e;
  const int rows = Dkv::kC * kRows;
  const dim3 grid((t + rows - 1) / rows, bn);
  const float scale_log2 = scale * kLog2e;
  fp32_bwd_dkv_kernel<H><<<grid, Dkv::kThreads, smem_dkv, stream>>>(
      m_fix, m_nat, m_tr, lse, dvec, dk, dv, n, t, bn, OutView{s[18], s[19], s[20]},
      OutView{s[21], s[22], s[23]}, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fp32_bwd_dq_kernel<H><<<grid, Dq::kThreads, smem_dq, stream>>>(
      m_fix, m_nat, m_tr, lse, dvec, dq, n, t, bn, OutView{s[15], s[16], s[17]}, scale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout: (B, N, T, H) fp32 views with unit last stride; dq, dk, dv
// the same (outputs); lse: the forward's (B, N, T) fp32 log-sum-exp,
// contiguous; dvec: (B, N, T) fp32 scratch for D; ws: the 14 B N T H fp32
// workspace (16-byte aligned). strides: the (b, n, t) element strides of q, k,
// v, o, dout, dq, dk, dv in that order. smem_dkv, smem_dq: the plan's shared
// memory of the two main kernels.
extern "C" int cak_flash_attention_fp32_bwd(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dvec, void* ws, void* dq, void* dk, void* dv,
                                            int b, int n, int t, int h, int smem_dkv,
                                            int smem_dq, const int64_t* strides, float scale,
                                            void* stream) {
  if (!shape_ok(b * n, t, h, kBufs)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (h == 64)
    return static_cast<int>(launch_bwd<64>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(dvec),
                                           w(ws), w(dq), w(dk), w(dv), b, n, t, smem_dkv,
                                           smem_dq, strides, scale, st));
  if (h == 128)
    return static_cast<int>(launch_bwd<128>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(dvec),
                                            w(ws), w(dq), w(dk), w(dv), b, n, t, smem_dkv,
                                            smem_dq, strides, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
