// K2 in fp32: non-causal flash attention forward, softmax(Q K^T / sqrt(H)) V,
// fp32 in, out and throughout, with each row's log-sum-exp for the backward.
//
// Replaces: ctrl_adapter_tpu/ops/flash_attention.py, attention_bnth -> the
// Pallas TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention,
// for float32 inputs (fp32 towers: train.py --mixed_precision other than bf16).
//
// What bounds it on the H100: flops. One (b, n) pair does 4 T^2 H flops
// against 16 T H bytes of Q, K, V and O, ~1000 flop per byte at T = 4096,
// H = 64. The products run on the tensor cores in 3xTF32 (csrc/tf32_tiles.cuh):
// three tf32 passes at 494.5 TFLOP/s, ~164.8 TFLOP/s of fp32-accurate
// products, against 67 TFLOP/s of fp32 FMAs on the CUDA cores. One tf32 pass
// would carry ~4e-4 relative error where the reference computes in fp32.
//
// Two launches, one call:
// 1. tf32_split_kernel: Q and K into hi / lo copies in their natural layout,
//    V into hi / lo copies of V^T (keys contiguous, in the fragment order of
//    tf32_tiles.cuh), in a workspace of 6 B N T H fp32 that the caller
//    allocates (tf32 wgmma reads K-major operands only; P V needs V^T);
// 2. flash_fp32_fwd_kernel, warp-specialised: warpgroup 0 is the producer (one
//    thread issues TMA loads: the CTA's Q tiles once, then per 64-key step
//    the K tiles and the V^T tiles into a ring of kStages slots, K and V^T
//    each with a full and an empty mbarrier, so the next K loads while this
//    step's P V runs); kC consumer warpgroups of 64 query rows each: per step
//    S = Q K^T (3 x H / 8 wgmma m64n64k8, both operands in shared memory),
//    online softmax in fp32 registers (exp2, running max and sum), P split
//    into tf32 A fragments in registers (frag_of), P V (3 x 8 wgmma m64n64k8
//    per 64 columns of O, A from registers) into a zeroed accumulator, then
//    O = alpha O + P V in fp32 (product_rs_add). The two consumers run on their own: one's
//    softmax overlaps the other's products. The T x T logits never reach
//    device memory. Rows are normalised at the end and stored through the
//    (B, N, T, H) strides; with an LSE buffer each row's log-sum-exp of the
//    scaled logits goes to it.
// H = 64: two consumers (128 query rows a CTA), two stages; H = 128: one
// consumer, one stage (227 KB of shared memory holds no more). Grid
// (ceil(T / (64 kC)), B N): where T % 128 == 64 the last CTA's second
// consumer computes on rows of the next pair and stores nothing.
// Shapes: T % 64 == 0, H in {64, 128}; 16-byte aligned bases and row strides
// (float4 loads in the prologue), which ops/flash_attention.py checks. The
// host plan (ops/flash_attention.py:fp32_plan) gives the shared memory and
// the workspace; cak_flash_attention_fp32 refuses other shared memory.
#include "tf32_tiles.cuh"

namespace {

using namespace tf32;

constexpr int kKeys = 64;     // keys per step
constexpr int kBufs = 6;      // workspace: Q hi, lo; K hi, lo; V^T hi, lo

template <int H>
struct FwdCfg {
  static constexpr int kC = H == 64 ? 2 : 1;        // consumer warpgroups
  static constexpr int kStages = H == 64 ? 2 : 1;
  static constexpr int kThreads = 128 * (1 + kC);
  static constexpr int kQ = kRows * H * 4;          // one consumer's Q tile, hi or lo
  static constexpr int kKv = kKeys * H * 4;         // a K or a V^T tile, hi or lo
  static constexpr int kStage0 = 2 * kC * kQ;       // Q hi, lo of consumer c at 2 c kQ
  static constexpr int kStage = 4 * kKv;            // K hi, K lo, V^T hi, V^T lo
  static constexpr int kBar = kStage0 + kStages * kStage;
  static constexpr int kSmem = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

template <int H>
__global__ void __launch_bounds__(FwdCfg<H>::kThreads, 1)
    flash_fp32_fwd_kernel(const __grid_constant__ CUtensorMap tm_nat,
                          const __grid_constant__ CUtensorMap tm_tr, float* __restrict__ o,
                          float* __restrict__ lse, int n_heads, int T, int BN, int64_t osb,
                          int64_t osn, int64_t ost, float scale_log2) {
  using C = FwdCfg<H>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t q_full = base + C::kBar;
  auto k_full = [&](int s) { return q_full + 8 + 32 * s; };
  auto k_empty = [&](int s) { return q_full + 16 + 32 * s; };
  auto v_full = [&](int s) { return q_full + 24 + 32 * s; };
  auto v_empty = [&](int s) { return q_full + 32 + 32 * s; };
  auto stage = [&](int s) { return base + C::kStage0 + s * C::kStage; };

  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int q0 = blockIdx.x * C::kC * kRows;
  const int n_steps = T / kKeys;
  const int rows = BN * T;  // rows of one natural buffer
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 128 * C::kC);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 128 * C::kC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (C::kC > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::kC * C::kQ);
      for (int c = 0; c < C::kC; ++c)
        for (int hl = 0; hl < 2; ++hl)
          load_nat<H>(base + (2 * c + hl) * C::kQ, &tm_nat, q_full, hl, rows,
                      bn * T + q0 + c * kRows, kRows);
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % S;
        const uint32_t parity = ((j / S) & 1) ^ 1;  // the slot's last use is done
        const uint32_t st = stage(s);
        if (j >= S) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), 2 * C::kKv);
        load_nat<H>(st, &tm_nat, k_full(s), 2, rows, bn * T + j * kKeys, kKeys);
        load_nat<H>(st + C::kKv, &tm_nat, k_full(s), 3, rows, bn * T + j * kKeys, kKeys);
        if (j >= S) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), 2 * C::kKv);
        load_tr<H, 128>(st + 2 * C::kKv, &tm_tr, v_full(s), 4, BN, bn, j * kKeys, kKeys);
        load_tr<H, 128>(st + 3 * C::kKv, &tm_tr, v_full(s), 5, BN, bn, j * kKeys, kKeys);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::kC > 1) setmaxnreg_inc<240>();
    const int wc = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g8 = lane >> 2, t4 = lane & 3;
    const uint32_t qh = base + 2 * wc * C::kQ, ql = qh + C::kQ;

    float o_acc[H / 2];
#pragma unroll
    for (int d = 0; d < H / 2; ++d) o_acc[d] = 0.f;
    float s_acc[kKeys / 2], o_tmp[32];
    uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_steps; ++j) {
      const int s = j % S;
      const uint32_t parity = (j / S) & 1;
      const uint32_t kh = stage(s), kl = kh + C::kKv, vh = kl + C::kKv, vl = vh + C::kKv;
      mbar_wait(k_full(s), parity);
      wgmma_fence();
      product_ss<kKeys, H>(s_acc, qh, ql, kh, kl, true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      mbar_arrive(k_empty(s));

      // online softmax of the scores: rows g8 (h = 0) and g8 + 8 (h = 1)
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
          mx = fmaxf(mx, fmaxf(s_acc[4 * i + 2 * h], s_acc[4 * i + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx * scale_log2);
        alpha[h] = exp2f(m_run[h] - m_new);  // 0 on the first step
        float row_sum = 0.f;
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s_acc[4 * i + 2 * h + e], scale_log2, -m_new));
            s_acc[4 * i + 2 * h + e] = p;
            row_sum += p;
          }
        }
        l_run[h] = l_run[h] * alpha[h] + row_sum;
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) frag_of(s_acc, i, ph[i], pl[i]);

      mbar_wait(v_full(s), parity);
      fence_regs(ph);
      fence_regs(pl);
      product_rs_add<H, kKeys / 8, 128>(o_acc, ph, pl, vh, vl, alpha, o_tmp);  // O = alpha O + P V
      mbar_arrive(v_empty(s));
    }

    if (q0 + wc * kRows < T) {
      float* ob = o + b * osb + n * osn;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_run[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;
        const int row = q0 + wc * kRows + warp * 16 + g8 + 8 * h;
        if (lse != nullptr && t4 == 0)
          lse[int64_t(bn) * T + row] = (m_run[h] + log2f(l)) * 0.6931471805599453f;
#pragma unroll
        for (int d = 0; d < H / 8; ++d)
          *reinterpret_cast<float2*>(ob + int64_t(row) * ost + 8 * d + 2 * t4) =
              make_float2(o_acc[4 * d + 2 * h] * inv, o_acc[4 * d + 2 * h + 1] * inv);
      }
    }
  }
}

template <int H>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                       float* ws, int b, int n, int t, int smem, const int64_t* st, float scale,
                       cudaStream_t stream) {
  using C = FwdCfg<H>;
  if (smem != C::kSmem) return cudaErrorInvalidValue;
  SplitJobs jobs{};
  jobs.job[0] = SplitJob{q, st[0], st[1], st[2], 0, -1, nullptr, 0, 0, 0, nullptr};
  jobs.job[1] = SplitJob{k, st[3], st[4], st[5], 2, -1, nullptr, 0, 0, 0, nullptr};
  jobs.job[2] = SplitJob{v, st[6], st[7], st[8], -1, 4, nullptr, 0, 0, 0, nullptr};
  cudaError_t e = launch_split<H>(jobs, 3, ws, b * n, n, t, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap m_nat, m_tr;
  if (!nat_map(&m_nat, ws, kBufs, b * n, t, H, kRows) ||
      !tr_map(&m_tr, ws, kBufs, b * n, t, H, 32))
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(flash_fp32_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  const int rows = C::kC * kRows;
  flash_fp32_fwd_kernel<H><<<dim3((t + rows - 1) / rows, b * n), C::kThreads, smem, stream>>>(
      m_nat, m_tr, o, lse, n, t, b * n, st[9], st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, N, T, H) fp32 views with unit last stride; strides: the
// (b, n, t) element strides of q, k, v, o in that order. lse: (B, N, T) fp32
// contiguous, or null. ws: the 6 B N T H fp32 workspace (16-byte aligned).
// smem: the plan's shared memory (FwdCfg<H>::kSmem).
extern "C" int cak_flash_attention_fp32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, void* ws, int b, int n, int t, int h,
                                        int smem, const int64_t* strides, float scale,
                                        void* stream) {
  if (!shape_ok(b * n, t, h, kBufs)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float *of = static_cast<float*>(o), *lf = static_cast<float*>(lse),
        *wf = static_cast<float*>(ws);
  if (h == 64)
    return static_cast<int>(launch_fwd<64>(qf, kf, vf, of, lf, wf, b, n, t, smem, strides,
                                           scale, st));
  if (h == 128)
    return static_cast<int>(launch_fwd<128>(qf, kf, vf, of, lf, wf, b, n, t, smem, strides,
                                            scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
