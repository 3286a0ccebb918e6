// K2's backward in fp32: dQ, dK, dV of softmax(Q K^T / sqrt(H)) V from the
// forward's output O, its rows' log-sum-exp L and the output gradient dO.
//
// Replaces: ctrl_adapter_tpu/ops/flash_attention.py, the custom VJP of
// attention_bnth (the Pallas kernels _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), for float32 inputs (train.py --mixed_precision
// other than bf16). Like the TPU's, it is two kernels: one owns a block of
// keys and sums dK and dV over all queries, the other owns a block of queries
// and sums dQ over all keys. So every gradient is a sum in a fixed order, and
// two calls give the same bits (the bf16 kernel, flash_attention_bwd.cu, adds
// dQ's partials by TMA reduce-add in the order its CTAs finish).
//
// What bounds it on the H100: flops, on the CUDA cores: the five products of
// the backward (S, dP, dV, dQ, dK; 2 T^2 H flop each per (b, n) pair) are far
// above the fp32 ridge (20 flop/byte). This design recomputes S and dP in both
// kernels, 7 products instead of 5, to keep the sums ordered without atomics.
// All in fp32 FMAs (csrc/fp32_tiles.cuh), as the forward.
//
// Launches, each CTA 256 threads on 64 rows:
// 1. D = rowsum(dO o O), (B, N, T): one warp per row, a fixed shuffle tree;
// 2. dK, dV: grid (T / 64 key blocks, B * N). K^T and V^T stay in shared
//    memory; per 64-query step: S^T = K Q^T, P^T = exp(scale S^T - L), dV +=
//    P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T - D), dK += dS^T Q; dK scaled
//    at the end;
// 3. dQ: grid (T / 64 query blocks, B * N). Q^T and dO^T stay; per 64-key
//    step: S = Q K^T, P = exp(scale S - L), dP = dO V^T, dS = P o (dP - D),
//    dQ += dS K; dQ scaled at the end.
// P and dS go through shared memory transposed (the A operand of the next
// product). Shapes as the forward: T % 64 == 0, H in {64, 128}, 16-byte
// aligned bases and row strides. The host plan (ops/flash_attention.py:
// fp32_bwd_plan) gives both kernels' shared memory;
// cak_flash_attention_fp32_bwd refuses any other.
#include "common.cuh"
#include "fp32_tiles.cuh"

namespace {

using namespace f32t;

template <int H>
struct DkvCfg {
  static constexpr int kKt = 0;                    // K^T of the CTA's keys
  static constexpr int kVt = kKt + t_bytes(H);     // V^T
  static constexpr int kQt = kVt + t_bytes(H);     // Q^T of the step
  static constexpr int kQ = kQt + t_bytes(H);      // Q of the step
  static constexpr int kDot = kQ + n_bytes(H);     // dO^T
  static constexpr int kDo = kDot + t_bytes(H);    // dO
  static constexpr int kP = kDo + n_bytes(H);      // P, then dS, as [query][key]
  static constexpr int kL = kP + t_bytes(kRows);   // L and D of the step's queries
  static constexpr int kSmem = kL + 2 * kRows * 4;
};

template <int H>
struct DqCfg {
  static constexpr int kQt = 0;                    // Q^T of the CTA's queries
  static constexpr int kDot = kQt + t_bytes(H);    // dO^T
  static constexpr int kKt = kDot + t_bytes(H);    // K^T of the step
  static constexpr int kK = kKt + t_bytes(H);      // K
  static constexpr int kVt = kK + n_bytes(H);      // V^T
  static constexpr int kDs = kVt + t_bytes(H);     // dS as [key][query]
  static constexpr int kSmem = kDs + t_bytes(kRows);
};

struct Views {  // (b, n, t) element strides of q, k, v, o, do, dq, dk, dv
  int64_t s[24];
  __host__ __device__ const int64_t* of(int i) const { return s + 3 * i; }
};

__device__ __forceinline__ int64_t at(const int64_t* st, int b, int n, int t) {
  return b * st[0] + n * st[1] + t * st[2];
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    fp32_bwd_d_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                      float* __restrict__ dvec, int n_heads, int T, Views vw) {
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = blockIdx.x * kRows + warp; r < (blockIdx.x + 1) * kRows; r += kThreads / 32) {
    const float* orow = o + at(vw.of(3), b, n, r);
    const float* drow = dout + at(vw.of(4), b, n, r);
    float acc = 0.f;
#pragma unroll
    for (int h = lane; h < H; h += 32) acc = fmaf(orow[h], drow[h], acc);
    acc = warp_sum(acc);
    if (lane == 0) dvec[int64_t(bn) * T + r] = acc;
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    fp32_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        float* __restrict__ dk, float* __restrict__ dv, int n_heads, int T,
                        Views vw, float scale) {
  using C = DkvCfg<H>;
  constexpr int NC = H / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* kt = reinterpret_cast<float*>(smem + C::kKt);
  float* vt = reinterpret_cast<float*>(smem + C::kVt);
  float* qt = reinterpret_cast<float*>(smem + C::kQt);
  float* qn = reinterpret_cast<float*>(smem + C::kQ);
  float* dot = reinterpret_cast<float*>(smem + C::kDot);
  float* don = reinterpret_cast<float*>(smem + C::kDo);
  float* ps = reinterpret_cast<float*>(smem + C::kP);
  float* ls = reinterpret_cast<float*>(smem + C::kL);
  float* ds = ls + kRows;
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int key0 = blockIdx.x * kRows;
  load_t<H>(kt, k + at(vw.of(1), b, n, key0), vw.of(1)[2]);
  load_t<H>(vt, v + at(vw.of(2), b, n, key0), vw.of(2)[2]);
  const float* lrow = lse + int64_t(bn) * T;
  const float* drow = dvec + int64_t(bn) * T;

  float dk_acc[4][4 * NC] = {}, dv_acc[4][4 * NC] = {};
  const int c0 = 4 * tx();
  for (int q0 = 0; q0 < T; q0 += kRows) {
    __syncthreads();  // the last step's tiles and dS are read
    load_t<H>(qt, q + at(vw.of(0), b, n, q0), vw.of(0)[2]);
    load_n<H>(qn, q + at(vw.of(0), b, n, q0), vw.of(0)[2]);
    load_t<H>(dot, dout + at(vw.of(4), b, n, q0), vw.of(4)[2]);
    load_n<H>(don, dout + at(vw.of(4), b, n, q0), vw.of(4)[2]);
    if (threadIdx.x < kRows) {
      ls[threadIdx.x] = lrow[q0 + threadIdx.x];
      ds[threadIdx.x] = drow[q0 + threadIdx.x];
    }
    __syncthreads();
    float p[4][4] = {}, dp[4][4] = {};  // [key][query] of this thread
    mma<H, 1>(p, kt, kPad, qt, kPad);
    mma<H, 1>(dp, vt, kPad, dot, kPad);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = expf(p[i][j] * scale - ls[c0 + j]);
    store_t(ps, p);
    __syncthreads();
    mma<kRows, NC>(dv_acc, ps, kPad, don, H);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] *= dp[i][j] - ds[c0 + j];  // dS^T
    __syncthreads();  // P is read
    store_t(ps, p);
    __syncthreads();
    mma<kRows, NC>(dk_acc, ps, kPad, qn, H);
  }
  const int r0 = key0 + 4 * ty();
  float* dkb = dk + at(vw.of(6), b, n, 0);
  float* dvb = dv + at(vw.of(7), b, n, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* a = &dk_acc[i][4 * c];
      const float* e = &dv_acc[i][4 * c];
      *reinterpret_cast<float4*>(dkb + (r0 + i) * vw.of(6)[2] + 64 * c + c0) =
          make_float4(a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
      *reinterpret_cast<float4*>(dvb + (r0 + i) * vw.of(7)[2] + 64 * c + c0) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    fp32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dvec,
                       float* __restrict__ dq, int n_heads, int T, Views vw, float scale) {
  using C = DqCfg<H>;
  constexpr int NC = H / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem + C::kQt);
  float* dot = reinterpret_cast<float*>(smem + C::kDot);
  float* kt = reinterpret_cast<float*>(smem + C::kKt);
  float* kn = reinterpret_cast<float*>(smem + C::kK);
  float* vt = reinterpret_cast<float*>(smem + C::kVt);
  float* dss = reinterpret_cast<float*>(smem + C::kDs);
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int q0 = blockIdx.x * kRows;
  load_t<H>(qt, q + at(vw.of(0), b, n, q0), vw.of(0)[2]);
  load_t<H>(dot, dout + at(vw.of(4), b, n, q0), vw.of(4)[2]);
  const int r0 = q0 + 4 * ty();
  float l[4], d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = lse[int64_t(bn) * T + r0 + i];
    d[i] = dvec[int64_t(bn) * T + r0 + i];
  }

  float dq_acc[4][4 * NC] = {};
  for (int key0 = 0; key0 < T; key0 += kRows) {
    __syncthreads();  // the last step's tiles and dS are read
    load_t<H>(kt, k + at(vw.of(1), b, n, key0), vw.of(1)[2]);
    load_n<H>(kn, k + at(vw.of(1), b, n, key0), vw.of(1)[2]);
    load_t<H>(vt, v + at(vw.of(2), b, n, key0), vw.of(2)[2]);
    __syncthreads();
    float p[4][4] = {}, dp[4][4] = {};  // [query][key] of this thread
    mma<H, 1>(p, qt, kPad, kt, kPad);
    mma<H, 1>(dp, dot, kPad, vt, kPad);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = expf(p[i][j] * scale - l[i]) * (dp[i][j] - d[i]);
    store_t(dss, p);
    __syncthreads();
    mma<kRows, NC>(dq_acc, dss, kPad, kn, H);
  }
  float* dqb = dq + at(vw.of(5), b, n, 0);
  const int c0 = 4 * tx();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* a = &dq_acc[i][4 * c];
      *reinterpret_cast<float4*>(dqb + (r0 + i) * vw.of(5)[2] + 64 * c + c0) =
          make_float4(a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
    }
}

template <int H>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* dvec, float* dq, float* dk,
                       float* dv, int b, int n, int t, int smem_dkv, int smem_dq,
                       const Views& vw, float scale, cudaStream_t st) {
  if (smem_dkv != DkvCfg<H>::kSmem || smem_dq != DqCfg<H>::kSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fp32_bwd_dkv_kernel<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fp32_bwd_dq_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dq);
  if (e != cudaSuccess) return e;
  const dim3 grid(t / kRows, b * n);
  fp32_bwd_d_kernel<H><<<grid, kThreads, 0, st>>>(o, dout, dvec, n, t, vw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fp32_bwd_dkv_kernel<H><<<grid, kThreads, smem_dkv, st>>>(q, k, v, dout, lse, dvec, dk, dv, n,
                                                           t, vw, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fp32_bwd_dq_kernel<H><<<grid, kThreads, smem_dq, st>>>(q, k, v, dout, lse, dvec, dq, n, t, vw,
                                                         scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout: (B, N, T, H) fp32 views with unit last stride; dq, dk, dv
// the same (outputs); lse: the forward's (B, N, T) fp32 log-sum-exp,
// contiguous; dvec: (B, N, T) fp32 scratch for D. strides: the (b, n, t)
// element strides of q, k, v, o, dout, dq, dk, dv in that order. smem_dkv,
// smem_dq: the plan's shared memory of the two main kernels.
extern "C" int cak_flash_attention_fp32_bwd(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dvec, void* dq, void* dk, void* dv, int b,
                                            int n, int t, int h, int smem_dkv, int smem_dq,
                                            const int64_t* strides, float scale,
                                            void* stream) {
  if (t % kRows || t < kRows || b * n < 1 || b * n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Views vw;
  for (int i = 0; i < 24; ++i) vw.s[i] = strides[i];
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (h == 64)
    return static_cast<int>(launch_bwd<64>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(dvec),
                                           w(dq), w(dk), w(dv), b, n, t, smem_dkv, smem_dq, vw,
                                           scale, st));
  if (h == 128)
    return static_cast<int>(launch_bwd<128>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(dvec),
                                            w(dq), w(dk), w(dv), b, n, t, smem_dkv, smem_dq, vw,
                                            scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
