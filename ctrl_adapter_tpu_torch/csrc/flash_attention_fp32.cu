// K2 in fp32: non-causal flash attention forward, softmax(Q K^T / sqrt(H)) V,
// fp32 in, out and throughout, with each row's log-sum-exp for the backward.
//
// Replaces: ctrl_adapter_tpu/ops/flash_attention.py, attention_bnth -> the
// Pallas TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention,
// for float32 inputs (fp32 towers: train.py --mixed_precision other than bf16).
// The JAX rule sends fp32 self-attention to the same kernel as bf16; the bf16
// kernel (flash_attention.cu) runs on wgmma, which takes TF32 at most, so fp32
// has a kernel of its own.
//
// What bounds it on the H100: flops, on the CUDA cores. One (b, n) pair does
// 4 T^2 H flops against 16 T H bytes of Q, K, V and O; at T = 4096, H = 64 that
// is ~1000 flop per byte, far above the fp32 ridge (67 TFLOP/s over 3.35 TB/s,
// 20 flop/byte). Every product is a plain fp32 FMA: a single TF32 pass would
// carry ~1e-3 relative error where the reference computes in fp32.
//
// Design (simple first): one CTA of 256 threads per 64 query rows of one
// (b, n) pair (grid (T / 64, B * N)). Q^T stays in shared memory; each 64-key
// step loads K^T and V, computes S = Q K^T as 4 x 4 register tiles a thread
// (csrc/fp32_tiles.cuh), takes the online softmax in registers (the running
// max and sum of each row shared by its 16 threads through shuffles, expf),
// stores P^T to shared memory and adds P V into 4 x (H / 16) accumulators a
// thread. The T x T logits never reach device memory. Rows are normalised at
// the end and stored through the (B, N, T, H) strides; with an LSE buffer each
// row's m + log(l) of the scaled logits goes to it.
// Shapes: T % 64 == 0, H in {64, 128}; 16-byte aligned bases and row strides
// (float4 loads), which ops/flash_attention.py checks. The host plan
// (ops/flash_attention.py:fp32_plan) gives the shared memory;
// cak_flash_attention_fp32 refuses any other.
#include "common.cuh"
#include "fp32_tiles.cuh"

namespace {

using namespace f32t;

template <int H>
struct Fp32Cfg {
  static constexpr int kQt = 0;                      // Q^T: H x kPad
  static constexpr int kKt = kQt + t_bytes(H);       // K^T of the step
  static constexpr int kV = kKt + t_bytes(H);        // V of the step: 64 x H
  static constexpr int kPt = kV + n_bytes(H);        // P^T: 64 x kPad
  static constexpr int kSmem = kPt + t_bytes(kRows);
};

template <int H>
__global__ void __launch_bounds__(kThreads)
    flash_fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int n_heads, int T, int64_t sqb, int64_t sqn,
                          int64_t sqt, int64_t skb, int64_t skn, int64_t skt, int64_t svb,
                          int64_t svn, int64_t svt, int64_t sob, int64_t son, int64_t sot,
                          float scale) {
  using C = Fp32Cfg<H>;
  constexpr int NC = H / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem + C::kQt);
  float* kt = reinterpret_cast<float*>(smem + C::kKt);
  float* vs = reinterpret_cast<float*>(smem + C::kV);
  float* pt = reinterpret_cast<float*>(smem + C::kPt);
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int row0 = blockIdx.x * kRows;
  const float* kb = k + b * skb + n * skn;
  const float* vb = v + b * svb + n * svn;
  load_t<H>(qt, q + b * sqb + n * sqn + row0 * sqt, sqt);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;
  }
  for (int key0 = 0; key0 < T; key0 += kRows) {
    __syncthreads();  // the last step's K^T, V and P^T are read
    load_t<H>(kt, kb + key0 * skt, skt);
    load_n<H>(vs, vb + key0 * svt, svt);
    __syncthreads();
    float s[4][4] = {};
    mma<H, 1>(s, qt, kPad, kt, kPad);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0] * scale;
#pragma unroll
      for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j] * scale);
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first step (m = -inf)
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] * scale - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + quad_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha;
    }
    store_t(pt, s);
    __syncthreads();
    mma<kRows, NC>(acc, pt, kPad, vs, H);
  }
  const int r0 = row0 + 4 * ty(), c0 = 4 * tx();
  float* ob = o + b * sob + n * son;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(ob + (r0 + i) * sot + 64 * c + c0) =
          make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                      acc[i][4 * c + 3] * inv);
    if (lse != nullptr && tx() == 0) lse[int64_t(bn) * T + r0 + i] = m[i] + logf(l[i]);
  }
}

template <int H>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                       int b, int n, int t, int smem, const int64_t* st, float scale,
                       cudaStream_t stream) {
  if (smem != Fp32Cfg<H>::kSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fp32_fwd_kernel<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fp32_fwd_kernel<H><<<dim3(t / kRows, b * n), kThreads, smem, stream>>>(
      q, k, v, o, lse, n, t, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, N, T, H) fp32 views with unit last stride; strides: the
// (b, n, t) element strides of q, k, v, o in that order. lse: (B, N, T) fp32
// contiguous, or null. smem: the plan's shared memory (Fp32Cfg<H>::kSmem).
extern "C" int cak_flash_attention_fp32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int b, int n, int t, int h, int smem,
                                        const int64_t* strides, float scale, void* stream) {
  if (t % kRows || t < kRows || b * n < 1 || b * n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float *of = static_cast<float*>(o), *lf = static_cast<float*>(lse);
  if (h == 64) return static_cast<int>(launch_fwd<64>(qf, kf, vf, of, lf, b, n, t, smem,
                                                      strides, scale, st));
  if (h == 128) return static_cast<int>(launch_fwd<128>(qf, kf, vf, of, lf, b, n, t, smem,
                                                        strides, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
