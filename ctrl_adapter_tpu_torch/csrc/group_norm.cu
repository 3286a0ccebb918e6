// K1: GroupNorm (+ optional SiLU) over NC(F)HW tensors.
//
// Replaces: ctrl_adapter_tpu/ops/group_norm.py, group_norm_silu ->
//   _pallas_group_norm_silu (Pallas body _kernel).
//
// What bounds it on the H100: bytes. Per element it reads 2 bytes and writes
// 2 bytes (bf16) for about ten flops, far below the ~295 flop/byte ridge, so
// the floor is 2 reads + 1 write of the tensor at 3.35 TB/s (the statistics
// pass reads it once, the normalise pass reads it again; the second read
// mostly hits the 50 MB L2 at the adapter's sizes).
//
// Design: in NC(F)HW each (n, g) group is one contiguous span of (C/G)*S
// elements. Pass 1 splits every span into `splits` chunks so that enough
// blocks fill the 132 SMs even at N = 2 (the adapter's temporal norms), and
// writes per-chunk fp32 (sum, sum of squares). Pass 2 re-reads its group's
// partials in a fixed order (deterministic, no atomics), forms
// mean and var = E[x^2] - E[x]^2 clamped at 0 (the math of
// _xla_group_norm_silu), then normalises its chunk, applies the per-channel
// affine and the optional SiLU and writes out. All sums are plain fp32 adds:
// no tensor-core dot, whose reduced-precision inputs gave NaNs on the TPU
// (ops/group_norm.py:131-139). Loads are 16 bytes per thread where the span
// and the spatial size allow it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kVec = 8;  // bf16 elements per 16-byte load

__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float red[2][kThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (l == 0) {
    red[0][w] = a;
    red[1][w] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) {
      r.x += red[0][i];
      r.y += red[1][i];
    }
  }
  return r;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ partial, int64_t span,
                    int64_t chunk, int splits) {
  const int64_t grp = blockIdx.y;
  const int sp = blockIdx.x;
  const bf16* base = x + grp * span;
  const int64_t lo = sp * chunk;
  const int64_t hi = min(span, lo + chunk);
  float s = 0.f, ss = 0.f;
  if (VEC) {
    for (int64_t i = lo + int64_t(threadIdx.x) * kVec; i < hi; i += int64_t(kThreads) * kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(base + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = bf2f(e[j]);
        s += v;
        ss += v * v;
      }
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      float v = bf2f(base[i]);
      s += v;
      ss += v * v;
    }
  }
  float2 r = block_sum2(s, ss);
  if (threadIdx.x == 0) partial[grp * splits + sp] = r;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta, bf16* __restrict__ y,
                    const float2* __restrict__ partial, int64_t span, int64_t chunk,
                    int splits, int64_t cg, int64_t S, int G, float eps, int silu) {
  __shared__ float stat[2];
  const int64_t grp = blockIdx.y;
  const int sp = blockIdx.x;
  if (threadIdx.x == 0) {
    float s = 0.f, ss = 0.f;
    for (int i = 0; i < splits; ++i) {
      float2 p = partial[grp * splits + i];
      s += p.x;
      ss += p.y;
    }
    const float cnt = static_cast<float>(span);
    const float mean = s / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.f);
    stat[0] = mean;
    stat[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int64_t c0 = (grp % G) * cg;  // first channel of this group
  const bf16* xb = x + grp * span;
  bf16* yb = y + grp * span;
  const int64_t lo = sp * chunk;
  const int64_t hi = min(span, lo + chunk);
  if (VEC) {
    for (int64_t i = lo + int64_t(threadIdx.x) * kVec; i < hi; i += int64_t(kThreads) * kVec) {
      const int64_t ch = c0 + i / S;  // S % kVec == 0: one channel per vector
      const float ga = bf2f(gamma[ch]) * rstd;
      const float be = bf2f(beta[ch]);
      uint4 raw = *reinterpret_cast<const uint4*>(xb + i);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      uint4 outv;
      bf16* o = reinterpret_cast<bf16*>(&outv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = (bf2f(e[j]) - mean) * ga + be;
        if (silu) v = v / (1.f + expf(-v));
        o[j] = f2bf(v);
      }
      *reinterpret_cast<uint4*>(yb + i) = outv;
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int64_t ch = c0 + i / S;
      float v = (bf2f(xb[i]) - mean) * rstd * bf2f(gamma[ch]) + bf2f(beta[ch]);
      if (silu) v = v / (1.f + expf(-v));
      yb[i] = f2bf(v);
    }
  }
}

template <bool VEC>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* partial, int64_t groups, int64_t cg, int64_t S, int G, int splits,
                   int64_t chunk, float eps, int silu, cudaStream_t st) {
  const int64_t span = cg * S;
  dim3 grid(splits, static_cast<unsigned>(groups));
  gn_stats_kernel<VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(partial), span, chunk, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_apply_kernel<VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(y), static_cast<const float2*>(partial), span, chunk, splits, cg, S,
      G, eps, silu);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, C, *spatial) contiguous bf16; gamma, beta: (C,) bf16;
// partial: fp32 scratch of 2 * groups * splits floats. groups = N * G,
// cg = C / G, S = prod(spatial). chunk: elements per split (a multiple of 8
// when vec != 0).
extern "C" int cak_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* y, void* partial, int64_t groups, int64_t cg,
                                   int64_t S, int G, int splits, int64_t chunk, float eps,
                                   int silu, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      vec ? launch<true>(x, gamma, beta, y, partial, groups, cg, S, G, splits, chunk, eps,
                         silu, st)
          : launch<false>(x, gamma, beta, y, partial, groups, cg, S, G, splits, chunk, eps,
                          silu, st);
  return static_cast<int>(e);
}
