// K1: GroupNorm (+ optional SiLU) over NC(F)HW tensors.
//
// Replaces: ctrl_adapter_tpu/ops/group_norm.py, group_norm_silu ->
//   _pallas_group_norm_silu (Pallas body _kernel).
//
// What bounds it on the H100: bytes. Per element it reads 2 bytes and writes
// 2 bytes (bf16; 4 and 4 in fp32) for about ten flops, far below the ~295
// flop/byte ridge, so the floor is one read and one write of the tensor at
// 3.35 TB/s.
//
// Types: every branch is a template over the element type T, bf16 (8 elements
// a 16-byte vector) or float (4 a vector), the type of x, y, gamma and beta;
// the statistics and the affine step are fp32 in both. The host plan sizes
// everything in bytes of T.
//
// Design: in NC(F)HW each (n, g) group is one contiguous span of (C/G)*S
// elements. The host plan (ops/group_norm.py:plan) picks a branch, and
// cak_group_norm_silu refuses a plan that differs from the one it derives:
// - one launch ("one_cta", "several_groups", "cluster"): each CTA holds a
//   contiguous piece of x in shared memory, loaded once by bulk copies
//   (cp.async.bulk, TMA's 1-D form) in pieces of up to 16 KB, each on its own
//   mbarrier, so the sums start on the first piece while the rest land: one
//   group, several small groups, or 1/cluster of a group whose CTAs form a
//   thread-block cluster. Each CTA sums its elements in fp32 (a fixed tree:
//   warp shuffles, then the warps in order); a cluster's CTAs read each
//   other's (sum, sum of squares) through distributed shared memory in rank
//   order, so every CTA of a group forms the same statistics. Then the CTA
//   normalises from shared memory and writes y with 16-byte stores: x is read
//   once and y written once.
// - "two_pass" (spatial sizes not a multiple of a vector, or groups larger than a
//   cluster's shared memory): pass 1 splits every span into `splits` chunks
//   and writes per-chunk fp32 (sum, sum of squares); pass 2 re-reads its
//   group's partials in a fixed order, then normalises its chunk.
// Both form mean and var = E[x^2] - E[x]^2 clamped at 0 (the math of
// _xla_group_norm_silu), apply the per-channel affine and the optional SiLU
// in fp32 and round once to T. All sums are plain fp32 adds, no atomics:
// results are deterministic. No tensor-core dot, whose reduced-precision
// inputs gave NaNs on the TPU (ops/group_norm.py:131-139).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int kVec = 8;  // elements per 16-byte load
  static __device__ __forceinline__ float load(bf16 v) { return bf2f(v); }
  static __device__ __forceinline__ bf16 store(float v) { return f2bf(v); }
};
template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial, int64_t span,
                    int64_t chunk, int splits) {
  constexpr int kVec = Elem<T>::kVec;
  const int64_t grp = blockIdx.y;
  const int sp = blockIdx.x;
  const T* base = x + grp * span;
  const int64_t lo = sp * chunk;
  const int64_t hi = min(span, lo + chunk);
  float s = 0.f, ss = 0.f;
  if (VEC) {
    for (int64_t i = lo + int64_t(threadIdx.x) * kVec; i < hi; i += int64_t(kThreads) * kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(base + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = Elem<T>::load(e[j]);
        s += v;
        ss += v * v;
      }
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      float v = Elem<T>::load(base[i]);
      s += v;
      ss += v * v;
    }
  }
  float2 r = block_sum2(s, ss);
  if (threadIdx.x == 0) partial[grp * splits + sp] = r;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* __restrict__ y,
                    const float2* __restrict__ partial, int64_t span, int64_t chunk,
                    int splits, int64_t cg, int64_t S, int G, float eps, int silu) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
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
  const T* xb = x + grp * span;
  T* yb = y + grp * span;
  const int64_t lo = sp * chunk;
  const int64_t hi = min(span, lo + chunk);
  if (VEC) {
    for (int64_t i = lo + int64_t(threadIdx.x) * kVec; i < hi; i += int64_t(kThreads) * kVec) {
      const int64_t ch = c0 + i / S;  // S % kVec == 0: one channel per vector
      const float ga = E::load(gamma[ch]) * rstd;
      const float be = E::load(beta[ch]);
      uint4 raw = *reinterpret_cast<const uint4*>(xb + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 outv;
      T* o = reinterpret_cast<T*>(&outv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = (E::load(e[j]) - mean) * ga + be;
        if (silu) v = v / (1.f + expf(-v));
        o[j] = E::store(v);
      }
      *reinterpret_cast<uint4*>(yb + i) = outv;
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int64_t ch = c0 + i / S;
      float v = (E::load(xb[i]) - mean) * rstd * E::load(gamma[ch]) + E::load(beta[ch]);
      if (silu) v = v / (1.f + expf(-v));
      yb[i] = E::store(v);
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* partial, int64_t groups, int64_t cg, int64_t S, int G, int splits,
                   int64_t chunk, float eps, int silu, cudaStream_t st) {
  const int64_t span = cg * S;
  dim3 grid(splits, static_cast<unsigned>(groups));
  gn_stats_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<float2*>(partial), span, chunk, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_apply_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(y), static_cast<const float2*>(partial), span, chunk, splits, cg, S,
      G, eps, silu);
  return cudaGetLastError();
}

// ------------------------------------------------------------- one launch
constexpr int kFusedThreads = 512;
constexpr int kPiece = 16384;      // bytes per bulk copy and mbarrier
constexpr int kMaxPieces = 16;
constexpr int kMaxPack = 8;        // groups per CTA
constexpr int kSmemMax = 232448 - 1024;  // below the block limit, beside the static arrays
// behind x: (sum, sum of squares) and (mean, rstd) per group, one mbarrier per piece
constexpr int kAux = 2 * 8 * kMaxPack + 8 * kMaxPieces;

// Shared memory of a one-launch CTA holding `elems` elements of x (spatial size
// S, `isz` bytes an element): x, kAux, and (mean, gamma * rstd, beta) of each
// channel it touches.
__host__ __device__ inline int64_t fused_smem(int64_t elems, int64_t S, int64_t isz) {
  return elems * isz + kAux + 16 * (elems / S + 2);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (sum, sum of squares) at the same shared address in CTA `rank` of the cluster.
__device__ __forceinline__ float2 cluster_load(const float2* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote)
               : "memory");
  return v;
}

// CTA i holds elements [i * elems, (i + 1) * elems) of x: `gpc` whole groups,
// or (cluster > 1, gpc == 1) part `rank` of one group.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kFusedThreads)
    gn_fused_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* __restrict__ y, int elems, int span,
                    int gpc, int cluster, int S, int cg, int G, float eps) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint4* data = reinterpret_cast<const uint4*>(smem_raw);
  float2* part = reinterpret_cast<float2*>(smem_raw + int64_t(elems) * sizeof(T));  // per group
  float2* stat = part + kMaxPack;                                           // (mean, rstd)
  const uint32_t bars = smem_u32(stat + kMaxPack);
  float4* tab = reinterpret_cast<float4*>(stat + kMaxPack + kMaxPieces);  // per channel
  const int64_t e0 = int64_t(blockIdx.x) * elems;  // first element of this CTA
  const int64_t grp0 = e0 / span;                  // its first group (n * G + g)
  const int rel0 = static_cast<int>(e0 - grp0 * span);
  const int bytes = elems * static_cast<int>(sizeof(T));
  const int gbytes = gpc > 1 ? span * static_cast<int>(sizeof(T)) : bytes;  // one group's pieces
  const int per_group = (gbytes + kPiece - 1) / kPiece;
  auto piece_bytes = [&](int k) {  // piece k: group k / per_group, part k % per_group
    const int lo = (k % per_group) * kPiece;
    return min(kPiece, gbytes - lo);
  };
  auto piece_off = [&](int k) { return (k / per_group) * gbytes + (k % per_group) * kPiece; };

  if (threadIdx.x == 0) {
    for (int k = 0; k < gpc * per_group; ++k) mbar_init(bars + 8 * k, 1);
    mbar_fence_init();
    for (int k = 0; k < gpc * per_group; ++k) {
      mbar_expect_tx(bars + 8 * k, piece_bytes(k));
      bulk_load(smem_u32(smem_raw) + piece_off(k),
                reinterpret_cast<const unsigned char*>(x + e0) + piece_off(k), piece_bytes(k),
                bars + 8 * k);
    }
  }
  __syncthreads();

  __shared__ float red[2][kFusedThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int lg = 0; lg < gpc; ++lg) {
    float s = 0.f, ss = 0.f;
    for (int k = lg * per_group; k < (lg + 1) * per_group; ++k) {
      mbar_wait(bars + 8 * k, 0);
      const int v0 = piece_off(k) / 16, v1 = v0 + piece_bytes(k) / 16;
      for (int v = v0 + threadIdx.x; v < v1; v += kFusedThreads) {
        const uint4 raw = data[v];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float f = E::load(e[j]);
          s += f;
          ss += f * f;
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = ss;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float2 r = make_float2(0.f, 0.f);
      for (int i = 0; i < kFusedThreads / 32; ++i) {
        r.x += red[0][i];
        r.y += red[1][i];
      }
      part[lg] = r;
    }
    __syncthreads();
  }
  if (cluster > 1) {
    cluster_arrive();  // this CTA's partial sums are visible to the cluster
    cluster_wait();
  }
  if (static_cast<int>(threadIdx.x) < gpc) {
    float2 t = part[threadIdx.x];
    if (cluster > 1) {  // the group's CTAs in rank order: the same sums in every CTA
      t = make_float2(0.f, 0.f);
      for (int r = 0; r < cluster; ++r) {
        const float2 p = cluster_load(part, r);
        t.x += p.x;
        t.y += p.y;
      }
    }
    const float cnt = static_cast<float>(span);
    const float mean = t.x / cnt;
    const float var = fmaxf(t.y / cnt - mean * mean, 0.f);
    stat[threadIdx.x] = make_float2(mean, rsqrtf(var + eps));
  }
  if (cluster > 1) cluster_arrive();  // done reading the other CTAs' partials
  __syncthreads();
  // the channels this CTA touches, from the first one's start: local channel lc
  const int r0s = rel0 % S, nlc = (r0s + elems + S - 1) / S;
  for (int lc = threadIdx.x; lc < nlc; lc += kFusedThreads) {
    const int pos = rel0 - r0s + lc * S;  // its first element, from the CTA's first group
    const int lg = pos / span;
    const int ch = static_cast<int>((grp0 + lg) % G) * cg + (pos - lg * span) / S;
    tab[lc] = make_float4(stat[lg].x, E::load(gamma[ch]) * stat[lg].y, E::load(beta[ch]), 0.f);
  }
  __syncthreads();

  // 16-byte vector v lies in local channel floor((r0s / kVec + v) / (S / kVec));
  // the float quotient is exact while r0s / kVec + v < 2^22 (+ 0.5 keeps it off
  // the edge)
  const int q0 = r0s / kVec;
  const float inv = 1.f / static_cast<float>(S / kVec);
  for (int v = threadIdx.x; v < elems / kVec; v += kFusedThreads) {
    const float4 t = tab[static_cast<int>((static_cast<float>(q0 + v) + 0.5f) * inv)];
    const uint4 raw = data[v];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 outv;
    T* o = reinterpret_cast<T*>(&outv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float f = (E::load(e[j]) - t.x) * t.y + t.z;
      if (SILU) f = __fdividef(f, 1.f + __expf(-f));
      o[j] = E::store(f);
    }
    *reinterpret_cast<uint4*>(y + e0 + int64_t(v) * kVec) = outv;
  }
  if (cluster > 1) cluster_wait();  // no CTA leaves while its partials may be read
}

template <typename T, bool SILU>
cudaError_t launch_fused(const void* x, const void* gamma, const void* beta, void* y, int elems,
                         int span, int gpc, int cluster, int S, int cg, int G, int grid,
                         int smem, float eps, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gn_fused_kernel<T, SILU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_fused_kernel<T, SILU>, static_cast<const T*>(x),
                            static_cast<const T*>(gamma), static_cast<const T*>(beta),
                            static_cast<T*>(y), elems, span, gpc, cluster, S, cg, G, eps);
}

template <typename T>
int dispatch(const void* x, const void* gamma, const void* beta, void* y, void* partial,
             int64_t groups, int64_t cg, int64_t S, int G, int branch, int cluster, int gpc,
             int64_t elems, int64_t grid, int64_t smem, float eps, int silu, int vec,
             cudaStream_t st) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int64_t isz = sizeof(T);
  const int64_t span = cg * S;
  if (branch == 0) {
    if (grid < 1 || elems < 1 || (grid - 1) * elems >= span || grid * elems < span || smem ||
        (vec && (S % kVec || elems % kVec)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int splits = static_cast<int>(grid);
    const cudaError_t e =
        vec ? launch<T, true>(x, gamma, beta, y, partial, groups, cg, S, G, splits, elems, eps,
                              silu, st)
            : launch<T, false>(x, gamma, beta, y, partial, groups, cg, S, G, splits, elems, eps,
                               silu, st);
    return static_cast<int>(e);
  }
  // one launch: the plan must be the one the branch implies
  const bool pow2 = (cluster & (cluster - 1)) == 0 && (gpc & (gpc - 1)) == 0;
  const int want = gpc > 1 ? 2 : (cluster > 1 ? 3 : 1);
  if (branch != want || !vec || S % kVec || cluster < 1 || cluster > 8 || gpc < 1 ||
      gpc > kMaxPack || !pow2 || (gpc > 1 && cluster > 1) || groups % gpc ||
      span % (kVec * cluster) || elems != (gpc > 1 ? gpc * span : span / cluster) ||
      grid != groups / gpc * cluster || smem != fused_smem(elems, S, isz) || smem > kSmemMax ||
      gpc * ((elems * isz / gpc + kPiece - 1) / kPiece) > kMaxPieces || span > (1 << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      silu ? launch_fused<T, true>(x, gamma, beta, y, static_cast<int>(elems),
                                   static_cast<int>(span), gpc, cluster, static_cast<int>(S),
                                   static_cast<int>(cg), G, static_cast<int>(grid),
                                   static_cast<int>(smem), eps, st)
           : launch_fused<T, false>(x, gamma, beta, y, static_cast<int>(elems),
                                    static_cast<int>(span), gpc, cluster, static_cast<int>(S),
                                    static_cast<int>(cg), G, static_cast<int>(grid),
                                    static_cast<int>(smem), eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (N, C, *spatial) contiguous, gamma, beta: (C,), all bf16 (itemsize 2)
// or all float (itemsize 4). groups = N * G, cg = C / G, S = prod(spatial). The
// plan of ops/group_norm.py:plan: branch 0 "two_pass" (partial: fp32 scratch of
// 2 * groups * grid floats; grid splits of `elems` elements per group; vec:
// 16-byte loads), else one launch of `grid` CTAs holding `elems` elements each:
// branch 1 "one_cta" (one group a CTA), 2 "several_groups" (gpc groups a CTA),
// 3 "cluster" (a group over `cluster` CTAs), with `smem` bytes of shared memory.
extern "C" int cak_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* y, void* partial, int64_t groups, int64_t cg,
                                   int64_t S, int G, int branch, int cluster, int gpc,
                                   int64_t elems, int64_t grid, int64_t smem, float eps,
                                   int silu, int vec, int itemsize, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 2)
    return dispatch<bf16>(x, gamma, beta, y, partial, groups, cg, S, G, branch, cluster, gpc,
                          elems, grid, smem, eps, silu, vec, st);
  if (itemsize == 4)
    return dispatch<float>(x, gamma, beta, y, partial, groups, cg, S, G, branch, cluster, gpc,
                           elems, grid, smem, eps, silu, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
