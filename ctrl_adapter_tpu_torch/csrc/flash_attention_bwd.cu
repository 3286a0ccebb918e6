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
// Design: simple and right first, as the TPU splits it: no atomics, two
// kernels that each recompute P (S and dP are computed twice, 7 products
// instead of 5), and a pre-pass for D.
// - dot pre-pass: D = rowsum(dO o O), fp32, H/8 threads a row, 16-byte loads;
// - dK/dV kernel: a CTA holds 128 keys of one (b, n) pair (K, V in shared
//   memory; 8 warps of 16 keys each) and streams the Q, dO, L, D tiles of all
//   T queries through a two-stage cp.async ring. Per tile, each warp computes
//   S^T = K_w Q^T and dP^T = V_w dO^T on mma.sync m16n8k16 (fp32), P^T from L,
//   dS^T, then dV_w += P^T dO and dK_w += dS^T Q with P^T and dS^T packed to
//   bf16 straight from the accumulators as the A operand; each warp owns its
//   16 rows of dK and dV, so nothing is reduced across warps;
// - dQ kernel: a CTA holds 128 queries (Q, dO in shared memory; L and D of a
//   warp's rows in registers) and streams the K, V tiles the same way:
//   S = Q_w K^T, dP = dO_w V^T, dS, dQ_w += dS K.
// Shared memory rows are padded to H + 8 elements, so ldmatrix reads of 8
// rows hit 8 different bank groups. Making it fast (wgmma, TMA rings, one pass
// with dQ in fp32 atomics or a split-K reduction) is later work.
// Shapes: T % 128 == 0, H in {64, 128}; every view (B, N, T, H) with unit last
// stride, 16-byte aligned rows and strides that are multiples of 8 elements,
// which ops/flash_attention.py checks. L and D are contiguous (B, N, T) fp32.
// The host plan (ops/flash_attention.py:bwd_plan) gives the shared memory;
// cak_flash_attention_bwd refuses a plan that does not match BwdCfg.
#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 128;     // keys (dK/dV) or queries (dQ) a CTA holds: 8 warps x 16

struct View {
  int64_t sb, sn, st;  // element strides of the b, n and t axes (h: 1)
};

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  bf16 *dq, *dk, *dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  int N, T;
  float scale;
};

template <int HD>
struct BwdCfg {
  static constexpr int kLd = HD + 8;                  // padded shared row (elements)
  static constexpr int kQTile = HD == 64 ? 64 : 32;   // queries per dK/dV stream tile
  static constexpr int kKvTile = 64;                  // keys per dQ stream tile
  // dK/dV: K, V (kRows each), two stages of Q and dO tiles, two of L and D
  static constexpr int kSmemDkv = (2 * kRows + 4 * kQTile) * kLd * 2 + 4 * kQTile * 4;
  // dQ: Q, dO (kRows each), two stages of K and V tiles
  static constexpr int kSmemDq = (2 * kRows + 4 * kKvTile) * kLd * 2;
};

template <class E>
__device__ __forceinline__ E* row_ptr(E* p, const View& w, int b, int n, int t) {
  return p + b * w.sb + n * w.sn + int64_t(t) * w.st;
}

// ldmatrix.x4.trans: B fragments of two n-tiles for B[k][n] = Y[k][n] with Y
// row-major (k rows, leading dim ld): rows [k0, k0+16), columns [n0, n0+16);
// b[0], b[1] for n-tile n0 and b[2], b[3] for n0 + 8.
__device__ __forceinline__ void ldmatrix_b2_trans(uint32_t (&b)[4], const bf16* y, int ld,
                                                  int k0, int n0, int lane) {
  const bf16* row = y + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

// rows [t0, t0 + R) of a (B, N, T, H) view into a padded shared tile (cp.async).
template <int HD, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* p, const View& w, int b, int n,
                                          int t0) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  const bf16* src = row_ptr(p, w, b, n, t0);
#pragma unroll 4
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(dst + r * (HD + 8) + c * 8, src + int64_t(r) * w.st + c * 8);
  }
}

// R contiguous fp32 values into shared memory (R % 4 == 0, 16-byte aligned).
template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  for (int i = threadIdx.x; i < R / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
}

// acc (16 rows x 8*NT columns, fp32 fragments) of a warp: rows r0 + g (+ 8),
// column pairs 8*nt + 2*t4, times `mul`, as bf16 at (b, n, r0 + row, col).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* p, const View& w, int b, int n, int r0,
                                           const float (&acc)[NT][4], float mul, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* dst = row_ptr(p, w, b, n, r0 + g + 8 * h);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(dst + 8 * nt + 2 * t4) =
          pack_bf16(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
  }
}

// c (16 x 16*NB) += A (16 x 16*KS, rows r0 of a row-major shared tile `a`) times
// B[k][n] = W[n][k] (rows of a row-major shared tile `w`), k over 16*KS.
template <int KS, int NB>
__device__ __forceinline__ void mma_a_wt(float (&c)[2 * NB][4], const bf16* a, const bf16* w,
                                         int ld, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldmatrix_a(af, a, ld, r0, 16 * kk, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bfr[4];
      ldmatrix_b2(bfr, w, ld, 16 * nb, 16 * kk, lane);
      mma_16816(c[2 * nb], af, bfr[0], bfr[1]);
      mma_16816(c[2 * nb + 1], af, bfr[2], bfr[3]);
    }
  }
}

// c (16 x 16*NB) += X (16 x 16*KS, fp32 fragments packed to bf16 as the A
// operand) times Y (16*KS rows of a row-major shared tile `y`, columns 16*NB).
template <int KS, int NB>
__device__ __forceinline__ void mma_x_y(float (&c)[2 * NB][4], const float (&x)[2 * KS][4],
                                        const bf16* y, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bfr[4];
      ldmatrix_b2_trans(bfr, y, ld, 16 * kk, 16 * nb, lane);
      mma_16816(c[2 * nb], af, bfr[0], bfr[1]);
      mma_16816(c[2 * nb + 1], af, bfr[2], bfr[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// D = rowsum(dO o O) for every (b, n, t) row: H/8 threads a row.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot_kernel(Args a, int rows) {
  constexpr int kTpr = HD / 8;
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int row = gid / kTpr, part = gid % kTpr;
  float acc = 0.f;
  if (row < rows) {
    const int t = row % a.T, bn = row / a.T;
    const uint4 ov = *reinterpret_cast<const uint4*>(row_ptr(a.o, a.vo, bn / a.N, bn % a.N, t)
                                                     + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        row_ptr(a.dout, a.vdo, bn / a.N, bn % a.N, t) + part * 8);
    const bf16* po = reinterpret_cast<const bf16*>(&ov);
    const bf16* pd = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(bf2f(po[i]), bf2f(pd[i]), acc);
  }
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) a.dvec[row] = acc;
}

// dK, dV of 128 keys of one (b, n) pair: grid (T / 128, B * N).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(Args a) {
  using C = BwdCfg<HD>;
  constexpr int LD = C::kLd, QT = C::kQTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;        // [2][QT][LD]
  bf16* sdO = sQ + 2 * QT * LD;      // [2][QT][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * QT * LD);  // [2][QT], L * log2(e)
  float* sD = sL + 2 * QT;                                   // [2][QT]

  const int bn = blockIdx.y, b = bn / a.N, n = bn % a.N, key0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t4 = lane & 3;
  const int kw = 16 * warp;  // this warp's key rows in the tile
  const float* lse = a.lse + int64_t(bn) * a.T;
  const float* dvec = a.dvec + int64_t(bn) * a.T;
  const float scale_log2 = a.scale * kLog2e;
  const int nq = a.T / QT;

  auto load_stage = [&](int st, int j) {
    load_rows<HD, QT>(sQ + st * QT * LD, a.q, a.vq, b, n, j * QT);
    load_rows<HD, QT>(sdO + st * QT * LD, a.dout, a.vdo, b, n, j * QT);
    load_vec<QT>(sL + st * QT, lse + j * QT);
    load_vec<QT>(sD + st * QT, dvec + j * QT);
  };
  load_rows<HD, kRows>(sK, a.k, a.vk, b, n, key0);
  load_rows<HD, kRows>(sV, a.v, a.vv, b, n, key0);
  load_stage(0, 0);
  cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < nq; ++j) {
    const int st = j & 1;
    if (j + 1 < nq) load_stage(st ^ 1, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* q = sQ + st * QT * LD;
    const bf16* d_o = sdO + st * QT * LD;
    const float* l2 = sL + st * QT;
    const float* dd = sD + st * QT;

    float p[QT / 8][4], ds[QT / 8][4];  // P^T, then dP^T -> dS^T: 16 keys x QT queries
    zero(p);
    zero(ds);
    mma_a_wt<HD / 16, QT / 16>(p, sK, q, LD, kw, lane);
    mma_a_wt<HD / 16, QT / 16>(ds, sV, d_o, LD, kw, lane);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t4 + (e & 1);
        const float pe = exp2f(fmaf(p[nt][e], scale_log2, -l2[col] * kLog2e));
        p[nt][e] = pe;
        ds[nt][e] = pe * (ds[nt][e] - dd[col]);
      }
    }
    mma_x_y<QT / 16, HD / 16>(dv, p, d_o, LD, lane);
    mma_x_y<QT / 16, HD / 16>(dk, ds, q, LD, lane);
    __syncthreads();  // this stage is reloaded at j + 2's prefetch (iteration j + 1)
  }
  store_rows<HD / 8>(a.dk, a.vdk, b, n, key0 + kw, dk, a.scale, lane);
  store_rows<HD / 8>(a.dv, a.vdv, b, n, key0 + kw, dv, 1.f, lane);
}

// dQ of 128 queries of one (b, n) pair: grid (T / 128, B * N).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(Args a) {
  using C = BwdCfg<HD>;
  constexpr int LD = C::kLd, KT = C::kKvTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kRows * LD;
  bf16* sK = sdO + kRows * LD;  // [2][KT][LD]
  bf16* sV = sK + 2 * KT * LD;  // [2][KT][LD]

  const int bn = blockIdx.y, b = bn / a.N, n = bn % a.N, q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  const int qw = 16 * warp;
  const float scale_log2 = a.scale * kLog2e;
  float l2[2], dd[2];  // L * log2(e) and D of rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = int64_t(bn) * a.T + q0 + qw + g + 8 * h;
    l2[h] = a.lse[row] * kLog2e;
    dd[h] = a.dvec[row];
  }
  const int nk = a.T / KT;

  auto load_stage = [&](int st, int j) {
    load_rows<HD, KT>(sK + st * KT * LD, a.k, a.vk, b, n, j * KT);
    load_rows<HD, KT>(sV + st * KT * LD, a.v, a.vv, b, n, j * KT);
  };
  load_rows<HD, kRows>(sQ, a.q, a.vq, b, n, q0);
  load_rows<HD, kRows>(sdO, a.dout, a.vdo, b, n, q0);
  load_stage(0, 0);
  cp_async_commit();

  float dq[HD / 8][4];
  zero(dq);
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    if (j + 1 < nk) load_stage(st ^ 1, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k = sK + st * KT * LD;
    const bf16* v = sV + st * KT * LD;

    float p[KT / 8][4], ds[KT / 8][4];  // P, then dP -> dS: 16 queries x KT keys
    zero(p);
    zero(ds);
    mma_a_wt<HD / 16, KT / 16>(p, sQ, k, LD, qw, lane);
    mma_a_wt<HD / 16, KT / 16>(ds, sdO, v, LD, qw, lane);
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float pe = exp2f(fmaf(p[nt][e], scale_log2, -l2[h]));
        ds[nt][e] = pe * (ds[nt][e] - dd[h]);
      }
    }
    mma_x_y<KT / 16, HD / 16>(dq, ds, k, LD, lane);
    __syncthreads();
  }
  store_rows<HD / 8>(a.dq, a.vdq, b, n, q0 + qw, dq, a.scale, lane);
}

template <int HD>
cudaError_t launch(const Args& a, int B, int smem_dkv, int smem_dq, cudaStream_t stream) {
  using C = BwdCfg<HD>;
  if (smem_dkv != C::kSmemDkv || smem_dq != C::kSmemDq) return cudaErrorInvalidValue;
  const int rows = B * a.N * a.T;
  const int dot_threads = rows * (HD / 8);
  flash_bwd_dot_kernel<HD><<<(dot_threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(a.T / kRows, B * a.N);
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem_dkv, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dq);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem_dq, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, N, T, H) bf16 views with unit last stride;
// st: their b, n, t element strides in that order (24 values); lse: the
// forward's (B, N, T) fp32 row log-sum-exp; dvec: (B, N, T) fp32 scratch for D.
// smem_dkv, smem_dq: the plan of ops/flash_attention.py:bwd_plan. Three
// launches (D, dK/dV, dQ) on `stream`.
extern "C" int cak_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* dvec, void* dq, void* dk, void* dv, int B, int N,
                                       int T, int H, int smem_dkv, int smem_dq,
                                       const int64_t* st, float scale, void* stream) {
  if (T % kRows || T < kRows || B * N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<float*>(dvec);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  View* views[8] = {&a.vq, &a.vk, &a.vv, &a.vo, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  for (int i = 0; i < 8; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.N = N;
  a.T = T;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (H == 64) {
    e = launch<64>(a, B, smem_dkv, smem_dq, s);
  } else if (H == 128) {
    e = launch<128>(a, B, smem_dkv, smem_dq, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
