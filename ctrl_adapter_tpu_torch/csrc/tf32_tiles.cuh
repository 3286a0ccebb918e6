// 3xTF32 building blocks shared by the fp32 attention kernels
// (flash_attention_fp32.cu, flash_attention_fp32_bwd.cu): fp32 products on the
// tensor cores at fp32's accuracy.
//
// Every fp32 operand x is split into hi = cvt.rna.tf32(x) and lo = x - hi (exact
// in fp32), lo rounded to tf32 as well. A product A B is then three tf32
// wgmma into one fp32 accumulator: A_hi B_lo and A_lo B_hi first, A_hi B_hi
// last; A_lo B_lo (~2^-22 of |A| |B|) is dropped. One tf32 pass alone keeps
// ~3 decimal digits (~4e-4 of an attention output's norm), three keep fp32's
// ~4e-7 (tests/test_torch_fp32_split.py emulates both on the CPU).
//
// tf32 wgmma takes no transpose: both shared-memory operands are K-major.
// The kernels' operands therefore come from a workspace that a prologue
// (tf32_split_kernel, the first launch of each C entry point) fills from the
// (B, N, T, H) views: for each tensor, hi and lo copies in its natural layout
// ((B N T) rows of H) and, where a product sums over T, transposed ((B N H)
// rows of T). In a transposed copy the T positions of each aligned group of 8
// are stored in the order 0 2 4 6 1 3 5 7: a thread's accumulator of S = A B^T
// (m64nNk8) holds columns 2t and 2t + 1 of each 8-column chunk, the tf32 A
// fragment of the next product wants columns t and t + 4, and with that order
// the thread's own registers are the fragment (frag_of), with no shuffle.
// Every tile then reaches shared memory by TMA as 128- (or 64-) byte swizzled
// rows, as the bf16 kernels' do.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace tf32 {

constexpr int kRows = 64;        // rows of a warpgroup's tile (wgmma m64)
constexpr int kSplitRows = 64;   // rows of a (b, n) pair per prologue CTA
constexpr int kSplitThreads = 256;

__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both tf32 (their 13 low mantissa bits zero).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// The A fragments (hi, lo) of k-step i of the next product from the thread's
// accumulator d of S (m64nNk8, N = 8 * steps): a0 = row g, column 2t;
// a1 = row g + 8, column 2t; a2 = row g, column 2t + 1; a3 = row g + 8,
// column 2t + 1 (the stored order of the B operand's K axis, see the header).
template <int R>
__device__ __forceinline__ void frag_of(const float (&d)[R], int i, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(d[4 * i + 0], hi[0], lo[0]);
  split(d[4 * i + 2], hi[1], lo[1]);
  split(d[4 * i + 1], hi[2], lo[2]);
  split(d[4 * i + 3], hi[3], lo[3]);
}

// Descriptor of k-step kk (8 fp32, 32 bytes) of a K-major tile of `rows` rows
// stored as column blocks of ATOM-byte swizzled rows (ATOM 128: 32 fp32 a
// row, 8-row groups 1024 bytes apart; ATOM 64: 16 fp32, 512 bytes apart).
template <int ATOM>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  constexpr int per = ATOM / 32;  // k-steps per swizzled row
  const uint32_t addr = tile + (kk / per) * rows * ATOM + (kk % per) * 32;
  return wgmma_desc(addr, 16, 8 * ATOM, ATOM == 128 ? 1 : 2);
}

template <int N>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "tf32 SS width");
  if constexpr (N == 16) {
    wgmma_tf32_ss_n16(d, da, db, scale_d);
  } else if constexpr (N == 32) {
    wgmma_tf32_ss_n32(d, da, db, scale_d);
  } else {
    wgmma_tf32_ss_n64(d, da, db, scale_d);
  }
}

// d (+)= A B^T in 3xTF32, A (64 x K) and B (N x K) natural tiles in shared
// memory (hi and lo each, 128-byte rows); `fresh` overwrites d.
template <int N, int K>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t ah, uint32_t al,
                                           uint32_t bh, uint32_t bl, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    ss<N>(d, kdesc<128>(ah, kRows, kk), kdesc<128>(bl, N, kk), !fresh || kk > 0);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) ss<N>(d, kdesc<128>(al, kRows, kk), kdesc<128>(bh, N, kk), 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) ss<N>(d, kdesc<128>(ah, kRows, kk), kdesc<128>(bh, N, kk), 1);
}

// acc (64 x H) = acc * alpha[row] + A B in 3xTF32 over KS k-steps: A (64 x
// 8 KS) as register fragments (hi, lo), B a transposed tile (H rows of 8 KS,
// ATOM-byte rows; hi and lo). wgmma adds into its fp32 accumulator with
// truncation, and a chain of T / 8 k-steps in one register drifts by ~3e-5 of
// the norm at T = 4096; so each 64-column block of the product is summed
// into the zeroed `tmp` (3 KS k-steps) and added to acc in fp32, rounded to
// nearest. alpha[h] scales rows g8 + 8 h (the softmax's rescale; 1 for a sum).
template <int H, int KS, int ATOM>
__device__ __forceinline__ void product_rs_add(float (&acc)[H / 2], const uint32_t (&ah)[KS][4],
                                               const uint32_t (&al)[KS][4], uint32_t bh,
                                               uint32_t bl, const float (&alpha)[2],
                                               float (&tmp)[32]) {
#pragma unroll
  for (int half = 0; half < H / 64; ++half) {
    const uint32_t off = half * 64 * ATOM;  // B rows 64 half .. + 63
#pragma unroll
    for (int x = 0; x < 32; ++x) tmp[x] = 0.f;
    fence_regs(tmp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs_n64(tmp, ah[kk], kdesc<ATOM>(bl + off, H, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs_n64(tmp, al[kk], kdesc<ATOM>(bh + off, H, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs_n64(tmp, ah[kk], kdesc<ATOM>(bh + off, H, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      acc[32 * half + x] = fmaf(acc[32 * half + x], alpha[(x >> 1) & 1], tmp[x]);
  }
}

// A natural tile: `rows` rows of H fp32 (row `row` of workspace buffer `buf`,
// each buffer `buf_rows` rows) into column blocks of 32 (128-byte rows).
template <int H>
__device__ __forceinline__ void load_nat(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int buf, int buf_rows, int row, int rows) {
#pragma unroll
  for (int cb = 0; cb < H / 32; ++cb)
    tma_load_2d(dst + cb * rows * 128, map, bar, cb * 32, buf * buf_rows + row);
}

// A transposed tile: the H rows of pair bn in transposed buffer `buf` (each
// buffer bn_count * H rows), `cols` positions from c0, in column blocks of
// ATOM / 4 positions.
template <int H, int ATOM>
__device__ __forceinline__ void load_tr(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int buf, int bn_count, int bn, int c0, int cols) {
  for (int cb = 0; cb < cols / (ATOM / 4); ++cb)
    tma_load_2d(dst + cb * H * ATOM, map, bar, c0 + cb * (ATOM / 4), (buf * bn_count + bn) * H);
}

// One tensor of the prologue: a (B, N, T, H) view (unit H stride, 16-byte
// aligned rows) split into workspace buffers nat, nat + 1 (hi, lo; natural)
// and tr, tr + 1 (transposed), either < 0 for none. With `o`, also
// d[b, n, t] = sum_h src * o, one warp a row in a fixed order (the backward's D).
struct SplitJob {
  const float* src;
  int64_t sb, sn, st;
  int nat, tr;
  const float* o;
  int64_t ob, on, ot;
  float* d;
};

struct SplitJobs {
  SplitJob job[4];
};

// Grid (T / 64, B * N, jobs), 256 threads: each CTA splits 64 rows of one
// (b, n) pair of one job. Buffer i starts at ws + i * buf (buf = B N T H).
template <int H>
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_kernel(SplitJobs jobs, float* __restrict__ ws, int n_heads, int T, int64_t buf) {
  const SplitJob& jb = jobs.job[blockIdx.z];
  __shared__ float tile[kSplitRows][H + 1];
  const int bn = blockIdx.y, b = bn / n_heads, n = bn % n_heads;
  const int r0 = blockIdx.x * kSplitRows;
  const float* src = jb.src + b * jb.sb + n * jb.sn + int64_t(r0) * jb.st;
  for (int i = threadIdx.x; i < kSplitRows * H / 4; i += kSplitThreads) {
    const int r = i / (H / 4), c = 4 * (i % (H / 4));
    const float4 x = *reinterpret_cast<const float4*>(src + r * jb.st + c);
    tile[r][c] = x.x;
    tile[r][c + 1] = x.y;
    tile[r][c + 2] = x.z;
    tile[r][c + 3] = x.w;
    if (jb.nat >= 0) {
      uint4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      const int64_t at = (int64_t(bn) * T + r0 + r) * H + c;
      *reinterpret_cast<uint4*>(ws + jb.nat * buf + at) = hi;
      *reinterpret_cast<uint4*>(ws + (jb.nat + 1) * buf + at) = lo;
    }
  }
  __syncthreads();
  if (jb.d != nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float* ob = jb.o + b * jb.ob + n * jb.on;
    for (int r = warp; r < kSplitRows; r += kSplitThreads / 32) {
      const float* orow = ob + int64_t(r0 + r) * jb.ot;
      float acc = 0.f;
#pragma unroll
      for (int h = lane; h < H; h += 32) acc = fmaf(orow[h], tile[r][h], acc);
      acc = warp_sum(acc);
      if (lane == 0) jb.d[int64_t(bn) * T + r0 + r] = acc;
    }
  }
  if (jb.tr >= 0) {
    for (int i = threadIdx.x; i < kSplitRows * H; i += kSplitThreads) {
      const int h = i / kSplitRows, p = i % kSplitRows;
      const int c = p & 7;
      const int r = (p & ~7) | (c < 4 ? 2 * c : 2 * c - 7);  // position p holds row r
      uint32_t hi, lo;
      split(tile[r][h], hi, lo);
      const int64_t at = (int64_t(bn) * H + h) * T + r0 + p;
      reinterpret_cast<uint32_t*>(ws + jb.tr * buf)[at] = hi;
      reinterpret_cast<uint32_t*>(ws + (jb.tr + 1) * buf)[at] = lo;
    }
  }
}

template <int H>
cudaError_t launch_split(const SplitJobs& jobs, int n_jobs, float* ws, int bn, int n_heads,
                         int T, cudaStream_t stream) {
  const int64_t buf = int64_t(bn) * T * H;
  tf32_split_kernel<H><<<dim3(T / kSplitRows, bn, n_jobs), kSplitThreads, 0, stream>>>(
      jobs, ws, n_heads, T, buf);
  return cudaGetLastError();
}

// Tensor maps over the workspace of `bufs` buffers: natural, (bufs B N T)
// rows of H fp32 in boxes of 32 x box_rows; transposed, (bufs B N H) rows of T
// in boxes of box_cols x H (128-byte swizzle for 32 columns, 64-byte for 16).
inline bool nat_map(CUtensorMap* map, const float* ws, int bufs, int bn, int T, int H,
                    int box_rows) {
  const uint64_t dims[2] = {uint64_t(H), uint64_t(bufs) * bn * T};
  const uint64_t strides[1] = {uint64_t(H) * 4};
  const uint32_t box[2] = {32, uint32_t(box_rows)};
  return encode_f32_map(map, ws, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline bool tr_map(CUtensorMap* map, const float* ws, int bufs, int bn, int T, int H,
                   int box_cols) {
  const uint64_t dims[2] = {uint64_t(T), uint64_t(bufs) * bn * H};
  const uint64_t strides[1] = {uint64_t(T) * 4};
  const uint32_t box[2] = {uint32_t(box_cols), uint32_t(H)};
  return encode_f32_map(map, ws, 2, dims, strides, box,
                        box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The shapes every fp32 entry point takes: T % 64 == 0, 0 < B N <= 65535,
// and TMA's signed 32-bit row coordinates over `bufs` buffers.
inline bool shape_ok(int bn, int T, int H, int bufs) {
  return T % kSplitRows == 0 && T >= kSplitRows && bn >= 1 && bn <= 65535 &&
         int64_t(bufs) * bn * (T > H ? T : H) < (int64_t(1) << 31);
}

}  // namespace tf32
