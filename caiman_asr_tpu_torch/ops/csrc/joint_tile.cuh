// Shared pieces of the joint kernels (joint_fwd.cu, joint_bwd.cu): a simple
// shared-memory tiled product with fp32 accumulation, in two forms.
//
// A block computes one BM x BN output tile C[m, n] = sum_k A(m, k) B(n, k)
// over the whole contraction (no sum carried across blocks, so results are
// deterministic). Each step stages a slice of A and B in shared memory (zero
// outside the matrix). The loaders are functors, so a kernel can transform
// an operand as it is staged (pass B builds dz from the stored u there).
//
// - fp32 operands (namespace joint): staged as fp32, BK = 16 deep; each of
//   the 256 threads accumulates an 8 x 8 register tile on the CUDA cores,
//   rows ty + 16 i and columns tx + 16 j (tx = thread % 16, ty = thread / 16).
// - bf16 operands (namespace joint::tc): staged as bf16, BK = 32 deep; the
//   8 warps (2 along m, 4 along n) each accumulate a 64 x 32 tile as 4 x 2
//   WMMA fragments on the tensor cores (bf16 products, fp32 sums, as the
//   CUDA-core form). The tensor cores' fp32 accumulation truncates, and
//   over a long contraction (pass B sums 139,360 rows) the truncation
//   drifts (2.4e-4 of the result's scale, measured on an H100): so the
//   fragments sum kFlush slices at a time and are then added, rounded to
//   nearest, into a second set of fragments. Epilogues read a fragment back
//   through a per-warp 16 x 16 scratch: lane l holds row l / 2, columns
//   8 (l % 2) .. +8.
//
// No cp.async, no double buffering, no wgmma: right first, fast later. The
// forward and the derivation run on the bf16 tiles, the fp32 passes on the
// fp32 ones; both bf16 passes of the backward have moved to a Hopper design
// (asynchronous staging, wgmma; passa and passb in joint_bwd.cuh on
// joint_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace joint {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int kThreads = 256;
static_assert(BM == 16 * TM && BN == 16 * TN && kThreads == 256, "16 x 16 threads");

using Tile = float[BK][BM + 4];
static_assert(BM == BN, "A and B tiles share one type");

struct Tiles {
  Tile a;
  Tile b;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[k][r] = p[(r0 + r) * ld + k0 + k]: an operand whose contraction index
// is contiguous in memory (rows of length ld), rows < R, contraction < KD.
template <typename T>
__device__ __forceinline__ void load_kmajor(Tile& dst, const T* __restrict__ p, int R, int KD,
                                            int ld, int r0, int k0) {
  for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
    const int r = i / BK;
    const int k = i % BK;
    const int gr = r0 + r;
    const int gk = k0 + k;
    dst[k][r] = (gr < R && gk < KD) ? to_f32(p[static_cast<size_t>(gr) * ld + gk]) : 0.0f;
  }
}

// dst[k][r] = p[(k0 + k) * ld + r0 + r]: an operand whose output index is
// contiguous in memory (the contraction runs over its rows).
template <typename T>
__device__ __forceinline__ void load_mnmajor(Tile& dst, const T* __restrict__ p, int R, int KD,
                                             int ld, int r0, int k0) {
  for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
    const int k = i / BM;
    const int r = i % BM;
    const int gr = r0 + r;
    const int gk = k0 + k;
    dst[k][r] = (gr < R && gk < KD) ? to_f32(p[static_cast<size_t>(gk) * ld + gr]) : 0.0f;
  }
}

// acc[i][j] += sum over k < kdim of A(ty + 16 i, k) * B(tx + 16 j, k), the
// loaders filling s.a / s.b for the slice starting at k0.
template <class LoadA, class LoadB>
__device__ __forceinline__ void mainloop(Tiles& s, float (&acc)[TM][TN], int kdim,
                                         LoadA load_a, LoadB load_b) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    load_a(s.a, k0);
    load_b(s.b, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = s.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = s.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

namespace tc {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BK = 32;
constexpr int LD = BK + 8;      // staged row length: a multiple of 8, rows 32-byte aligned
constexpr int kFlush = 8;       // BK-deep slices summed on the tensor cores per flush
constexpr int WM = 64;          // warp tile rows (2 warps along m)
constexpr int WN = 32;          // warp tile columns (4 warps along n)
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
static_assert(2 * WM == BM && 4 * WN == BN && kThreads == 8 * 32, "8 warps, 2 x 4");

using Stage = bf16[BM][LD];     // [row][k]
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Tiles {
  __align__(128) Stage a;                 // A(m, k)
  __align__(128) Stage b;                 // B(n, k)
  __align__(128) float scratch[8][16 * 16];
};

__device__ __forceinline__ bf16 to_bf16(float x) { return __float2bfloat16_rn(x); }

// 16 bytes (8 bf16) at p when the whole vector is in range and p and the
// row stride allow a 16-byte load; else element by element, zero outside.
__device__ __forceinline__ bool vec_ok(const bf16* p, int ld) {
  return ((reinterpret_cast<size_t>(p) | (static_cast<size_t>(ld) * sizeof(bf16))) % 16) == 0;
}

__device__ __forceinline__ void load8(bf16 (&v)[8], const bf16* __restrict__ p, int n_valid,
                                      bool vec) {
  if (vec && n_valid >= 8) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = q < n_valid ? p[q] : to_bf16(0.0f);
  }
}

// dst[r][k] = p[(r0 + r) * ld + k0 + k] (contraction contiguous in memory):
// each thread moves 8 consecutive k at a time.
__device__ __forceinline__ void load_kmajor(Stage& dst, const bf16* __restrict__ p, int R,
                                            int KD, int ld, int r0, int k0) {
  const bool vec = vec_ok(p, ld);
  for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {
    const int r = i / (BK / 8);
    const int k = 8 * (i % (BK / 8));
    const int gr = r0 + r;
    const int gk = k0 + k;
    alignas(16) bf16 v[8];
    load8(v, p + static_cast<size_t>(gr) * ld + gk, gr < R ? KD - gk : 0, vec);
    *reinterpret_cast<uint4*>(&dst[r][k]) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ void zero(Acc (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc += part, elementwise (both fragments have the same layout), then
// part = 0.
__device__ __forceinline__ void flush(Acc (&acc)[FM][FN], Acc (&part)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
#pragma unroll
      for (int t = 0; t < acc[i][j].num_elements; ++t) acc[i][j].x[t] += part[i][j].x[t];
      wmma::fill_fragment(part[i][j], 0.0f);
    }
}

// acc += A(warp rows, k) B(warp columns, k) over k < kdim.
template <class LoadA, class LoadB>
__device__ __forceinline__ void mainloop(Tiles& s, Acc (&acc)[FM][FN], int kdim, LoadA load_a,
                                         LoadB load_b) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  Acc part[FM][FN];
  zero(part);
  int slices = 0;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    load_a(s.a, k0);
    load_b(s.b, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], &s.a[wm * WM + 16 * i][kk], LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(fb[j], &s.b[wn * WN + 16 * j][kk], LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(part[i][j], fa[i], fb[j], part[i][j]);
    }
    __syncthreads();
    if (++slices == kFlush) {
      flush(acc, part);
      slices = 0;
    }
  }
  flush(acc, part);
}

// For each fragment (i, j) of this warp: fn(i, j, local_row, local_col0, v[8]),
// the lane's 8 values of row local_row, columns local_col0 .. +8, local to
// the block tile. Called by every lane (fn may shuffle).
template <class Fn>
__device__ __forceinline__ void for_each_fragment(Tiles& s, Acc (&acc)[FM][FN], Fn fn) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* scratch = s.scratch[warp];
  const int r = lane / 2;
  const int c0 = 8 * (lane % 2);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = scratch[r * 16 + c0 + c];
      __syncwarp();
      fn(i, (warp / 4) * WM + 16 * i + r, (warp % 4) * WN + 16 * j + c0, v);
    }
}

}  // namespace tc

}  // namespace joint
