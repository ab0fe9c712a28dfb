// Shared pieces of the joint's fp32 kernels (joint_fwd.cu, joint_derive.cuh,
// joint_bwd.cuh): a simple shared-memory tiled product on the CUDA cores
// with fp32 accumulation.
//
// A block computes one BM x BN output tile C[m, n] = sum_k A(m, k) B(n, k)
// over the whole contraction (no sum carried across blocks, so results are
// deterministic). Each step stages a BK = 16 deep slice of A and B in
// shared memory as fp32 (zero outside the matrix); each of the 256 threads
// accumulates an 8 x 8 register tile, rows ty + 16 i and columns tx + 16 j
// (tx = thread % 16, ty = thread / 16). The loaders are functors, so a
// kernel can transform an operand as it is staged (pass B builds dz from
// the stored u there).
//
// No cp.async, no double buffering: right first. The bf16 kernels are
// Hopper designs of their own: the forward and the derivation on
// joint_prod_sm90.cuh, passes A and B (passa, passb in joint_bwd.cuh), all
// on joint_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

}  // namespace joint
