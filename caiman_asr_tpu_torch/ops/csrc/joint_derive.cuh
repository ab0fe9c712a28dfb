// Deriving the softmax numerators again in the joint's backward, for the
// routes that store no slab (joint_bwd_fused.cu, joint_bwd_recompute.cu):
//   v[n, k] = exp(h[n] . wt[k] + bias[k] - shift[n])
// with shift null (u = exp(z), K6) or the row's log-sum-exp (p = softmax,
// K4). One product of 2 N Hj K operations with an exp epilogue, a [BM x BN]
// tile per block (joint_tile.cuh). The tile is written as fp32 (out32) or as
// bf16 (out16) or both; either may be null.

#pragma once

#include "joint_tile.cuh"

namespace joint {

__device__ __forceinline__ void derive_store(float v, size_t at, float* out32,
                                             __nv_bfloat16* out16) {
  if (out32 != nullptr) out32[at] = v;
  if (out16 != nullptr) out16[at] = __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(kThreads)
derive_kernel(const float* __restrict__ h,      // [N, Hj]
              const float* __restrict__ wt,     // [K, Hj]
              const float* __restrict__ bias,   // [K]
              const float* __restrict__ shift,  // [N] or null
              float* __restrict__ out32,        // [N, K] or null
              __nv_bfloat16* __restrict__ out16,  // [N, K] or null
              int N, int Hj, int K) {
  __shared__ Tiles s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero(acc);
  mainloop(
      s, acc, Hj,
      [&](Tile& a, int k0) { load_kmajor(a, h, N, Hj, Hj, m0, k0); },
      [&](Tile& b, int k0) { load_kmajor(b, wt, K, Hj, Hj, n0, k0); });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= N) continue;
    const float d = shift != nullptr ? shift[row] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < K)
        derive_store(expf(acc[i][j] + bias[col] - d), static_cast<size_t>(row) * K + col, out32,
                     out16);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
derive_tc_kernel(const tc::bf16* __restrict__ h,   // [N, Hj]
                 const tc::bf16* __restrict__ wt,  // [K, Hj]
                 const float* __restrict__ bias,   // [K]
                 const float* __restrict__ shift,  // [N] or null
                 float* __restrict__ out32,        // [N, K] or null
                 tc::bf16* __restrict__ out16,     // [N, K] or null
                 int N, int Hj, int K) {
  __shared__ tc::Tiles s;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  tc::Acc acc[tc::FM][tc::FN];
  tc::zero(acc);
  tc::mainloop(
      s, acc, Hj,
      [&](tc::Stage& a, int k0) { tc::load_kmajor(a, h, N, Hj, Hj, m0, k0); },
      [&](tc::Stage& b, int k0) { tc::load_kmajor(b, wt, K, Hj, Hj, n0, k0); });
  tc::for_each_fragment(s, acc, [&](int, int r, int c, const float* v) {
    const int row = m0 + r;
    if (row >= N) return;
    const float d = shift != nullptr ? shift[row] : 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = n0 + c + q;
      if (col < K)
        derive_store(expf(v[q] + bias[col] - d), static_cast<size_t>(row) * K + col, out32,
                     out16);
    }
  });
}

// One launch over N rows; h and wt in the compute dtype (0 = float32,
// 1 = bfloat16). Returns the CUDA error (0 on success).
inline int launch_derive(const void* h, const void* wt, const float* bias, const float* shift,
                         float* out32, __nv_bfloat16* out16, int N, int Hj, int K, int dtype,
                         cudaStream_t s) {
  if (N <= 0 || K <= 0) return 0;
  const dim3 grid((N + BM - 1) / BM, (K + BN - 1) / BN);
  if (dtype == 0)
    derive_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(h),
                                            static_cast<const float*>(wt), bias, shift, out32,
                                            out16, N, Hj, K);
  else if (dtype == 1)
    derive_tc_kernel<<<grid, kThreads, 0, s>>>(static_cast<const tc::bf16*>(h),
                                               static_cast<const tc::bf16*>(wt), bias, shift,
                                               out32, out16, N, Hj, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace joint
