// The joint's two backward passes as templates over where u = exp(z) is read
// from. The sources of u and who instantiates the passes for them:
//   SlabBf16, the stored bf16 slab (or a row chunk's bf16 tile): joint_bwd.cu
//     (K5-A, K5-B, each a call), joint_bwd_fused.cu (K5-fused-u, both behind
//     one call), joint_bwd_recompute.cu (K6-derive-a's pass A, bf16 weights);
//   SlabI8, the scaled-int8 slab: joint_bwd.cu (K7-A8, K7-B8),
//     joint_bwd_fused.cu (K7-fused-u8);
//   SlabF32, a fixed-size fp32 workspace a row chunk is derived into:
//     joint_bwd_fused.cu (K6-fused), joint_bwd_recompute.cu (K6-derive-a
//     with fp32 weights; K4-A and K4-B, where it holds the softmax p itself
//     and cs below is the unscaled cb + cl).
//
// With cs = (cb + cl) exp(-denom) per row (the softmax row scale folded in
// by the caller):
//   pass A: smear[n, j] = -cs[n] * sum_k round_a(u[n, k]) w[j, k]    [N, Hj]
//   pass B: dz[n, k]    = -cs[n] u[n, k] + (label[n] == k) cl[n]
//           dw[j, k]    = sum_n h[n, j] round_to_h_dtype(dz[n, k])    [Hj, K]
//           db[k]       = sum_n dz[n, k]  (unrounded, fp32)
// The blank column's h^T cb and sum cb (pallas_joint.py:441-451) are added
// by the caller. All sums accumulate in fp32. round_a: bf16 inputs stage u
// as bf16 for the tensor cores whatever its source; fp32 inputs take u as
// it is, except from the int8 slab, whose dequantised value the TPU kernel
// rounds to bf16 for pass A whatever the weight dtype
// (pallas_joint.py:333-336). A label outside [0, K) (the caller shifted it
// to a range of columns that does not hold it) meets no column: the compare
// is signed.
//
// Design. A Hopper block cannot carry a sum across a sequential grid axis
// as the TPU kernels do, so each block owns one output tile and loops over
// the whole contraction: in pass A a [BM rows x BN of Hj] tile of smear
// looping over K; in pass B a [BM of Hj x BN of K] tile of dw looping over
// the rows. dz is built from u as it is staged in shared memory, rounded to
// h's dtype there. db is summed by the blocks of the first Hj tile: each
// thread always stages the same columns, keeps its partial sums in
// registers, and the partials of a column are added in a fixed order. No
// atomics: the results are deterministic. With ``accumulate`` pass B adds
// its tile to what dw and db hold, so a caller can walk the rows in chunks;
// the block that owns a tile is the only one that touches it.

#pragma once

#include <stdint.h>

#include "joint_tile.cuh"

namespace joint {

// ------------------------------------------------------------- sources of u
// at(row, col): one value. load8(v, row, col, n_valid): the 8 values from
// col (a multiple of 8), zero from n_valid on (n_valid <= 0: nothing is
// read). kRoundA: pass A rounds the value to bf16 even for fp32 inputs.

struct SlabBf16 {  // the stored bf16 slab [N, K]
  const __nv_bfloat16* u;
  int K;
  static constexpr bool kRoundA = false;
  __device__ __forceinline__ float at(int row, int col) const {
    return to_f32(u[static_cast<size_t>(row) * K + col]);
  }
  __device__ __forceinline__ void load8(float (&v)[8], int row, int col, int n_valid) const {
    alignas(16) __nv_bfloat16 t[8];
    tc::load8(t, u + static_cast<size_t>(row) * K + col, n_valid, tc::vec_ok(u, K));
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = to_f32(t[q]);
  }
};

struct SlabI8 {  // q int8 [N, K] and one fp32 scale per (kt-wide vocab tile, row): s [K / kt, N]
  const int8_t* q;
  const float* s;
  int K;
  int N;
  int kt;  // a multiple of 8
  static constexpr bool kRoundA = true;
  __device__ __forceinline__ float scale(int row, int col) const {
    return s[static_cast<size_t>(col / kt) * N + row];
  }
  __device__ __forceinline__ float at(int row, int col) const {
    return static_cast<float>(q[static_cast<size_t>(row) * K + col]) * scale(row, col);
  }
  __device__ __forceinline__ void load8(float (&v)[8], int row, int col, int n_valid) const {
    if (n_valid <= 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.0f;
      return;
    }
    const float sc = scale(row, col);
    const int8_t* p = q + static_cast<size_t>(row) * K + col;
    if (n_valid >= 8 && (reinterpret_cast<size_t>(q) | static_cast<size_t>(K)) % 8 == 0) {
      const int2 raw = *reinterpret_cast<const int2*>(p);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(b[i]) * sc;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = i < n_valid ? static_cast<float>(p[i]) * sc : 0.0f;
    }
  }
};

struct SlabF32 {  // fp32 u [rows, K], the no-slab backward's workspace
  const float* u;
  int K;
  static constexpr bool kRoundA = false;
  __device__ __forceinline__ float at(int row, int col) const {
    return u[static_cast<size_t>(row) * K + col];
  }
  __device__ __forceinline__ void load8(float (&v)[8], int row, int col, int n_valid) const {
    const float* p = u + static_cast<size_t>(row) * K + col;
    if (n_valid >= 8 && (reinterpret_cast<size_t>(u) | (static_cast<size_t>(K) * 4)) % 16 == 0) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = i < n_valid ? p[i] : 0.0f;
    }
  }
};

// ------------------------------------------------------------------ pass A
template <class U>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dh_kernel(U src,                        // u [N, K]
                    const float* __restrict__ w,  // [Hj, K]
                    const float* __restrict__ cs, // [N]
                    float* __restrict__ smear,    // [N, Hj]
                    int N, int Hj, int K) {
  __shared__ Tiles s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero(acc);
  mainloop(
      s, acc, K,
      [&](Tile& a, int k0) {
        for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
          const int r = i / BK;
          const int k = i % BK;
          const int gr = m0 + r;
          const int gk = k0 + k;
          float v = 0.0f;
          if (gr < N && gk < K) {
            v = src.at(gr, gk);
            if (U::kRoundA) v = __bfloat162float(__float2bfloat16_rn(v));
          }
          a[k][r] = v;
        }
      },
      [&](Tile& b, int k0) { load_kmajor(b, w, Hj, K, K, n0, k0); });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= N) continue;
    const float c = -cs[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Hj) smear[static_cast<size_t>(row) * Hj + col] = c * acc[i][j];
    }
  }
}

template <class U>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dh_tc_kernel(U src,                            // u [N, K]
                       const tc::bf16* __restrict__ w,   // [Hj, K]
                       const float* __restrict__ cs,     // [N]
                       float* __restrict__ smear,        // [N, Hj]
                       int N, int Hj, int K) {
  __shared__ tc::Tiles s;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  tc::Acc acc[tc::FM][tc::FN];
  tc::zero(acc);
  tc::mainloop(
      s, acc, K,
      [&](tc::Stage& a, int k0) {
        for (int i = threadIdx.x; i < BM * tc::BK / 8; i += kThreads) {
          const int r = i / (tc::BK / 8);
          const int k = 8 * (i % (tc::BK / 8));
          const int gr = m0 + r;
          const int gk = k0 + k;
          float v[8];
          src.load8(v, gr, gk, gr < N ? K - gk : 0);
          alignas(16) tc::bf16 t[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) t[q] = tc::to_bf16(v[q]);
          *reinterpret_cast<uint4*>(&a[r][k]) = *reinterpret_cast<const uint4*>(t);
        }
      },
      [&](tc::Stage& b, int k0) { tc::load_kmajor(b, w, Hj, K, K, n0, k0); });
  tc::for_each_fragment(s, acc, [&](int, int r, int c, const float* v) {
    const int row = m0 + r;
    if (row >= N) return;
    const float scale = -cs[row];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (n0 + c + q < Hj) smear[static_cast<size_t>(row) * Hj + n0 + c + q] = scale * v[q];
  });
}

// ------------------------------------------------------------------ pass B
template <class U>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dw_kernel(const float* __restrict__ h,          // [N, Hj]
                    U src,                                // u [N, K]
                    const float* __restrict__ cs,         // [N]
                    const float* __restrict__ cl,         // [N]
                    const int* __restrict__ labels,       // [N]
                    float* __restrict__ dw,               // [Hj, K]
                    float* __restrict__ db,               // [K]
                    int N, int Hj, int K, bool accumulate) {
  static_assert(kThreads % BN == 0, "a thread stages one fixed dz column");
  __shared__ Tiles s;
  __shared__ float db_s[kThreads];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;  // Hj
  const int n0 = blockIdx.y * BN;  // K
  float db_part = 0.0f;
  float acc[TM][TN];
  zero(acc);
  mainloop(
      s, acc, N,
      [&](Tile& a, int k0) { load_mnmajor(a, h, Hj, N, Hj, m0, k0); },
      [&](Tile& b, int k0) {
        for (int i = threadIdx.x; i < BN * BK; i += kThreads) {
          const int k = i / BN;
          const int c = i % BN;
          const int row = k0 + k;
          const int col = n0 + c;
          float v = 0.0f;
          if (row < N && col < K) {
            v = -cs[row] * src.at(row, col);
            if (labels[row] == col) v += cl[row];
          }
          db_part += v;
          b[k][c] = v;
        }
      });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= Hj) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= K) continue;
      float* out = dw + static_cast<size_t>(row) * K + col;
      *out = accumulate ? *out + acc[i][j] : acc[i][j];
    }
  }
  if (blockIdx.x != 0) return;
  db_s[threadIdx.x] = db_part;
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < K) {
    float v = 0.0f;
    for (int p = threadIdx.x; p < kThreads; p += BN) v += db_s[p];
    float* out = db + n0 + threadIdx.x;
    *out = accumulate ? *out + v : v;
  }
}

template <class U>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dw_tc_kernel(const tc::bf16* __restrict__ h,   // [N, Hj]
                       U src,                            // u [N, K]
                       const float* __restrict__ cs,     // [N]
                       const float* __restrict__ cl,     // [N]
                       const int* __restrict__ labels,   // [N]
                       float* __restrict__ dw,           // [Hj, K]
                       float* __restrict__ db,           // [K]
                       int N, int Hj, int K, bool accumulate) {
  // a thread stages 8 fixed dz columns: 16 column groups x 16 row slots
  static_assert(kThreads == 16 * (BN / 8), "a thread stages 8 fixed dz columns");
  __shared__ tc::Tiles s;
  __shared__ float db_s[kThreads / (BN / 8)][BN];
  const int m0 = blockIdx.x * BM;  // Hj
  const int n0 = blockIdx.y * BN;  // K
  const int cg = 8 * (threadIdx.x % (BN / 8));
  float db_part[8] = {};
  tc::Acc acc[tc::FM][tc::FN];
  tc::zero(acc);
  tc::mainloop(
      s, acc, N,
      [&](tc::Stage& a, int k0) { tc::load_mnmajor(a, h, Hj, N, Hj, m0, k0); },
      [&](tc::Stage& b, int k0) {
        for (int k = threadIdx.x / (BN / 8); k < tc::BK; k += kThreads / (BN / 8)) {
          const int row = k0 + k;
          const int col = n0 + cg;
          float uv[8];
          src.load8(uv, row, col, row < N ? K - col : 0);
          const float c = row < N ? -cs[row] : 0.0f;
          const int lab = row < N ? labels[row] - col : -1;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            float v = c * uv[q];
            if (q == lab) v += cl[row];
            db_part[q] += v;
            b[cg + q][k] = __float2bfloat16_rn(v);
          }
        }
      });
  tc::for_each_fragment(s, acc, [&](int, int r, int c, const float* v) {
    const int row = m0 + r;
    if (row >= Hj) return;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (n0 + c + q >= K) continue;
      float* out = dw + static_cast<size_t>(row) * K + n0 + c + q;
      *out = accumulate ? *out + v[q] : v[q];
    }
  });
  if (blockIdx.x != 0) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) db_s[threadIdx.x / (BN / 8)][cg + q] = db_part[q];
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < K) {
    float total = 0.0f;
    for (int p = 0; p < kThreads / (BN / 8); ++p) total += db_s[p][threadIdx.x];
    float* out = db + n0 + threadIdx.x;
    *out = accumulate ? *out + total : total;
  }
}

// ------------------------------------------------------------------ launches
// One launch each; dtype 0 = float32, 1 = bfloat16 (of w for pass A, of h
// for pass B). Return the CUDA error (0 on success).
template <class U>
int launch_dh(U src, const void* w, const float* cs, float* smear, int N, int Hj, int K,
              int dtype, cudaStream_t s) {
  if (N <= 0 || Hj <= 0) return 0;
  const dim3 grid((N + BM - 1) / BM, (Hj + BN - 1) / BN);
  if (dtype == 0)
    joint_bwd_dh_kernel<U><<<grid, kThreads, 0, s>>>(
        src, static_cast<const float*>(w), cs, smear, N, Hj, K);
  else if (dtype == 1)
    joint_bwd_dh_tc_kernel<U><<<grid, kThreads, 0, s>>>(
        src, static_cast<const tc::bf16*>(w), cs, smear, N, Hj, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <class U>
int launch_dw(const void* h, U src, const float* cs, const float* cl, const int* labels,
              float* dw, float* db, int N, int Hj, int K, bool accumulate, int dtype,
              cudaStream_t s) {
  if (Hj <= 0 || K <= 0) return 0;
  const dim3 grid((Hj + BM - 1) / BM, (K + BN - 1) / BN);
  if (dtype == 0)
    joint_bwd_dw_kernel<U><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), src, cs, cl, labels, dw, db, N, Hj, K, accumulate);
  else if (dtype == 1)
    joint_bwd_dw_tc_kernel<U><<<grid, kThreads, 0, s>>>(
        static_cast<const tc::bf16*>(h), src, cs, cl, labels, dw, db, N, Hj, K, accumulate);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace joint
