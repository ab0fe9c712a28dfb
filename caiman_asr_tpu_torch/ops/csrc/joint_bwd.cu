// Joint backward over the stored u = exp(z) slab for Hopper (sm_90a): the
// counterparts of the Pallas TPU kernels
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dh_kernel_u (K5-A, pass A) and
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dw_kernel_u (K5-B, pass B).
//
// With cs = (cb + cl) exp(-denom) per row (the softmax row scale folded in
// by the caller):
//   pass A: smear[n, j] = -cs[n] * sum_k u[n, k] w[j, k]          [N, Hj]
//   pass B: dz[n, k]    = -cs[n] u[n, k] + (label[n] == k) cl[n]
//           dw[j, k]    = sum_n h[n, j] round_to_h_dtype(dz[n, k])  [Hj, K]
//           db[k]       = sum_n dz[n, k]  (unrounded, fp32)
// The blank column's h^T cb and sum cb (pallas_joint.py:441-451) are added
// by the caller. All sums accumulate in fp32.
//
// What bounds them: each pass is 2 N Hj K operations (as the forward) and
// reads the slab once (N K 2 bytes), so both are operation-bound GEMMs.
// bf16 inputs run them on the tensor cores (WMMA), fp32 inputs on the CUDA
// cores (joint_tile.cuh).
//
// Design. A Hopper block cannot carry a sum across a sequential grid axis
// as the TPU kernel does, so each block owns one output tile and loops over
// the whole contraction: in pass A a [BM rows x BN of Hj] tile of smear
// looping over K; in pass B a [BM of Hj x BN of K] tile of dw looping over
// all N rows. dz is built from u as it is staged in shared memory. db is
// summed by the blocks of the first Hj tile: each thread always stages the
// same column (256 threads, 128 columns), keeps its partial sum in a
// register, and the two partials of a column are added in a fixed order.
// dz is rounded to h's dtype as it is staged (bf16 for the tensor cores).
// No atomics: the results are deterministic.

#include "joint_tile.cuh"

namespace {

using namespace joint;

__global__ void __launch_bounds__(kThreads)
joint_bwd_dh_kernel(const __nv_bfloat16* __restrict__ u,  // [N, K]
                    const float* __restrict__ w,          // [Hj, K]
                    const float* __restrict__ cs,         // [N]
                    float* __restrict__ smear,            // [N, Hj]
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
      [&](Tile& a, int k0) { load_kmajor(a, u, N, K, K, m0, k0); },
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

__global__ void __launch_bounds__(kThreads)
joint_bwd_dw_kernel(const float* __restrict__ h,          // [N, Hj]
                    const __nv_bfloat16* __restrict__ u,  // [N, K]
                    const float* __restrict__ cs,         // [N]
                    const float* __restrict__ cl,         // [N]
                    const int* __restrict__ labels,       // [N]
                    float* __restrict__ dw,               // [Hj, K]
                    float* __restrict__ db,               // [K]
                    int N, int Hj, int K) {
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
            v = -cs[row] * to_f32(u[static_cast<size_t>(row) * K + col]);
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
      if (col < K) dw[static_cast<size_t>(row) * K + col] = acc[i][j];
    }
  }
  if (blockIdx.x != 0) return;
  db_s[threadIdx.x] = db_part;
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < K) {
    float v = 0.0f;
    for (int p = threadIdx.x; p < kThreads; p += BN) v += db_s[p];
    db[n0 + threadIdx.x] = v;
  }
}


__global__ void __launch_bounds__(kThreads)
joint_bwd_dh_tc_kernel(const tc::bf16* __restrict__ u,   // [N, K]
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
      [&](tc::Stage& a, int k0) { tc::load_kmajor(a, u, N, K, K, m0, k0); },
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

__global__ void __launch_bounds__(kThreads)
joint_bwd_dw_tc_kernel(const tc::bf16* __restrict__ h,   // [N, Hj]
                       const tc::bf16* __restrict__ u,   // [N, K]
                       const float* __restrict__ cs,     // [N]
                       const float* __restrict__ cl,     // [N]
                       const int* __restrict__ labels,   // [N]
                       float* __restrict__ dw,           // [Hj, K]
                       float* __restrict__ db,           // [K]
                       int N, int Hj, int K) {
  // a thread stages 8 fixed dz columns: 16 column groups x 16 row slots
  static_assert(kThreads == 16 * (BN / 8), "a thread stages 8 fixed dz columns");
  __shared__ tc::Tiles s;
  __shared__ float db_s[kThreads / (BN / 8)][BN];
  const int m0 = blockIdx.x * BM;  // Hj
  const int n0 = blockIdx.y * BN;  // K
  const int cg = 8 * (threadIdx.x % (BN / 8));
  const bool vec = tc::vec_ok(u, K);
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
          alignas(16) tc::bf16 uv[8];
          tc::load8(uv, u + static_cast<size_t>(row) * K + col, row < N ? K - col : 0, vec);
          const float c = row < N ? -cs[row] : 0.0f;
          const int lab = row < N ? labels[row] - col : -1;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            float v = c * to_f32(uv[q]);
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
    for (int q = 0; q < 8; ++q)
      if (n0 + c + q < K) dw[static_cast<size_t>(row) * K + n0 + c + q] = v[q];
  });
  if (blockIdx.x != 0) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) db_s[threadIdx.x / (BN / 8)][cg + q] = db_part[q];
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < K) {
    float total = 0.0f;
    for (int p = 0; p < kThreads / (BN / 8); ++p) total += db_s[p][threadIdx.x];
    db[n0 + threadIdx.x] = total;
  }
}

}  // namespace

extern "C" {

// Pass A, one launch. u bf16 [N, K]; w [Hj, K] in the compute dtype
// (0 = float32, 1 = bfloat16); cs [N] and smear [N, Hj] fp32.
int joint_bwd_dh(const void* u, const void* w, const void* cs, void* smear, int N, int Hj,
                 int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Hj <= 0) return 0;
  const dim3 grid((N + BM - 1) / BM, (Hj + BN - 1) / BN);
  const auto* up = static_cast<const __nv_bfloat16*>(u);
  const auto* cp = static_cast<const float*>(cs);
  auto* sp = static_cast<float*>(smear);
  if (dtype == 0)
    joint_bwd_dh_kernel<<<grid, kThreads, 0, s>>>(
        up, static_cast<const float*>(w), cp, sp, N, Hj, K);
  else if (dtype == 1)
    joint_bwd_dh_tc_kernel<<<grid, kThreads, 0, s>>>(
        up, static_cast<const tc::bf16*>(w), cp, sp, N, Hj, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Pass B, one launch. h [N, Hj] in the compute dtype; u bf16 [N, K]; cs, cl
// [N] fp32; labels [N] int32; dw [Hj, K] and db [K] fp32 (every element
// written).
int joint_bwd_dw(const void* h, const void* u, const void* cs, const void* cl,
                 const void* labels, void* dw, void* db, int N, int Hj, int K, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hj <= 0 || K <= 0) return 0;
  const dim3 grid((Hj + BM - 1) / BM, (K + BN - 1) / BN);
  const auto* up = static_cast<const __nv_bfloat16*>(u);
  const auto* csp = static_cast<const float*>(cs);
  const auto* clp = static_cast<const float*>(cl);
  const auto* lp = static_cast<const int*>(labels);
  auto* dwp = static_cast<float*>(dw);
  auto* dbp = static_cast<float*>(db);
  if (dtype == 0)
    joint_bwd_dw_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), up, csp, clp, lp, dwp, dbp, N, Hj, K);
  else if (dtype == 1)
    joint_bwd_dw_tc_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const tc::bf16*>(h), up, csp, clp, lp, dwp, dbp, N, Hj, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
