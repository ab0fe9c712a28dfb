// Joint + log-sum-exp forward for Hopper (sm_90a): the counterpart of the
// Pallas TPU kernels caiman_asr_tpu/ops/pallas_joint.py::_fwd_kernel (K2)
// and, with kStoreU, ::_fwd_kernel_store (K5-store).
//
// For every lattice position (row) n:  sums[n] = sum_k exp(h[n] . w_k + b_k)
// with fp32 accumulation and NO max subtraction (the JAX contract,
// pallas_joint.py:41-51: a logit above ~88 overflows to inf, the loss goes
// non-finite and the train step skips the batch). kStoreU also writes
// u = exp(z) to a bf16 [N, K] slab for the backward passes.
//
// What bounds it: 2 N Hj K operations (1.86 TFLOP at the base-85M smoke
// cell, N = 139,360, Hj = 768, K = 8,704); the slab write (N K 2 bytes) is a
// third of a millisecond of HBM time beside that. So it is an
// operation-bound GEMM with an exp epilogue. bf16 inputs run the product on
// the tensor cores (WMMA), fp32 inputs on the CUDA cores (joint_tile.cuh);
// the wgmma + TMA version is a later change.
//
// Design: one block per BM rows, looping over all K in BN-wide tiles (the
// TPU kernel's sequential vocab axis becomes a loop inside the block), so a
// row's sum is finished in one block without atomics. CUDA-core form: each
// thread keeps the partial sums of its 8 rows across tiles, and the 16
// threads sharing a row reduce with shuffles at the end. Tensor-core form:
// each (warp column, row) has one partial-sum slot in shared memory, written
// by one lane only, and the 4 slots of a row are added in a fixed order.

#include "joint_tile.cuh"

namespace {

using namespace joint;

template <bool kStoreU>
__global__ void __launch_bounds__(kThreads)
joint_fwd_kernel(const float* __restrict__ h,    // [N, Hj]
                 const float* __restrict__ wt,   // [K, Hj] (w transposed)
                 const float* __restrict__ bias, // [K]
                 float* __restrict__ sums,       // [N]
                 __nv_bfloat16* __restrict__ u,  // [N, K] (kStoreU only)
                 int N, int Hj, int K) {
  __shared__ Tiles s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  float rsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rsum[i] = 0.0f;

  for (int n0 = 0; n0 < K; n0 += BN) {
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
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col >= K) continue;
        const float e = expf(acc[i][j] + bias[col]);
        if (kStoreU) u[static_cast<size_t>(row) * K + col] = __float2bfloat16_rn(e);
        rsum[i] += e;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = rsum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int row = m0 + ty + 16 * i;
    if (tx == 0 && row < N) sums[row] = v;
  }
}

template <bool kStoreU>
__global__ void __launch_bounds__(kThreads)
joint_fwd_tc_kernel(const tc::bf16* __restrict__ h,   // [N, Hj]
                    const tc::bf16* __restrict__ wt,  // [K, Hj]
                    const float* __restrict__ bias,   // [K]
                    float* __restrict__ sums,         // [N]
                    tc::bf16* __restrict__ u,         // [N, K] (kStoreU only)
                    int N, int Hj, int K) {
  __shared__ tc::Tiles s;
  __shared__ float part[4][BM];  // partial row sums, one slot per warp column
  const int lane = threadIdx.x % 32;
  const int wn = threadIdx.x / 32 % 4;
  const int m0 = blockIdx.x * BM;
  for (int i = threadIdx.x; i < 4 * BM; i += kThreads) part[i / BM][i % BM] = 0.0f;
  for (int n0 = 0; n0 < K; n0 += BN) {
    tc::Acc acc[tc::FM][tc::FN];
    tc::zero(acc);
    tc::mainloop(
        s, acc, Hj,
        [&](tc::Stage& a, int k0) { tc::load_kmajor(a, h, N, Hj, Hj, m0, k0); },
        [&](tc::Stage& b, int k0) { tc::load_kmajor(b, wt, K, Hj, Hj, n0, k0); });
    tc::for_each_fragment(s, acc, [&](int, int r, int c, const float* v) {
      const int row = m0 + r;
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = n0 + c + q;
        if (row < N && col < K) {
          const float e = expf(v[q] + bias[col]);
          if (kStoreU) u[static_cast<size_t>(row) * K + col] = __float2bfloat16_rn(e);
          sum += e;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);  // the row's other lane
      if (lane % 2 == 0) part[wn][r] += sum;
    });
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += kThreads)
    if (m0 + r < N) sums[m0 + r] = ((part[0][r] + part[1][r]) + part[2][r]) + part[3][r];
}

int run(const void* h, const void* wt, const void* bias, void* sums, void* u, int N, int Hj,
        int K, int dtype, cudaStream_t stream) {
  const dim3 grid((N + BM - 1) / BM);
  const float* bp = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(sums);
  auto* up = static_cast<__nv_bfloat16*>(u);
  if (dtype == 0) {
    const auto* hp = static_cast<const float*>(h);
    const auto* wp = static_cast<const float*>(wt);
    if (u != nullptr)
      joint_fwd_kernel<true><<<grid, kThreads, 0, stream>>>(hp, wp, bp, sp, up, N, Hj, K);
    else
      joint_fwd_kernel<false><<<grid, kThreads, 0, stream>>>(hp, wp, bp, sp, nullptr, N, Hj,
                                                             K);
  } else if (dtype == 1) {
    const auto* hp = static_cast<const tc::bf16*>(h);
    const auto* wp = static_cast<const tc::bf16*>(wt);
    if (u != nullptr)
      joint_fwd_tc_kernel<true><<<grid, kThreads, 0, stream>>>(hp, wp, bp, sp, up, N, Hj, K);
    else
      joint_fwd_tc_kernel<false><<<grid, kThreads, 0, stream>>>(hp, wp, bp, sp, nullptr, N, Hj,
                                                                K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch. h [N, Hj] and wt [K, Hj] contiguous in the compute dtype
// (0 = float32, 1 = bfloat16); bias [K] and sums [N] fp32; u: a bf16 [N, K]
// slab to fill (K5-store) or null (K2). Returns the CUDA error (0 on success).
int joint_fwd(const void* h, const void* wt, const void* bias, void* sums, void* u, int N,
              int Hj, int K, int dtype, void* stream) {
  if (N <= 0) return 0;
  return run(h, wt, bias, sums, u, N, Hj, K, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
