// Joint + log-sum-exp forward for Hopper (sm_90a): the counterpart of the
// Pallas TPU kernels caiman_asr_tpu/ops/pallas_joint.py::_fwd_kernel (K2),
// with kStore == kBf16 ::_fwd_kernel_store (K5-store) and with
// kStore == kInt8 ::_fwd_kernel_store8 (K7-store8).
//
// For every lattice position (row) n:  sums[n] = sum_k exp(h[n] . w_k + b_k)
// with fp32 accumulation and NO max subtraction (the JAX contract,
// pallas_joint.py:41-51: a logit above ~88 overflows to inf, the loss goes
// non-finite and the train step skips the batch). kBf16 also writes
// u = exp(z) to a bf16 [N, K] slab for the backward passes. kInt8 writes it
// as scaled int8: per row and per kt-wide vocab tile, m = max u, the scale
// m / 127 goes to scales[tile, row] and q = round_to_nearest_even(u * (127 /
// m)) to the int8 [N, K] slab (m == 0 gives scale 0 and q 0); the sums use
// the unquantised fp32 u (pallas_joint.py:131-137).
//
// What bounds it: 2 N Hj K operations (1.86 TFLOP at the base-85M smoke
// cell, N = 139,360, Hj = 768, K = 8,704); the slab write (N K 2 bytes, or
// N K) is a third of a millisecond of HBM time beside that. So it is an
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
// kInt8: a row's maximum over a scale tile (2,048 columns at large-196M,
// 16 BN-wide tiles) must be known before any of it is quantised, and 128
// rows of it in fp32 (1 MB) do not fit in shared memory. So the block
// walks each scale tile twice: first for the maxima (kept as the sums are),
// then again, computing the same z bit for bit, to quantise and to sum. The
// product is done twice; the slab is written once and never read back.

#include <stdint.h>

#include "joint_tile.cuh"

namespace {

using namespace joint;

enum Store { kNone = 0, kBf16 = 1, kInt8 = 2 };

__device__ __forceinline__ float inv_scale(float m) { return m > 0.0f ? 127.0f / m : 0.0f; }
__device__ __forceinline__ int8_t quantise(float e, float inv) {
  return static_cast<int8_t>(__float2int_rn(e * inv));
}

template <int kStore>
__global__ void __launch_bounds__(kThreads)
joint_fwd_kernel(const float* __restrict__ h,    // [N, Hj]
                 const float* __restrict__ wt,   // [K, Hj] (w transposed)
                 const float* __restrict__ bias, // [K]
                 float* __restrict__ sums,       // [N]
                 void* __restrict__ slab,        // [N, K] bf16 (kBf16) or int8 (kInt8)
                 float* __restrict__ scales,     // [ceil(K / kt), N] (kInt8 only)
                 int N, int Hj, int K, int kt) {
  __shared__ Tiles s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  auto product = [&](float (&acc)[TM][TN], int n0) {
    zero(acc);
    mainloop(
        s, acc, Hj,
        [&](Tile& a, int k0) { load_kmajor(a, h, N, Hj, Hj, m0, k0); },
        [&](Tile& b, int k0) { load_kmajor(b, wt, K, Hj, Hj, n0, k0); });
  };
  float rsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rsum[i] = 0.0f;

  // one span for K2 / K5-store; one per scale tile (a multiple of BN) for kInt8
  const int span = kStore == kInt8 ? kt : K;
  for (int s0 = 0; s0 < K; s0 += span) {
    const int s1 = min(K, s0 + span);
    float inv[TM];
    if constexpr (kStore == kInt8) {
      float rmax[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) rmax[i] = 0.0f;
      for (int n0 = s0; n0 < s1; n0 += BN) {
        float acc[TM][TN];
        product(acc, n0);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col >= s1) continue;
#pragma unroll
          for (int i = 0; i < TM; ++i) rmax[i] = fmaxf(rmax[i], expf(acc[i][j] + bias[col]));
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float m = rmax[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        inv[i] = inv_scale(m);
        const int row = m0 + ty + 16 * i;
        if (tx == 0 && row < N)
          scales[static_cast<size_t>(s0 / kt) * N + row] = m * (1.0f / 127.0f);
      }
    }
    for (int n0 = s0; n0 < s1; n0 += BN) {
      float acc[TM][TN];
      product(acc, n0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row >= N) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col >= s1) continue;
          const float e = expf(acc[i][j] + bias[col]);
          const size_t at = static_cast<size_t>(row) * K + col;
          if constexpr (kStore == kBf16)
            static_cast<__nv_bfloat16*>(slab)[at] = __float2bfloat16_rn(e);
          if constexpr (kStore == kInt8) static_cast<int8_t*>(slab)[at] = quantise(e, inv[i]);
          rsum[i] += e;
        }
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

template <int kStore>
__global__ void __launch_bounds__(kThreads)
joint_fwd_tc_kernel(const tc::bf16* __restrict__ h,   // [N, Hj]
                    const tc::bf16* __restrict__ wt,  // [K, Hj]
                    const float* __restrict__ bias,   // [K]
                    float* __restrict__ sums,         // [N]
                    void* __restrict__ slab,          // [N, K] bf16 (kBf16) or int8 (kInt8)
                    float* __restrict__ scales,       // [ceil(K / kt), N] (kInt8 only)
                    int N, int Hj, int K, int kt) {
  __shared__ tc::Tiles s;
  __shared__ float part[4][BM];  // partial row sums, one slot per warp column
  __shared__ float pmax[4][BM];  // partial row maxima of the scale tile (kInt8)
  const int lane = threadIdx.x % 32;
  const int wn = threadIdx.x / 32 % 4;
  const int m0 = blockIdx.x * BM;
  auto product = [&](tc::Acc (&acc)[tc::FM][tc::FN], int n0) {
    tc::zero(acc);
    tc::mainloop(
        s, acc, Hj,
        [&](tc::Stage& a, int k0) { tc::load_kmajor(a, h, N, Hj, Hj, m0, k0); },
        [&](tc::Stage& b, int k0) { tc::load_kmajor(b, wt, K, Hj, Hj, n0, k0); });
  };
  auto row_max = [&](int r) {
    return fmaxf(fmaxf(pmax[0][r], pmax[1][r]), fmaxf(pmax[2][r], pmax[3][r]));
  };
  for (int i = threadIdx.x; i < 4 * BM; i += kThreads) part[i / BM][i % BM] = 0.0f;
  const bool vec8 = (reinterpret_cast<size_t>(slab) | static_cast<size_t>(K)) % 8 == 0;

  const int span = kStore == kInt8 ? kt : K;
  for (int s0 = 0; s0 < K; s0 += span) {
    const int s1 = min(K, s0 + span);
    if constexpr (kStore == kInt8) {
      __syncthreads();  // the previous scale tile's maxima have been read
      for (int i = threadIdx.x; i < 4 * BM; i += kThreads) pmax[i / BM][i % BM] = 0.0f;
      for (int n0 = s0; n0 < s1; n0 += BN) {
        tc::Acc acc[tc::FM][tc::FN];
        product(acc, n0);  // its barriers also order the reset above before the writes below
        tc::for_each_fragment(s, acc, [&](int, int r, int c, const float* v) {
          float m = 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int col = n0 + c + q;
            if (col < s1) m = fmaxf(m, expf(v[q] + bias[col]));
          }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the row's other lane
          if (lane % 2 == 0) pmax[wn][r] = fmaxf(pmax[wn][r], m);
        });
      }
      __syncthreads();
      for (int r = threadIdx.x; r < BM; r += kThreads)
        if (m0 + r < N)
          scales[static_cast<size_t>(s0 / kt) * N + m0 + r] = row_max(r) * (1.0f / 127.0f);
    }
    for (int n0 = s0; n0 < s1; n0 += BN) {
      tc::Acc acc[tc::FM][tc::FN];
      product(acc, n0);
      tc::for_each_fragment(s, acc, [&](int, int r, int c, const float* v) {
        const int row = m0 + r;
        const float inv = kStore == kInt8 ? inv_scale(row_max(r)) : 0.0f;
        float sum = 0.0f;
        alignas(8) int8_t qv[8] = {};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = n0 + c + q;
          if (row < N && col < s1) {
            const float e = expf(v[q] + bias[col]);
            if constexpr (kStore == kBf16)
              static_cast<tc::bf16*>(slab)[static_cast<size_t>(row) * K + col] =
                  __float2bfloat16_rn(e);
            if constexpr (kStore == kInt8) qv[q] = quantise(e, inv);
            sum += e;
          }
        }
        if constexpr (kStore == kInt8) {
          if (row < N) {
            int8_t* out = static_cast<int8_t*>(slab) + static_cast<size_t>(row) * K + n0 + c;
            if (vec8 && n0 + c + 8 <= s1) {
              *reinterpret_cast<int2*>(out) = *reinterpret_cast<const int2*>(qv);
            } else {
#pragma unroll
              for (int q = 0; q < 8; ++q)
                if (n0 + c + q < s1) out[q] = qv[q];
            }
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);  // the row's other lane
        if (lane % 2 == 0) part[wn][r] += sum;
      });
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += kThreads)
    if (m0 + r < N) sums[m0 + r] = ((part[0][r] + part[1][r]) + part[2][r]) + part[3][r];
}

template <int kStore>
int run(const void* h, const void* wt, const void* bias, void* sums, void* slab, void* scales,
        int N, int Hj, int K, int kt, int dtype, cudaStream_t stream) {
  const dim3 grid((N + BM - 1) / BM);
  const float* bp = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(sums);
  float* sc = static_cast<float*>(scales);
  if (dtype == 0)
    joint_fwd_kernel<kStore><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(h), static_cast<const float*>(wt), bp, sp, slab, sc, N, Hj,
        K, kt);
  else if (dtype == 1)
    joint_fwd_tc_kernel<kStore><<<grid, kThreads, 0, stream>>>(
        static_cast<const tc::bf16*>(h), static_cast<const tc::bf16*>(wt), bp, sp, slab, sc, N,
        Hj, K, kt);
  else
    return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u != nullptr) return run<kBf16>(h, wt, bias, sums, u, nullptr, N, Hj, K, 0, dtype, s);
  return run<kNone>(h, wt, bias, sums, nullptr, nullptr, N, Hj, K, 0, dtype, s);
}

// One launch (K7-store8). As joint_fwd, filling q int8 [N, K] and scales
// fp32 [ceil(K / kt), N]; kt, the scale tile's width, a multiple of 128.
int joint_fwd_store8(const void* h, const void* wt, const void* bias, void* sums, void* q,
                     void* scales, int N, int Hj, int K, int kt, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (kt <= 0 || kt % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  return run<kInt8>(h, wt, bias, sums, q, scales, N, Hj, K, kt, dtype,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
