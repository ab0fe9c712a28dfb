// The joint's one-call backwards for Hopper (sm_90a): the counterparts of
// the Pallas TPU kernels
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_fused_kernel_u8 (K7-fused-u8):
//     passes A and B over the scaled-int8 slab, dequantised in the kernel;
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_fused_kernel (K6-fused):
//     no slab at all: u = exp(h W + b) is derived again in the backward.
// Each call returns smear [N, Hj], dw [Hj, K] and db [K] (joint_bwd.cuh has
// the formulas; the blank column is the caller's).
//
// What bounds them: K7-fused-u8 is two products of 2 N Hj K operations and
// reads the slab (N K bytes) once in the count, K6-fused three products and
// reads only h, w and b; both are operation-bound.
//
// Design. The TPU kernels keep the whole fp32 dw ([1024, 17408], 71 MB) and
// a smear tile in VMEM across a sequential grid, so one visit to a (rows,
// vocab) tile feeds both sums. An H100 has 227 KB of shared memory per SM:
// smear sums over the vocabulary and dw over the rows, so one of the two has
// to cross blocks. Here each sum keeps a grid of its own, the pass A and
// pass B kernels of joint_bwd.cuh, in which a block owns its output tile
// and loops over the whole contraction: no atomics, deterministic.
// - K7-fused-u8: two launches, pass A and pass B over the whole slab.
// - K6-fused: the rows are walked in chunks that fit a caller-given fp32
//   workspace of fixed size (it does not grow with N). Per chunk: derive
//   u = exp(h W + b) in fp32 into the workspace (one product), pass A over
//   it (u rounded to the weight dtype as it is staged), pass B over it (dz
//   from the fp32 u, then rounded to h's dtype), pass B adding into dw and db
//   in place from the second chunk on. u is parked in fp32, so the roundings
//   are K6's (pallas_joint.py:220-235) and not the bf16-parked rechunked
//   route's; the workspace stays in HBM, 12 bytes moved per element, which
//   is far below the products' time at the WMMA rates of joint_tile.cuh.
//   Three launches per chunk.

#include "joint_bwd.cuh"

namespace {

using namespace joint;

// u[n, k] = exp(h[n] . wt[k] + bias[k]) for a [BM x BN] tile per block.
__global__ void __launch_bounds__(kThreads)
derive_kernel(const float* __restrict__ h,     // [N, Hj]
              const float* __restrict__ wt,    // [K, Hj]
              const float* __restrict__ bias,  // [K]
              float* __restrict__ u,           // [N, K]
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
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < K) u[static_cast<size_t>(row) * K + col] = expf(acc[i][j] + bias[col]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
derive_tc_kernel(const tc::bf16* __restrict__ h,   // [N, Hj]
                 const tc::bf16* __restrict__ wt,  // [K, Hj]
                 const float* __restrict__ bias,   // [K]
                 float* __restrict__ u,            // [N, K]
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
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = n0 + c + q;
      if (col < K) u[static_cast<size_t>(row) * K + col] = expf(v[q] + bias[col]);
    }
  });
}

template <typename T>
int run_fused(const T* h, const T* wt, const T* w, const float* bias, const float* cs,
              const float* cl, const int* labels, float* ws, int ws_rows, float* smear,
              float* dw, float* db, int N, int Hj, int K, int dtype, cudaStream_t s) {
  const SlabF32 src{ws, K};
  for (int r0 = 0; r0 < N; r0 += ws_rows) {
    const int n = ws_rows < N - r0 ? ws_rows : N - r0;
    const T* hc = h + static_cast<size_t>(r0) * Hj;
    const dim3 grid((n + BM - 1) / BM, (K + BN - 1) / BN);
    if constexpr (sizeof(T) == 4)
      derive_kernel<<<grid, kThreads, 0, s>>>(hc, wt, bias, ws, n, Hj, K);
    else
      derive_tc_kernel<<<grid, kThreads, 0, s>>>(hc, wt, bias, ws, n, Hj, K);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    err = launch_dh(src, w, cs + r0, smear + static_cast<size_t>(r0) * Hj, n, Hj, K, dtype, s);
    if (err != 0) return err;
    err = launch_dw(hc, src, cs + r0, cl + r0, labels + r0, dw, db, n, Hj, K, r0 > 0, dtype, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// K7-fused-u8, two launches. h [N, Hj] and w [Hj, K] in the compute dtype
// (0 = float32, 1 = bfloat16); q int8 [N, K]; scales fp32 [ceil(K / kt), N],
// kt a multiple of 8; cs, cl [N] fp32; labels [N] int32; smear [N, Hj],
// dw [Hj, K] and db [K] fp32 (every element written).
int joint_bwd_fused_u8(const void* h, const void* q, const void* scales, const void* w,
                       const void* cs, const void* cl, const void* labels, void* smear,
                       void* dw, void* db, int N, int Hj, int K, int kt, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt <= 0 || kt % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const joint::SlabI8 src{static_cast<const int8_t*>(q), static_cast<const float*>(scales), K,
                          N, kt};
  const auto* csp = static_cast<const float*>(cs);
  int err = joint::launch_dh(src, w, csp, static_cast<float*>(smear), N, Hj, K, dtype, s);
  if (err != 0) return err;
  return joint::launch_dw(h, src, csp, static_cast<const float*>(cl),
                          static_cast<const int*>(labels), static_cast<float*>(dw),
                          static_cast<float*>(db), N, Hj, K, false, dtype, s);
}

// K6-fused, three launches per chunk of ws_rows rows (N >= 1). h [N, Hj],
// wt [K, Hj] and w [Hj, K] in the compute dtype; bias [K], cs, cl [N] fp32;
// labels [N] int32; ws: fp32 workspace [ws_rows, K]; outputs as above.
int joint_bwd_fused(const void* h, const void* wt, const void* w, const void* bias,
                    const void* cs, const void* cl, const void* labels, void* ws, int ws_rows,
                    void* smear, void* dw, void* db, int N, int Hj, int K, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || ws_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bp = static_cast<const float*>(bias);
  const auto* csp = static_cast<const float*>(cs);
  const auto* clp = static_cast<const float*>(cl);
  const auto* lp = static_cast<const int*>(labels);
  auto* wsp = static_cast<float*>(ws);
  auto* sp = static_cast<float*>(smear);
  auto* dwp = static_cast<float*>(dw);
  auto* dbp = static_cast<float*>(db);
  if (dtype == 0)
    return run_fused(static_cast<const float*>(h), static_cast<const float*>(wt),
                     static_cast<const float*>(w), bp, csp, clp, lp, wsp, ws_rows, sp, dwp, dbp,
                     N, Hj, K, dtype, s);
  if (dtype == 1)
    return run_fused(static_cast<const tc::bf16*>(h), static_cast<const tc::bf16*>(wt),
                     static_cast<const tc::bf16*>(w), bp, csp, clp, lp, wsp, ws_rows, sp, dwp,
                     dbp, N, Hj, K, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
