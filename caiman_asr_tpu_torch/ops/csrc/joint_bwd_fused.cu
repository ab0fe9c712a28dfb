// The joint's one-call backwards for Hopper (sm_90a): the counterparts of
// the Pallas TPU kernels
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_fused_kernel_u (K5-fused-u):
//     passes A and B over the stored bf16 slab;
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_fused_kernel_u8 (K7-fused-u8):
//     passes A and B over the scaled-int8 slab, dequantised in the kernel;
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_fused_kernel (K6-fused):
//     no slab at all: u = exp(h W + b) is derived again in the backward.
// Each call returns smear [N, Hj], dw [Hj, K] and db [K] (joint_bwd.cuh has
// the formulas; the blank column is the caller's).
//
// What bounds them: K5-fused-u and K7-fused-u8 are two products of
// 2 N Hj K operations and read the slab (2 N K or N K bytes) once in the
// count, K6-fused three products and reads only h, w and b; all are
// operation-bound.
//
// Design. The TPU kernels keep the whole fp32 dw ([1024, 17408], 71 MB) and
// a smear tile in VMEM across a sequential grid, so one visit to a (rows,
// vocab) tile feeds both sums. An H100 has 227 KB of shared memory per SM:
// smear sums over the vocabulary and dw over the rows, so one of the two has
// to cross blocks. Here each sum keeps a grid of its own, the pass A and
// pass B kernels of joint_bwd.cuh, in which a block owns its output tile
// and loops over the whole contraction: no atomics, deterministic.
// - K5-fused-u, K7-fused-u8: two launches, pass A and pass B over the whole
//   slab (the slab is read once per pass: reading it once per visit, as the
//   TPU kernels do, needs the cross-block sum above).
// - K6-fused: the rows are walked in chunks that fit a caller-given fp32
//   workspace of fixed size (it does not grow with N). Per chunk: derive
//   u = exp(h W + b) in fp32 into the workspace (one product), pass A over
//   it (u rounded to the weight dtype as it is staged), pass B over it (dz
//   from the fp32 u, then rounded to h's dtype), pass B adding into dw and db
//   in place from the second chunk on. u is parked in fp32, so the roundings
//   are K6's (pallas_joint.py:220-235) and not the bf16-parked rechunked
//   route's; the workspace stays in HBM, 12 bytes moved per element against
//   6 Hj operations, below the products' time (the derivation and the
//   passes as wgmma).
//   Three launches per chunk.

#include "joint_bwd.cuh"
#include "joint_derive.cuh"

extern "C" {

// K5-fused-u, two launches. h [N, Hj] and w [Hj, K] in the compute dtype
// (0 = float32, 1 = bfloat16); u bf16 [N, K]; cs, cl [N] fp32; labels [N]
// int32; smear [N, Hj], dw [Hj, K] and db [K] fp32 (every element written).
int joint_bwd_fused_u(const void* h, const void* u, const void* w, const void* cs,
                      const void* cl, const void* labels, void* smear, void* dw, void* db,
                      int N, int Hj, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const joint::SlabBf16 src{static_cast<const __nv_bfloat16*>(u), K};
  const auto* csp = static_cast<const float*>(cs);
  int err = joint::launch_dh(src, w, csp, static_cast<float*>(smear), N, Hj, K, dtype, s);
  if (err != 0) return err;
  return joint::launch_dw(h, src, csp, static_cast<const float*>(cl),
                          static_cast<const int*>(labels), static_cast<float*>(dw),
                          static_cast<float*>(db), N, Hj, K, false, dtype, s);
}

// K7-fused-u8, two launches. As above, with q int8 [N, K] and scales fp32
// [ceil(K / kt), N], kt a multiple of 8, in place of u.
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
  using namespace joint;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || ws_rows <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* csp = static_cast<const float*>(cs);
  const auto* clp = static_cast<const float*>(cl);
  const auto* lp = static_cast<const int*>(labels);
  auto* wsp = static_cast<float*>(ws);
  const size_t h_row = static_cast<size_t>(Hj) * (dtype == 0 ? 4 : 2);  // bytes
  const SlabF32 src{wsp, K};
  for (int r0 = 0; r0 < N; r0 += ws_rows) {
    const int n = ws_rows < N - r0 ? ws_rows : N - r0;
    const void* hc = static_cast<const char*>(h) + r0 * h_row;
    int err = launch_derive(hc, wt, static_cast<const float*>(bias), nullptr, wsp, nullptr, n,
                            Hj, K, dtype, s);
    if (err != 0) return err;
    err = launch_dh(src, w, csp + r0, static_cast<float*>(smear) + static_cast<size_t>(r0) * Hj,
                    n, Hj, K, dtype, s);
    if (err != 0) return err;
    err = launch_dw(hc, src, csp + r0, clp + r0, lp + r0, static_cast<float*>(dw),
                    static_cast<float*>(db), n, Hj, K, r0 > 0, dtype, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
