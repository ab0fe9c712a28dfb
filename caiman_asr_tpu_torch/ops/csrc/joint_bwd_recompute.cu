// The joint's backwards that keep no [N, K] array for Hopper (sm_90a), each
// pass a call of its own: the counterparts of the Pallas TPU kernels
//   caiman_asr_tpu/ops/pallas_joint.py::_derive_a_kernel (K6-derive-a): for a
//     chunk of rows, u = exp(h W + b) written as a bf16 tile (parked for
//     pass B, K5-B of joint_bwd.cu) and smear = -cs (round_w(u) @ W^T), the
//     rounding to the weight dtype taken from the fp32 u;
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dh_kernel (K4-A) and
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dw_kernel (K4-B): the per-pass
//     recompute over a range of vocab columns. Each derives
//     p = exp(h W + b - denom), the softmax itself, in fp32; pass A is
//     smear = -c (round_w(p) @ W^T), pass B dz = -c p + onehot(label) cl,
//     dw = h^T round_h(dz), db = sum dz, with the unscaled c = cb + cl.
// The formulas of the passes and their design are in joint_bwd.cuh, the
// derivation in joint_derive.cuh. The caller hands over the columns of the
// range as contiguous arrays and the labels relative to its start; a label
// outside the range meets no column.
//
// What bounds them: each is two products of 2 N Hj K operations (the
// derivation and the pass) over h, w and b only, so operation-bound; what
// is parked between the two launches stays in HBM (a bf16 tile the caller
// asked for, or the fp32 workspace: 8 bytes moved per element against
// 4 Hj operations, below the products' time; the derivation and the
// passes run as wgmma).
//
// Design. As K6-fused (joint_bwd_fused.cu): the rows are walked in chunks
// that fit a caller-given fp32 workspace of fixed size, per chunk one
// launch that derives into it and one launch of the pass over it, pass B
// adding into dw and db in place from the second chunk on. Parking in fp32
// keeps the TPU kernels' roundings: pass A rounds the fp32 value to the
// weight dtype as it is staged, pass B builds dz from the fp32 value.
// K6-derive-a with bf16 weights needs no workspace: round_w(u) is the bf16
// tile it writes, so pass A reads that tile (two launches in all); with
// fp32 weights pass A must see the fp32 u, so the derivation writes both
// the workspace and the tile.

#include "joint_bwd.cuh"
#include "joint_derive.cuh"

namespace {

using namespace joint;

inline const void* rows_from(const void* p, int r0, int Hj, int dtype) {
  return static_cast<const char*>(p) + static_cast<size_t>(r0) * Hj * (dtype == 0 ? 4 : 2);
}

}  // namespace

extern "C" {

// K6-derive-a (N >= 1). h [N, Hj], wt [K, Hj] and w [Hj, K] in the compute
// dtype (0 = float32, 1 = bfloat16); bias [K] and cs [N] fp32; u: the bf16
// tile [N, K] to fill; ws: fp32 workspace [ws_rows, K] (float32 only; unused
// and may be null for bfloat16); smear [N, Hj] fp32. Two launches per chunk
// of ws_rows rows in float32, two in all in bfloat16.
int joint_derive_a(const void* h, const void* wt, const void* w, const void* bias,
                   const void* cs, void* u, void* ws, int ws_rows, void* smear, int N, int Hj,
                   int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bp = static_cast<const float*>(bias);
  const auto* csp = static_cast<const float*>(cs);
  auto* up = static_cast<__nv_bfloat16*>(u);
  auto* sp = static_cast<float*>(smear);
  if (dtype == 1) {
    int err = launch_derive(h, wt, bp, nullptr, nullptr, up, N, Hj, K, dtype, s);
    if (err != 0) return err;
    return launch_dh(SlabBf16{up, K}, w, csp, sp, N, Hj, K, dtype, s);
  }
  if (ws == nullptr || ws_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* wsp = static_cast<float*>(ws);
  for (int r0 = 0; r0 < N; r0 += ws_rows) {
    const int n = ws_rows < N - r0 ? ws_rows : N - r0;
    int err = launch_derive(rows_from(h, r0, Hj, dtype), wt, bp, nullptr, wsp,
                            up + static_cast<size_t>(r0) * K, n, Hj, K, dtype, s);
    if (err != 0) return err;
    err = launch_dh(SlabF32{wsp, K}, w, csp + r0, sp + static_cast<size_t>(r0) * Hj, n, Hj, K,
                    dtype, s);
    if (err != 0) return err;
  }
  return 0;
}

// K4-A (N >= 1), two launches per chunk of ws_rows rows. h [N, Hj], wt
// [K, Hj] and w [Hj, K] in the compute dtype; bias [K], denom [N] (the
// row's log-sum-exp over the whole vocabulary) and c [N] (cb + cl) fp32;
// ws: fp32 workspace [ws_rows, K]; smear [N, Hj] fp32.
int joint_bwd_dh_recompute(const void* h, const void* wt, const void* w, const void* bias,
                           const void* denom, const void* c, void* ws, int ws_rows,
                           void* smear, int N, int Hj, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || ws_rows <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wsp = static_cast<float*>(ws);
  for (int r0 = 0; r0 < N; r0 += ws_rows) {
    const int n = ws_rows < N - r0 ? ws_rows : N - r0;
    int err = launch_derive(rows_from(h, r0, Hj, dtype), wt, static_cast<const float*>(bias),
                            static_cast<const float*>(denom) + r0, wsp, nullptr, n, Hj, K,
                            dtype, s);
    if (err != 0) return err;
    err = launch_dh(SlabF32{wsp, K}, w, static_cast<const float*>(c) + r0,
                    static_cast<float*>(smear) + static_cast<size_t>(r0) * Hj, n, Hj, K, dtype,
                    s);
    if (err != 0) return err;
  }
  return 0;
}

// K4-B (N >= 1), two launches per chunk of ws_rows rows. As K4-A, with cl
// [N] fp32 and labels [N] int32 (relative to the first column; outside
// [0, K) meets no column); dw [Hj, K] and db [K] fp32, every element
// written.
int joint_bwd_dw_recompute(const void* h, const void* wt, const void* bias, const void* denom,
                           const void* c, const void* cl, const void* labels, void* ws,
                           int ws_rows, void* dw, void* db, int N, int Hj, int K, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || ws_rows <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wsp = static_cast<float*>(ws);
  for (int r0 = 0; r0 < N; r0 += ws_rows) {
    const int n = ws_rows < N - r0 ? ws_rows : N - r0;
    const void* hc = rows_from(h, r0, Hj, dtype);
    int err = launch_derive(hc, wt, static_cast<const float*>(bias),
                            static_cast<const float*>(denom) + r0, wsp, nullptr, n, Hj, K,
                            dtype, s);
    if (err != 0) return err;
    err = launch_dw(hc, SlabF32{wsp, K}, static_cast<const float*>(c) + r0,
                    static_cast<const float*>(cl) + r0, static_cast<const int*>(labels) + r0,
                    static_cast<float*>(dw), static_cast<float*>(db), n, Hj, K, r0 > 0, dtype,
                    s);
    if (err != 0) return err;
  }
  return 0;
}

// The derivation alone, one launch (N >= 0): out32 fp32 and / or out16
// bf16 [N, K] (either may be null) = exp(h wt^T + bias - shift), shift [N]
// or null; h [N, Hj] and wt [K, Hj] in the compute dtype. The routes above
// reach it through their chunks; this entry serves tests and timing.
int joint_derive(const void* h, const void* wt, const void* bias, const void* shift, void* out32,
                 void* out16, int N, int Hj, int K, int dtype, void* stream) {
  if (out32 == nullptr && out16 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_derive(h, wt, static_cast<const float*>(bias),
                       static_cast<const float*>(shift), static_cast<float*>(out32),
                       static_cast<__nv_bfloat16*>(out16), N, Hj, K, dtype,
                       static_cast<cudaStream_t>(stream));
}

// The bf16 derivation's plan, for the logs: out[0..6] = how h and wt are
// staged (joint_sm90.cuh's Staging: 0 TMA, 8 or 4 cp.async bytes, 2 or 1
// element copies), row tiles, vocab tiles (the tiles' order: vocab tiles
// fastest), blocks of the persistent grid, ring stages and dynamic shared
// memory bytes.
int joint_derive_plan(const void* h, const void* wt, int N, int Hj, int K, int* out) {
  if (N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  derive::Plan pl;
  const int err =
      derive::plan(derive::params(h, wt, nullptr, nullptr, nullptr, nullptr, N, Hj, K), &pl);
  if (err != 0) return err;
  const int v[7] = {pl.h_mode, pl.w_mode, pl.tiles_rows, pl.tiles_k, pl.blocks, pl.stages,
                    pl.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
