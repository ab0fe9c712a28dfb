// Joint backward over a stored u = exp(z) slab for Hopper (sm_90a), each
// pass a call of its own: the counterparts of the Pallas TPU kernels
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dh_kernel_u (K5-A, pass A) and
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dw_kernel_u (K5-B, pass B)
// over the bf16 slab, and
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dh_kernel_u8 (K7-A8) and
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dw_kernel_u8 (K7-B8)
// over the scaled-int8 slab. The passes themselves, and their design, are
// in joint_bwd.cuh; this file instantiates them for the two slabs.
//
// What bounds them: each pass is 2 N Hj K operations (as the forward) and
// reads the slab once (N K 2 bytes, or N K), so all are operation-bound
// GEMMs. With bf16 inputs both run as wgmma behind asynchronous staging:
// pass A (K5-A, K7-A8) as joint_bwd.cuh's passa, pass B (K5-B, K7-B8) as
// its passb; fp32 inputs run on the CUDA cores (joint_tile.cuh).

#include "joint_bwd.cuh"

namespace {

joint::SlabI8 slab_i8(const void* q, const void* scales, int N, int K, int kt) {
  return {static_cast<const int8_t*>(q), static_cast<const float*>(scales), K, N, kt};
}

}  // namespace

extern "C" {

// K5-A, one launch. u bf16 [N, K]; w [Hj, K] in the compute dtype
// (0 = float32, 1 = bfloat16); cs [N] and smear [N, Hj] fp32.
int joint_bwd_dh(const void* u, const void* w, const void* cs, void* smear, int N, int Hj,
                 int K, int dtype, void* stream) {
  const joint::SlabBf16 src{static_cast<const __nv_bfloat16*>(u), K};
  return joint::launch_dh(src, w, static_cast<const float*>(cs), static_cast<float*>(smear),
                          N, Hj, K, dtype, static_cast<cudaStream_t>(stream));
}

// K5-B, one launch. h [N, Hj] in the compute dtype; u bf16 [N, K]; cs, cl
// [N] fp32; labels [N] int32; dw [Hj, K] and db [K] fp32: every element
// written, or with accumulate != 0 added to (a caller walking the rows in
// chunks).
int joint_bwd_dw(const void* h, const void* u, const void* cs, const void* cl,
                 const void* labels, void* dw, void* db, int N, int Hj, int K, int accumulate,
                 int dtype, void* stream) {
  const joint::SlabBf16 src{static_cast<const __nv_bfloat16*>(u), K};
  return joint::launch_dw(h, src, static_cast<const float*>(cs), static_cast<const float*>(cl),
                          static_cast<const int*>(labels), static_cast<float*>(dw),
                          static_cast<float*>(db), N, Hj, K, accumulate != 0, dtype,
                          static_cast<cudaStream_t>(stream));
}

// K7-A8, one launch. q int8 [N, K]; scales fp32 [ceil(K / kt), N], kt a
// multiple of 8; the rest as K5-A. The dequantised u is rounded to bf16 for
// the product whatever the weight dtype (pallas_joint.py:396-398).
int joint_bwd_dh_u8(const void* q, const void* scales, const void* w, const void* cs,
                    void* smear, int N, int Hj, int K, int kt, int dtype, void* stream) {
  if (kt <= 0 || kt % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return joint::launch_dh(slab_i8(q, scales, N, K, kt), w, static_cast<const float*>(cs),
                          static_cast<float*>(smear), N, Hj, K, dtype,
                          static_cast<cudaStream_t>(stream));
}

// K7-B8, one launch. The slab as K7-A8, the rest as K5-B (every element of
// dw and db written); dz is built from the unrounded q * scale.
int joint_bwd_dw_u8(const void* h, const void* q, const void* scales, const void* cs,
                    const void* cl, const void* labels, void* dw, void* db, int N, int Hj,
                    int K, int kt, int dtype, void* stream) {
  if (kt <= 0 || kt % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return joint::launch_dw(h, slab_i8(q, scales, N, K, kt), static_cast<const float*>(cs),
                          static_cast<const float*>(cl), static_cast<const int*>(labels),
                          static_cast<float*>(dw), static_cast<float*>(db), N, Hj, K, false,
                          dtype, static_cast<cudaStream_t>(stream));
}

// The bf16 pass B's plan for these operands, for the logs: out[0..5] =
// how h and u are staged (joint_sm90.cuh's Staging: 0 TMA, 8 or 4 cp.async
// bytes, 2 or 1 element copies), Hj tiles, vocab tiles, ring stages and
// dynamic shared memory bytes. u_bytes: 2 the bf16 slab, 1 the int8 slab,
// 4 an fp32 workspace.
int joint_bwd_dw_plan(const void* h, const void* u, int N, int Hj, int K, int u_bytes,
                      int* out) {
  joint::passb::Plan pl;
  if (u_bytes == 2)
    pl = joint::passb::plan(h, joint::SlabBf16{static_cast<const __nv_bfloat16*>(u), K}, N, Hj, K);
  else if (u_bytes == 1)
    pl = joint::passb::plan(h, slab_i8(u, nullptr, N, K, 8), N, Hj, K);
  else if (u_bytes == 4)
    pl = joint::passb::plan(h, joint::SlabF32{static_cast<const float*>(u), K}, N, Hj, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const int v[6] = {pl.h_mode, pl.u_mode, pl.tiles_hj, pl.tiles_k, pl.stages, pl.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// The bf16 pass A's plan, for the logs: out[0..5] = how u and w are staged
// (as above), row tiles, Hj tiles (the grid is their product, Hj tiles
// fastest), ring stages and dynamic shared memory bytes. u_bytes as above.
int joint_bwd_dh_plan(const void* u, const void* w, int N, int Hj, int K, int u_bytes,
                      int* out) {
  joint::passa::Plan pl;
  if (u_bytes == 2)
    pl = joint::passa::plan(joint::SlabBf16{static_cast<const __nv_bfloat16*>(u), K}, w, N, Hj, K);
  else if (u_bytes == 1)
    pl = joint::passa::plan(slab_i8(u, nullptr, N, K, 8), w, N, Hj, K);
  else if (u_bytes == 4)
    pl = joint::passa::plan(joint::SlabF32{static_cast<const float*>(u), K}, w, N, Hj, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const int v[6] = {pl.u_mode, pl.w_mode, pl.tiles_rows, pl.tiles_hj, pl.stages, pl.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
