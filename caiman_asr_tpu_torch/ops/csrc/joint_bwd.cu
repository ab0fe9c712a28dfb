// Joint backward over the stored bf16 u = exp(z) slab for Hopper (sm_90a):
// the counterparts of the Pallas TPU kernels
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dh_kernel_u (K5-A, pass A) and
//   caiman_asr_tpu/ops/pallas_joint.py::_bwd_dw_kernel_u (K5-B, pass B).
// The passes themselves, and their design, are in joint_bwd.cuh; this file
// instantiates them for the bf16 slab.
//
// What bounds them: each pass is 2 N Hj K operations (as the forward) and
// reads the slab once (N K 2 bytes), so both are operation-bound GEMMs.
// bf16 inputs run them on the tensor cores (WMMA), fp32 inputs on the CUDA
// cores (joint_tile.cuh).

#include "joint_bwd.cuh"

extern "C" {

// Pass A, one launch. u bf16 [N, K]; w [Hj, K] in the compute dtype
// (0 = float32, 1 = bfloat16); cs [N] and smear [N, Hj] fp32.
int joint_bwd_dh(const void* u, const void* w, const void* cs, void* smear, int N, int Hj,
                 int K, int dtype, void* stream) {
  const joint::SlabBf16 src{static_cast<const __nv_bfloat16*>(u), K};
  return joint::launch_dh(src, w, static_cast<const float*>(cs), static_cast<float*>(smear),
                          N, Hj, K, dtype, static_cast<cudaStream_t>(stream));
}

// Pass B, one launch. h [N, Hj] in the compute dtype; u bf16 [N, K]; cs, cl
// [N] fp32; labels [N] int32; dw [Hj, K] and db [K] fp32 (every element
// written).
int joint_bwd_dw(const void* h, const void* u, const void* cs, const void* cl,
                 const void* labels, void* dw, void* db, int N, int Hj, int K, int dtype,
                 void* stream) {
  const joint::SlabBf16 src{static_cast<const __nv_bfloat16*>(u), K};
  return joint::launch_dw(h, src, static_cast<const float*>(cs), static_cast<const float*>(cl),
                          static_cast<const int*>(labels), static_cast<float*>(dw),
                          static_cast<float*>(db), N, Hj, K, false, dtype,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
