// LSTM forward recurrence for Hopper (sm_90a): the counterpart of the Pallas
// TPU kernels caiman_asr_tpu/ops/pallas_lstm.py::_kernel (K1) and, with the
// kStoreGates flag, ::_kernel_sg (K3a), which also writes the full
// pre-activations gs[t] = gx[t] + h_{t-1} @ w_hh^T in the compute dtype for
// the backward recurrence (pallas_lstm.py:108).
//
// One layer, time-major: for t in [0, T)
//   gates = gx[t] + h_{t-1} @ w_hh^T          (fp32 accumulation)
//   c_t   = sig(f) * c_{t-1} + sig(i) * tnh(g)
//   h_t   = sig(o) * tnh(c_t)
// with gate order i, f, g, o; soft (sigmoid/tanh) or hard (clip(0.5 + z/8,
// 0, 1) / clip(z, -1, 1)) activations. h and c are carried in fp32; h is
// cast to the weight dtype for the product; ys[t] and cs[t] are written in
// the compute dtype (float32 or bfloat16).
//
// Design (simple first): one launch per time step. Each block owns kUnits
// hidden units for all four gates, so the gate math runs in the same block
// as the product with no second pass; the grid's y axis tiles the batch in
// kBatch rows. A block stages h_{t-1} (cast to the weight dtype) in shared
// memory, each warp contracts kRowsPerWarp rows of w_hh (torch's [4H, H]
// layout, so a row is contiguous along the contraction) against every batch
// row with 16-byte loads, reduces across lanes, and one pass of threads
// applies the gate math and writes ys, cs and the next step's fp32 h/c
// (ping-pong buffers). w_hh is re-read from L2/HBM on every step; keeping
// it resident across SMs is the later persistent design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 8;                      // hidden units per block
constexpr int kRows = 4 * kUnits;              // gate rows per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;   // 4
constexpr int kBatch = 16;                     // batch rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T unpacked to float.
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float act_sig(float z, int hard) {
  return hard ? fminf(fmaxf(0.5f + z * 0.125f, 0.0f), 1.0f) : 1.0f / (1.0f + expf(-z));
}
__device__ __forceinline__ float act_tanh(float z, int hard) {
  return hard ? fminf(fmaxf(z, -1.0f), 1.0f) : tanhf(z);
}

__host__ __device__ constexpr size_t h_stage_bytes(int H, size_t esize) {
  return ((static_cast<size_t>(kBatch) * H * esize) + 15) / 16 * 16;
}

template <typename T, bool kStoreGates>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const T* __restrict__ gx,       // [B, 4H] step t
                 const T* __restrict__ w_hh,     // [4H, H]
                 const float* __restrict__ h_in, // [B, H]
                 const float* __restrict__ c_in, // [B, H]
                 float* __restrict__ h_out,      // [B, H]
                 float* __restrict__ c_out,      // [B, H]
                 T* __restrict__ ys,             // [B, H] step t
                 T* __restrict__ cs,             // [B, H] step t
                 T* __restrict__ gs,             // [B, 4H] step t (kStoreGates only)
                 int B, int H, int hard) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* h_s = reinterpret_cast<T*>(smem);                                     // [kBatch, H]
  float* g_s = reinterpret_cast<float*>(smem + h_stage_bytes(H, sizeof(T)));  // [kRows, kBatch]

  const int u0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kBatch;
  const int nb = min(kBatch, B - b0);

  // 1. stage h_{t-1}, cast to the weight dtype; batch rows past B are zero
  for (int i = threadIdx.x; i < kBatch * H; i += kThreads) {
    const int b = i / H;
    const float v = b < nb ? h_in[static_cast<size_t>(b0) * H + i] : 0.0f;
    h_s[i] = from_f32<T>(v);
  }
  __syncthreads();

  // 2. each warp: kRowsPerWarp rows of w_hh against kBatch rows of h
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int N = Pack<T>::N;
  const T* wrow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = warp * kRowsPerWarp + r;          // local gate row
    const int unit = min(u0 + lr % kUnits, H - 1);   // clamped; tail units are not stored
    wrow[r] = w_hh + static_cast<size_t>((lr / kUnits) * H + unit) * H;
  }
  float acc[kRowsPerWarp][kBatch];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < kBatch; ++b) acc[r][b] = 0.0f;

  for (int k = lane * N; k < H; k += 32 * N) {
    float w[kRowsPerWarp][N];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) Pack<T>::load(wrow[r] + k, w[r]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float h[N];
      Pack<T>::load(h_s + b * H + k, h);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int j = 0; j < N; ++j) acc[r][b] = fmaf(w[r][j], h[j], acc[r][b]);
    }
  }

  // 3. reduce across lanes; lane 0 holds the sums
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      acc[r][b] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int b = 0; b < kBatch; ++b) g_s[(warp * kRowsPerWarp + r) * kBatch + b] = acc[r][b];
  }
  __syncthreads();

  // 4. gate math: one thread per (batch row, unit) of the block's tile
  if (threadIdx.x < kUnits * kBatch) {
    const int u = threadIdx.x % kUnits;
    const int b = threadIdx.x / kUnits;
    const int unit = u0 + u;
    if (b < nb && unit < H) {
      const size_t row = static_cast<size_t>(b0 + b);
      const T* gxb = gx + row * 4 * H;
      const float gi = to_f32(gxb[0 * H + unit]) + g_s[(0 * kUnits + u) * kBatch + b];
      const float gf = to_f32(gxb[1 * H + unit]) + g_s[(1 * kUnits + u) * kBatch + b];
      const float gg = to_f32(gxb[2 * H + unit]) + g_s[(2 * kUnits + u) * kBatch + b];
      const float go = to_f32(gxb[3 * H + unit]) + g_s[(3 * kUnits + u) * kBatch + b];
      if (kStoreGates) {
        T* gsb = gs + row * 4 * H;
        gsb[0 * H + unit] = from_f32<T>(gi);
        gsb[1 * H + unit] = from_f32<T>(gf);
        gsb[2 * H + unit] = from_f32<T>(gg);
        gsb[3 * H + unit] = from_f32<T>(go);
      }
      const size_t idx = row * H + unit;
      const float c_new = act_sig(gf, hard) * c_in[idx] + act_sig(gi, hard) * act_tanh(gg, hard);
      const float h_new = act_sig(go, hard) * act_tanh(c_new, hard);
      // 5. outputs in the compute dtype, carry in fp32
      h_out[idx] = h_new;
      c_out[idx] = c_new;
      ys[idx] = from_f32<T>(h_new);
      cs[idx] = from_f32<T>(c_new);
    }
  }
}

template <typename T, bool kStoreGates>
int run(const T* gx, const T* w_hh, float* h_buf, float* c_buf, T* ys, T* cs, T* gs,
        int T_steps, int B, int H, int hard, cudaStream_t stream) {
  const size_t smem = h_stage_bytes(H, sizeof(T)) + sizeof(float) * kRows * kBatch;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_kernel<T, kStoreGates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kBatch - 1) / kBatch);
  const size_t bh = static_cast<size_t>(B) * H;
  for (int t = 0; t < T_steps; ++t) {
    const size_t cur = (t & 1) * bh;
    const size_t nxt = ((t + 1) & 1) * bh;
    lstm_step_kernel<T, kStoreGates><<<grid, kThreads, smem, stream>>>(
        gx + static_cast<size_t>(t) * B * 4 * H, w_hh, h_buf + cur, c_buf + cur,
        h_buf + nxt, c_buf + nxt, ys + static_cast<size_t>(t) * bh,
        cs + static_cast<size_t>(t) * bh,
        kStoreGates ? gs + static_cast<size_t>(t) * B * 4 * H : nullptr, B, H, hard);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kStoreGates>
int dispatch(const void* gx, const void* w_hh, void* h_buf, void* c_buf, void* ys, void* cs,
             void* gs, int T, int B, int H, int hard, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, kStoreGates>(
        static_cast<const float*>(gx), static_cast<const float*>(w_hh),
        static_cast<float*>(h_buf), static_cast<float*>(c_buf), static_cast<float*>(ys),
        static_cast<float*>(cs), static_cast<float*>(gs), T, B, H, hard, s);
  if (dtype == 1)
    return run<__nv_bfloat16, kStoreGates>(
        static_cast<const __nv_bfloat16*>(gx), static_cast<const __nv_bfloat16*>(w_hh),
        static_cast<float*>(h_buf), static_cast<float*>(c_buf),
        static_cast<__nv_bfloat16*>(ys), static_cast<__nv_bfloat16*>(cs),
        static_cast<__nv_bfloat16*>(gs), T, B, H, hard, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory one block needs at width H (dtype 0 = float32, 1 = bfloat16).
size_t lstm_recurrence_fwd_smem_bytes(int H, int dtype) {
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return h_stage_bytes(H, esize) + sizeof(float) * kRows * kBatch;
}

// Runs T steps, one launch each. h_buf/c_buf: [2, B, H] fp32, slot 0 holding
// h0/c0; step t reads slot t%2 and writes slot (t+1)%2. Returns the first
// CUDA error (0 on success).
int lstm_recurrence_fwd(const void* gx, const void* w_hh, void* h_buf, void* c_buf,
                        void* ys, void* cs, int T, int B, int H, int hard, int dtype,
                        void* stream) {
  return dispatch<false>(gx, w_hh, h_buf, c_buf, ys, cs, nullptr, T, B, H, hard, dtype,
                         stream);
}

// The same, also writing gs [T, B, 4H] (K3a, the VJP forward).
int lstm_recurrence_fwd_sg(const void* gx, const void* w_hh, void* h_buf, void* c_buf,
                           void* ys, void* cs, void* gs, int T, int B, int H, int hard,
                           int dtype, void* stream) {
  return dispatch<true>(gx, w_hh, h_buf, c_buf, ys, cs, gs, T, B, H, hard, dtype, stream);
}

const char* caiman_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
