// LSTM backward recurrence for Hopper (sm_90a): the counterpart of the Pallas
// TPU kernel caiman_asr_tpu/ops/pallas_lstm.py::_bwd_kernel (K3b).
//
// One layer, reverse time: for t = T-1 .. 0
//   dh      = dy[t] + dgates[t+1] @ w_hh      (dgates[T] = 0; fp32 accumulation)
//   dc      = dc_{t+1} + dcs[t] + dh * o * tnh'(c_t)
//   dgates[t] = [dc*g*i', dc*c_{t-1}*f', dc*i*g', dh*tnh(c_t)*o']  (compute dtype)
//   dc_t    = dc * f
// and finally dh0 = dgates[0] @ w_hh, dc0 = dc_0. Gate order i, f, g, o; the
// activations are recomputed from the stored pre-activations gates[t] (soft
// sigmoid/tanh, or the hard clip windows of pallas_lstm.py:215-223). dh and
// dc are carried in fp32; dgates is written in the compute dtype, and that
// rounded value is what the next step's product reads (the Pallas kernel
// rounds dgates to the weight dtype before its dot, which is the same dtype).
//
// Design (simple first, the mirror of the forward kernel): one launch per
// reverse step plus one for dh0, T+1 launches per layer. Each block owns
// kUnits hidden units and kBatch batch rows. It first contracts
// dgates[t+1] (all 4H columns, written by the previous launch and staged in
// shared memory in chunks, 16 bytes per copy) with its units' rows of
// w_hh^T ([H, 4H], so a unit's contraction is contiguous), one warp per
// unit, and then runs the gate backward for its units with dc in fp32
// ping-pong buffers. w_hh is re-read from L2/HBM every step; the bound and
// the persistent design are as for the forward kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 8;          // hidden units per block, one warp each
constexpr int kWarps = kUnits;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;         // batch rows per block
constexpr int kChunk = 1024;       // dgates columns staged per pass

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

__host__ __device__ constexpr size_t stage_bytes(size_t esize) {
  return (static_cast<size_t>(kBatch) * kChunk * esize + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const T* __restrict__ dg_next,  // [B, 4H] step t+1, or null at t = T-1
                     const T* __restrict__ w_t,      // [H, 4H] = w_hh^T
                     const T* __restrict__ gates,    // [B, 4H] step t pre-activations
                     const T* __restrict__ c_prev,   // [B, H] c_{t-1}
                     const T* __restrict__ cs,       // [B, H] c_t
                     const T* __restrict__ dy,       // [B, H]
                     const T* __restrict__ dcs,      // [B, H]
                     const float* __restrict__ dc_in,  // [B, H] fp32 carry from t+1
                     float* __restrict__ dc_out,       // [B, H] fp32 carry to t-1
                     T* __restrict__ dg,               // [B, 4H] step t
                     float* __restrict__ dh0,          // [B, H]: set only for the last launch
                     int B, int H, int hard) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* g_s = reinterpret_cast<T*>(smem);                                  // [kBatch, kChunk]
  float* dh_s = reinterpret_cast<float*>(smem + stage_bytes(sizeof(T)));  // [kUnits, kBatch]

  const int H4 = 4 * H;
  const int u0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kBatch;
  const int nb = min(kBatch, B - b0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // 1. dh_next for this block's units: dgates[t+1] @ w_hh, one warp per unit
  float acc[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) acc[b] = 0.0f;
  if (dg_next != nullptr) {
    constexpr int N = Pack<T>::N;
    const T* wrow = w_t + static_cast<size_t>(min(u0 + warp, H - 1)) * H4;
    for (int k0 = 0; k0 < H4; k0 += kChunk) {
      const int kc = min(kChunk, H4 - k0);
      __syncthreads();  // the previous chunk has been read
      // 16-byte copies: 4H is a multiple of 32, so kc is a multiple of N
      for (int i = threadIdx.x; i < kBatch * (kc / N); i += kThreads) {
        const int b = i / (kc / N);
        const int k = N * (i % (kc / N));
        *reinterpret_cast<uint4*>(g_s + b * kChunk + k) =
            b < nb ? *reinterpret_cast<const uint4*>(
                         dg_next + static_cast<size_t>(b0 + b) * H4 + k0 + k)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      for (int k = lane * N; k < kc; k += 32 * N) {
        float w[N];
        Pack<T>::load(wrow + k0 + k, w);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          float g[N];
          Pack<T>::load(g_s + b * kChunk + k, g);
#pragma unroll
          for (int j = 0; j < N; ++j) acc[b] = fmaf(w[j], g[j], acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float v = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      acc[b] = v;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) dh_s[warp * kBatch + b] = acc[b];
  }
  __syncthreads();

  // 2. one thread per (batch row, unit) of the block's tile
  if (threadIdx.x >= kUnits * kBatch) return;
  const int u = threadIdx.x % kUnits;
  const int b = threadIdx.x / kUnits;
  const int unit = u0 + u;
  if (b >= nb || unit >= H) return;
  const size_t row = static_cast<size_t>(b0 + b);
  const size_t idx = row * H + unit;
  const float dh_next = dh_s[u * kBatch + b];
  if (dh0 != nullptr) {  // the last launch: dh0 = dgates[0] @ w_hh
    dh0[idx] = dh_next;
    return;
  }
  const T* gr = gates + row * H4;
  const float gi = to_f32(gr[0 * H + unit]);
  const float gf = to_f32(gr[1 * H + unit]);
  const float gg = to_f32(gr[2 * H + unit]);
  const float go = to_f32(gr[3 * H + unit]);
  const float ct = to_f32(cs[idx]);
  float i_a, f_a, g_a, o_a, di_a, df_a, dg_a, do_a, tanh_c, dtanh_c;
  if (hard) {
    i_a = fminf(fmaxf(0.5f + gi * 0.125f, 0.0f), 1.0f);
    f_a = fminf(fmaxf(0.5f + gf * 0.125f, 0.0f), 1.0f);
    o_a = fminf(fmaxf(0.5f + go * 0.125f, 0.0f), 1.0f);
    g_a = fminf(fmaxf(gg, -1.0f), 1.0f);
    di_a = (gi > -4.0f && gi < 4.0f) ? 0.125f : 0.0f;
    df_a = (gf > -4.0f && gf < 4.0f) ? 0.125f : 0.0f;
    do_a = (go > -4.0f && go < 4.0f) ? 0.125f : 0.0f;
    dg_a = (gg > -1.0f && gg < 1.0f) ? 1.0f : 0.0f;
    tanh_c = fminf(fmaxf(ct, -1.0f), 1.0f);
    dtanh_c = (ct > -1.0f && ct < 1.0f) ? 1.0f : 0.0f;
  } else {
    i_a = 1.0f / (1.0f + expf(-gi));
    f_a = 1.0f / (1.0f + expf(-gf));
    o_a = 1.0f / (1.0f + expf(-go));
    g_a = tanhf(gg);
    di_a = i_a * (1.0f - i_a);
    df_a = f_a * (1.0f - f_a);
    do_a = o_a * (1.0f - o_a);
    dg_a = 1.0f - g_a * g_a;
    tanh_c = tanhf(ct);
    dtanh_c = 1.0f - tanh_c * tanh_c;
  }
  const float dh = to_f32(dy[idx]) + dh_next;
  const float dc = dc_in[idx] + to_f32(dcs[idx]) + dh * o_a * dtanh_c;
  T* dr = dg + row * H4;
  dr[0 * H + unit] = from_f32<T>(dc * g_a * di_a);
  dr[1 * H + unit] = from_f32<T>(dc * to_f32(c_prev[idx]) * df_a);
  dr[2 * H + unit] = from_f32<T>(dc * i_a * dg_a);
  dr[3 * H + unit] = from_f32<T>(dh * tanh_c * do_a);
  dc_out[idx] = dc * f_a;
}

template <typename T>
int run(const T* gates, const T* c_prev, const T* cs, const T* dys, const T* dcs,
        const T* w_t, T* dgates, float* dh0, float* dc_buf, int T_steps, int B, int H,
        int hard, cudaStream_t stream) {
  const size_t smem = stage_bytes(sizeof(T)) + sizeof(float) * kUnits * kBatch;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kBatch - 1) / kBatch);
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t bh4 = 4 * bh;
  for (int s = 0; s < T_steps; ++s) {
    const int t = T_steps - 1 - s;
    const size_t cur = (s & 1) * bh;
    const size_t nxt = ((s + 1) & 1) * bh;
    lstm_bwd_step_kernel<T><<<grid, kThreads, smem, stream>>>(
        t + 1 < T_steps ? dgates + (t + 1) * bh4 : nullptr, w_t, gates + t * bh4,
        c_prev + t * bh, cs + t * bh, dys + t * bh, dcs + t * bh, dc_buf + cur,
        dc_buf + nxt, dgates + t * bh4, nullptr, B, H, hard);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // dh0 = dgates[0] @ w_hh (the other pointers are not read on this launch)
  lstm_bwd_step_kernel<T><<<grid, kThreads, smem, stream>>>(
      T_steps > 0 ? dgates : nullptr, w_t, gates, c_prev, cs, dys, dcs, dc_buf, dc_buf,
      dgates, dh0, B, H, hard);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs (dtype 0 = float32, 1 = bfloat16).
size_t lstm_recurrence_bwd_smem_bytes(int dtype) {
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return stage_bytes(esize) + sizeof(float) * kUnits * kBatch;
}

// Runs T reverse steps and the dh0 launch (T+1 launches). All [T, B, *]
// inputs are contiguous in the compute dtype; w_t is w_hh^T [H, 4H].
// dc_buf: [2, B, H] fp32 zeros; reverse step s = T-1-t reads slot s%2 and
// writes slot (s+1)%2, so dc0 ends in slot T%2. dh0: [B, H] fp32. Returns the
// first CUDA error (0 on success).
int lstm_recurrence_bwd(const void* gates, const void* c_prev, const void* cs,
                        const void* dys, const void* dcs, const void* w_t, void* dgates,
                        void* dh0, void* dc_buf, int T, int B, int H, int hard, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(gates), static_cast<const float*>(c_prev),
                      static_cast<const float*>(cs), static_cast<const float*>(dys),
                      static_cast<const float*>(dcs), static_cast<const float*>(w_t),
                      static_cast<float*>(dgates), static_cast<float*>(dh0),
                      static_cast<float*>(dc_buf), T, B, H, hard, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(gates), static_cast<const __nv_bfloat16*>(c_prev),
        static_cast<const __nv_bfloat16*>(cs), static_cast<const __nv_bfloat16*>(dys),
        static_cast<const __nv_bfloat16*>(dcs), static_cast<const __nv_bfloat16*>(w_t),
        static_cast<__nv_bfloat16*>(dgates), static_cast<float*>(dh0),
        static_cast<float*>(dc_buf), T, B, H, hard, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
