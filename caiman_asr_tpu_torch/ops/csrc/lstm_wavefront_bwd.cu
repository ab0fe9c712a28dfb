// Wavefront multi-layer LSTM backward for Hopper (sm_90a): the counterpart of
// the Pallas TPU kernel caiman_asr_tpu/ops/pallas_wavefront.py::_bwd_kernel
// (K8-bwd), the mirrored reverse wavefront.
//
// Layer l takes step t at reverse superstep r = (T-1-t) + (G-1-l):
//   dh = dys[l,t] + dgates[l,t+1] @ w_hh^l + m[l,t] * (dgates[l+1,t] @ w_ih^{l+1})
//   dc = dc + dcs[l,t] + dh * o * tnh'(c_t)
//   dgates[l,t] = [dc*g*i', dc*c_{t-1}*f', dc*i*g', dh*tnh(c_t)*o']  (compute dtype)
//   dc = dc * f
// where a step outside [0, T), or a layer past G-1, contributes nothing, and
// m is the dropout mask entering layer l+1 (1 without masks). Both handoffs
// were written by the previous launch into the dgates output, already
// rounded to the compute dtype, which is the value the Pallas kernel feeds
// its products. Layer l's last step (t = 0) is followed, one superstep
// later, by its dh0 = dgates[l,0] @ w_hh^l (the own term only,
// pallas_wavefront.py:339-345); dc0 is the fp32 carry dc [G, B, H] left in
// place. The activations are recomputed from the stored pre-activations
// (soft, or the hard clip windows of pallas_wavefront.py:306-315).
//
// What bounds it: a reverse superstep reads every layer's w_hh and the inner
// layers' w_ih once, (2G-1)*4H*H values, against 2*B*4H*H*(2G-1) FLOPs: at
// B=16 the bytes. Design (simple first, the mirror of lstm_recurrence_bwd.cu
// across layers): one launch per reverse superstep plus one for layer 0's
// dh0, T + G launches. The grid is (unit tiles, batch tiles, G), blockIdx.z
// the layer; each block owns kUnits hidden units (one warp each) and kBatch
// batch rows. It contracts each 4H-wide handoff, staged in shared memory in
// chunks of kChunk columns with 16-byte copies, with its units' rows of
// w^T ([H, 4H] per layer, contiguous along the contraction), keeping the own
// and the from-above sums apart so the mask applies to the latter's [B, H]
// output, then runs the gate backward for its units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 8;          // hidden units per block, one warp each
constexpr int kWarps = kUnits;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;         // batch rows per block
constexpr int kChunk = 1024;       // handoff columns staged per pass

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

// out[warp * kBatch + b] = src[b0 + b, :] . wrow, for the block's batch rows
// (zero when src is null). src: [B, 4H] rows; wrow: this warp's unit's row of
// w^T. src is uniform across the block, so every thread meets the barriers.
template <typename T>
__device__ void contract(const T* __restrict__ src, const T* __restrict__ wrow, int H4,
                         int b0, int nb, T* g_s, float* out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) acc[b] = 0.0f;
  if (src != nullptr) {
    constexpr int N = Pack<T>::N;
    for (int k0 = 0; k0 < H4; k0 += kChunk) {
      const int kc = min(kChunk, H4 - k0);
      __syncthreads();  // the previous chunk has been read
      // 16-byte copies, several in flight: 4H is a multiple of 32, so kc is
      // a multiple of N
#pragma unroll 4
      for (int i = threadIdx.x; i < kBatch * (kc / N); i += kThreads) {
        const int b = i / (kc / N);
        const int k = N * (i % (kc / N));
        *reinterpret_cast<uint4*>(g_s + b * kChunk + k) =
            b < nb ? *reinterpret_cast<const uint4*>(
                         src + static_cast<size_t>(b0 + b) * H4 + k0 + k)
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
    for (int b = 0; b < kBatch; ++b) out[warp * kBatch + b] = acc[b];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wavefront_bwd_step_kernel(const T* __restrict__ gs,      // [G, T, B, 4H]
                          const T* __restrict__ cs,      // [G, T, B, H]
                          const T* __restrict__ c_prev,  // [G, T, B, H]
                          const T* __restrict__ dys,     // [G, T, B, H]
                          const T* __restrict__ dcs,     // [G, T, B, H]
                          const T* __restrict__ masks,   // [G-1, T, B, H] or null
                          const T* __restrict__ w_hh_t,  // [G, H, 4H]
                          const T* __restrict__ w_ih_t,  // [G-1, H, 4H] (layer l+1's at l)
                          T* __restrict__ dgates,        // [G, T, B, 4H]
                          float* __restrict__ dh0,       // [G, B, H]
                          float* __restrict__ dc,        // [G, B, H] fp32 carry, in place
                          int r, int T_steps, int B, int H, int G, int hard) {
  const int l = blockIdx.z;
  const int tr = r - (G - 1 - l);          // the layer's reverse step
  if (tr < 0 || tr > T_steps) return;      // outside its window (tr == T: the dh0 step)
  const int t = T_steps - 1 - tr;          // -1 on the dh0 step

  extern __shared__ __align__(16) unsigned char smem[];
  T* g_s = reinterpret_cast<T*>(smem);                                       // [kBatch, kChunk]
  float* own_s = reinterpret_cast<float*>(smem + stage_bytes(sizeof(T)));   // [kUnits, kBatch]
  float* above_s = own_s + kUnits * kBatch;                                 // [kUnits, kBatch]

  const int H4 = 4 * H;
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t bh4 = 4 * bh;
  const int u0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kBatch;
  const int nb = min(kBatch, B - b0);
  const int wunit = min(u0 + static_cast<int>(threadIdx.x / 32), H - 1);  // clamped tail

  // 1. the two products for this block's units
  const T* own_src =
      t + 1 < T_steps ? dgates + (static_cast<size_t>(l) * T_steps + t + 1) * bh4 : nullptr;
  contract(own_src, w_hh_t + (static_cast<size_t>(l) * H + wunit) * H4, H4, b0, nb, g_s, own_s);
  const bool above = t >= 0 && l + 1 < G;
  contract(above ? dgates + (static_cast<size_t>(l + 1) * T_steps + t) * bh4 : nullptr,
           above ? w_ih_t + (static_cast<size_t>(l) * H + wunit) * H4 : nullptr, H4, b0, nb,
           g_s, above_s);
  __syncthreads();

  // 2. one thread per (batch row, unit) of the block's tile
  if (threadIdx.x >= kUnits * kBatch) return;
  const int u = threadIdx.x % kUnits;
  const int b = threadIdx.x / kUnits;
  const int unit = u0 + u;
  if (b >= nb || unit >= H) return;
  const size_t row = static_cast<size_t>(b0 + b);
  const size_t idx = row * H + unit;
  const float own = own_s[u * kBatch + b];
  if (t < 0) {  // the layer's dh0 step
    dh0[l * bh + idx] = own;
    return;
  }
  const size_t at = (static_cast<size_t>(l) * T_steps + t) * bh + idx;  // [l, t, row, unit]
  float dh_mat = own;
  if (above) {
    const float m = masks != nullptr ? to_f32(masks[at]) : 1.0f;  // masks[l, t]: l < G-1
    dh_mat += above_s[u * kBatch + b] * m;
  }
  const T* gr = gs + (static_cast<size_t>(l) * T_steps + t) * bh4 + row * H4;
  const float gi = to_f32(gr[0 * H + unit]);
  const float gf = to_f32(gr[1 * H + unit]);
  const float gg = to_f32(gr[2 * H + unit]);
  const float go = to_f32(gr[3 * H + unit]);
  const float ct = to_f32(cs[at]);
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
  float* dcl = dc + l * bh + idx;
  const float dh = to_f32(dys[at]) + dh_mat;
  const float d = *dcl + to_f32(dcs[at]) + dh * o_a * dtanh_c;
  T* dr = dgates + (static_cast<size_t>(l) * T_steps + t) * bh4 + row * H4;
  dr[0 * H + unit] = from_f32<T>(d * g_a * di_a);
  dr[1 * H + unit] = from_f32<T>(d * to_f32(c_prev[at]) * df_a);
  dr[2 * H + unit] = from_f32<T>(d * i_a * dg_a);
  dr[3 * H + unit] = from_f32<T>(dh * tanh_c * do_a);
  *dcl = d * f_a;
}

template <typename T>
int run(const T* gs, const T* cs, const T* c_prev, const T* dys, const T* dcs, const T* masks,
        const T* w_hh_t, const T* w_ih_t, T* dgates, float* dh0, float* dc, int T_steps, int B,
        int H, int G, int hard, cudaStream_t stream) {
  const size_t smem = stage_bytes(sizeof(T)) + 2 * sizeof(float) * kUnits * kBatch;
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_bwd_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kBatch - 1) / kBatch, G);
  // T + G - 1 reverse supersteps, and one more for layer 0's dh0
  for (int r = 0; r < T_steps + G; ++r) {
    wavefront_bwd_step_kernel<T><<<grid, kThreads, smem, stream>>>(
        gs, cs, c_prev, dys, dcs, masks, w_hh_t, w_ih_t, dgates, dh0, dc, r, T_steps, B, H, G,
        hard);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block needs (dtype 0 = float32, 1 = bfloat16).
size_t lstm_wavefront_bwd_smem_bytes(int dtype) {
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return stage_bytes(esize) + 2 * sizeof(float) * kUnits * kBatch;
}

// Runs the T + G launches. All [G, T, B, *] inputs are contiguous in the
// compute dtype; masks may be null (no dropout); w_hh_t / w_ih_t are the
// transposed weights [G, H, 4H] / [G-1, H, 4H]. dh0 and dc: [G, B, H] fp32,
// dc zero on entry and dc0 on return. Returns the first CUDA error (0 on
// success).
int lstm_wavefront_bwd(const void* gs, const void* cs, const void* c_prev, const void* dys,
                       const void* dcs, const void* masks, const void* w_hh_t,
                       const void* w_ih_t, void* dgates, void* dh0, void* dc, int T, int B,
                       int H, int G, int hard, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h0 = static_cast<float*>(dh0);
  float* c0 = static_cast<float*>(dc);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(gs), static_cast<const float*>(cs),
                      static_cast<const float*>(c_prev), static_cast<const float*>(dys),
                      static_cast<const float*>(dcs), static_cast<const float*>(masks),
                      static_cast<const float*>(w_hh_t), static_cast<const float*>(w_ih_t),
                      static_cast<float*>(dgates), h0, c0, T, B, H, G, hard, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(gs), static_cast<const __nv_bfloat16*>(cs),
        static_cast<const __nv_bfloat16*>(c_prev), static_cast<const __nv_bfloat16*>(dys),
        static_cast<const __nv_bfloat16*>(dcs), static_cast<const __nv_bfloat16*>(masks),
        static_cast<const __nv_bfloat16*>(w_hh_t), static_cast<const __nv_bfloat16*>(w_ih_t),
        static_cast<__nv_bfloat16*>(dgates), h0, c0, T, B, H, G, hard, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
