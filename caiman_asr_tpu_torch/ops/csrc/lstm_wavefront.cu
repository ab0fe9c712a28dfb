// Wavefront multi-layer LSTM forward for Hopper (sm_90a): the counterpart of
// the Pallas TPU kernel caiman_asr_tpu/ops/pallas_wavefront.py::_fwd_kernel
// (K8-fwd); with the kStoreGates flag it also writes the full
// pre-activations gs in the compute dtype for the backward
// (pallas_wavefront.py:146-147).
//
// G stacked layers, time-major, run as a (layer, time) wavefront: at
// superstep s layer l takes step t = s - l, for s in [0, T + G - 1).
//   layer 0:   gates = gx0[t] + h^0_{t-1} @ w0^T                 (w0 [4H, H])
//   layer l>0: gates = [x ; h^l_{t-1}] @ w_cat[l-1]^T + bias[l-1] (w_cat [4H, 2H])
//              x = ys[l-1, t] * mask[l-1, t], rounded to the compute dtype
//   c = sig(f) * c + sig(i) * tnh(g);  h = sig(o) * tnh(c)
// Gate order i, f, g, o; soft or hard (clip(0.5 + z/8, 0, 1) / clip(z, -1,
// 1)) activations; products accumulate in fp32 and the fp32 bias adds to the
// sum. c is carried in fp32 (c_state [G, B, H], each element read and
// written by one thread, in place); h enters a product in the compute dtype,
// which is exactly its stored output, so h^l_{t-1} is read from ys[l, t-1]
// (h0[l] at t = 0) and layer l-1's handoff from ys[l-1, t]. Both were
// written by the previous launch, so a layer that idles (s < l) keeps its
// state untouched. Outputs ys, cs [G, T, B, H] (gs [G, T, B, 4H]).
//
// What bounds it: a superstep reads every layer's weights once, 4H*H +
// (G-1)*4H*2H values (92 MB in bf16 at G=6, H=1024), against
// 2*B*4H*(H + (G-1)*2H) FLOPs: at B=16 the bytes. Design (simple first):
// one launch per superstep, the grid (unit tiles, batch tiles, G) with
// blockIdx.z the layer, guarded to its window l <= s < T + l. As in
// lstm_recurrence.cu each block owns kUnits hidden units across all four
// gates, so the gate math stays in the block: it stages its batch rows'
// contraction input ([x ; h] for an inner layer, 2H wide) in shared memory
// with 16-byte copies (element-wise staging, one load in flight per thread,
// took 21.4 ms at G=6, T=134, B=16, H=1024 in bf16, chip_smoke.py on an
// H100 80GB HBM3 at 700 W; 16-byte copies 10.4 ms),
// each warp contracts kRowsPerWarp weight rows (torch layout, contiguous
// along the contraction) with 16-byte loads, and one pass of threads applies
// the gate math. The weights are re-read from L2/HBM every superstep.

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

// 16 bytes of x times 16 bytes of mask, each product rounded to T
template <typename T>
__device__ __forceinline__ uint4 mul_pack(uint4 x, uint4 m) {
  uint4 out;
  const T* px = reinterpret_cast<const T*>(&x);
  const T* pm = reinterpret_cast<const T*>(&m);
  T* po = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) po[j] = from_f32<T>(to_f32(px[j]) * to_f32(pm[j]));
  return out;
}

__device__ __forceinline__ float act_sig(float z, int hard) {
  return hard ? fminf(fmaxf(0.5f + z * 0.125f, 0.0f), 1.0f) : 1.0f / (1.0f + expf(-z));
}
__device__ __forceinline__ float act_tanh(float z, int hard) {
  return hard ? fminf(fmaxf(z, -1.0f), 1.0f) : tanhf(z);
}

// the staged contraction input, kBatch rows of K values (K = H or 2H)
__host__ __device__ constexpr size_t stage_bytes(int K, size_t esize) {
  return ((static_cast<size_t>(kBatch) * K * esize) + 15) / 16 * 16;
}

template <typename T, bool kStoreGates>
__global__ void __launch_bounds__(kThreads)
wavefront_step_kernel(const T* __restrict__ gx0,       // [T, B, 4H]
                      const float* __restrict__ bias,  // [max(G-1, 1), 4H]
                      const T* __restrict__ w0,        // [4H, H]
                      const T* __restrict__ w_cats,    // [G-1, 4H, 2H]
                      const T* __restrict__ masks,     // [G-1, T, B, H] or null
                      const T* __restrict__ h0,        // [G, B, H]
                      float* __restrict__ c_state,     // [G, B, H] fp32, in place
                      T* __restrict__ ys,              // [G, T, B, H]
                      T* __restrict__ cs,              // [G, T, B, H]
                      T* __restrict__ gs,              // [G, T, B, 4H] (kStoreGates only)
                      int s, int T_steps, int B, int H, int hard) {
  const int l = blockIdx.z;
  const int t = s - l;
  if (t < 0 || t >= T_steps) return;  // outside the layer's window: idle

  extern __shared__ __align__(16) unsigned char smem[];
  const int K = l == 0 ? H : 2 * H;
  T* x_s = reinterpret_cast<T*>(smem);                                   // [kBatch, K]
  float* g_s = reinterpret_cast<float*>(smem + stage_bytes(K, sizeof(T)));  // [kRows, kBatch]

  const size_t bh = static_cast<size_t>(B) * H;
  const size_t layer = static_cast<size_t>(T_steps) * bh;  // one layer of a [G, T, B, H] stream
  const T* h_prev = t == 0 ? h0 + l * bh : ys + l * layer + (t - 1) * bh;
  const size_t below = (l - 1) * layer + t * bh;  // ys[l-1, t] and masks[l-1, t]
  const int u0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kBatch;
  const int nb = min(kBatch, B - b0);

  // 1. stage the contraction input in the compute dtype, 16 bytes per copy
  // (H is a multiple of 8, so no copy straddles x and h and every row starts
  // 16-byte aligned), several copies in flight; rows past B are zero
  constexpr int N = Pack<T>::N;
  const int row_vecs = K / N;
#pragma unroll 4
  for (int i = threadIdx.x; i < kBatch * row_vecs; i += kThreads) {
    const int b = i / row_vecs;
    const int k = N * (i - b * row_vecs);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b < nb) {
      const size_t row = static_cast<size_t>(b0 + b) * H;
      if (k >= K - H) {
        v = *reinterpret_cast<const uint4*>(h_prev + row + k - (K - H));
      } else {
        v = *reinterpret_cast<const uint4*>(ys + below + row + k);
        if (masks != nullptr)  // the masked handoff rounds here, as x * mask in the dtype
          v = mul_pack<T>(v, *reinterpret_cast<const uint4*>(masks + below + row + k));
      }
    }
    *reinterpret_cast<uint4*>(x_s + b * K + k) = v;
  }
  __syncthreads();

  // 2. each warp: kRowsPerWarp weight rows against kBatch staged rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* wbase = l == 0 ? w0 : w_cats + static_cast<size_t>(l - 1) * 4 * H * K;
  const T* wrow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = warp * kRowsPerWarp + r;          // local gate row
    const int unit = min(u0 + lr % kUnits, H - 1);   // clamped; tail units are not stored
    wrow[r] = wbase + static_cast<size_t>((lr / kUnits) * H + unit) * K;
  }
  float acc[kRowsPerWarp][kBatch];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < kBatch; ++b) acc[r][b] = 0.0f;

  for (int k = lane * N; k < K; k += 32 * N) {
    float w[kRowsPerWarp][N];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) Pack<T>::load(wrow[r] + k, w[r]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float x[N];
      Pack<T>::load(x_s + b * K + k, x);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int j = 0; j < N; ++j) acc[r][b] = fmaf(w[r][j], x[j], acc[r][b]);
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
  if (threadIdx.x >= kUnits * kBatch) return;
  const int u = threadIdx.x % kUnits;
  const int b = threadIdx.x / kUnits;
  const int unit = u0 + u;
  if (b >= nb || unit >= H) return;
  const size_t row = static_cast<size_t>(b0 + b);
  float pre[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float dot = g_s[(q * kUnits + u) * kBatch + b];
    const int col = q * H + unit;
    pre[q] = l == 0 ? to_f32(gx0[(static_cast<size_t>(t) * B + row) * 4 * H + col]) + dot
                    : dot + bias[static_cast<size_t>(l - 1) * 4 * H + col];
  }
  if (kStoreGates) {
    T* gsb = gs + ((static_cast<size_t>(l) * T_steps + t) * B + row) * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) gsb[q * H + unit] = from_f32<T>(pre[q]);
  }
  const size_t idx = row * H + unit;
  float* c = c_state + l * bh + idx;
  const float c_new = act_sig(pre[1], hard) * *c + act_sig(pre[0], hard) * act_tanh(pre[2], hard);
  const float h_new = act_sig(pre[3], hard) * act_tanh(c_new, hard);
  *c = c_new;
  const size_t out = l * layer + t * bh + idx;
  ys[out] = from_f32<T>(h_new);
  cs[out] = from_f32<T>(c_new);
}

template <typename T, bool kStoreGates>
int run(const T* gx0, const float* bias, const T* w0, const T* w_cats, const T* masks,
        const T* h0, float* c_state, T* ys, T* cs, T* gs, int T_steps, int B, int H, int G,
        int hard, cudaStream_t stream) {
  const size_t smem =
      stage_bytes(G > 1 ? 2 * H : H, sizeof(T)) + sizeof(float) * kRows * kBatch;
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_step_kernel<T, kStoreGates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kBatch - 1) / kBatch, G);
  for (int s = 0; s < T_steps + G - 1; ++s) {
    wavefront_step_kernel<T, kStoreGates><<<grid, kThreads, smem, stream>>>(
        gx0, bias, w0, w_cats, masks, h0, c_state, ys, cs, gs, s, T_steps, B, H, hard);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kStoreGates>
int dispatch(const void* gx0, const void* bias, const void* w0, const void* w_cats,
             const void* masks, const void* h0, void* c_state, void* ys, void* cs, void* gs,
             int T, int B, int H, int G, int hard, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* c = static_cast<float*>(c_state);
  if (dtype == 0)
    return run<float, kStoreGates>(
        static_cast<const float*>(gx0), b, static_cast<const float*>(w0),
        static_cast<const float*>(w_cats), static_cast<const float*>(masks),
        static_cast<const float*>(h0), c, static_cast<float*>(ys), static_cast<float*>(cs),
        static_cast<float*>(gs), T, B, H, G, hard, st);
  if (dtype == 1)
    return run<__nv_bfloat16, kStoreGates>(
        static_cast<const __nv_bfloat16*>(gx0), b, static_cast<const __nv_bfloat16*>(w0),
        static_cast<const __nv_bfloat16*>(w_cats), static_cast<const __nv_bfloat16*>(masks),
        static_cast<const __nv_bfloat16*>(h0), c, static_cast<__nv_bfloat16*>(ys),
        static_cast<__nv_bfloat16*>(cs), static_cast<__nv_bfloat16*>(gs), T, B, H, G, hard,
        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory one block needs at width H with G layers (dtype 0 =
// float32, 1 = bfloat16).
size_t lstm_wavefront_fwd_smem_bytes(int H, int G, int dtype) {
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return stage_bytes(G > 1 ? 2 * H : H, esize) + sizeof(float) * kRows * kBatch;
}

// Runs T + G - 1 supersteps, one launch each. masks may be null (no
// dropout); c_state holds c0 in fp32 on entry and c^l_{T-1} on return.
// Returns the first CUDA error (0 on success).
int lstm_wavefront_fwd(const void* gx0, const void* bias, const void* w0, const void* w_cats,
                       const void* masks, const void* h0, void* c_state, void* ys, void* cs,
                       int T, int B, int H, int G, int hard, int dtype, void* stream) {
  return dispatch<false>(gx0, bias, w0, w_cats, masks, h0, c_state, ys, cs, nullptr, T, B, H,
                         G, hard, dtype, stream);
}

// The same, also writing gs [G, T, B, 4H] (the forward of the VJP).
int lstm_wavefront_fwd_sg(const void* gx0, const void* bias, const void* w0,
                          const void* w_cats, const void* masks, const void* h0,
                          void* c_state, void* ys, void* cs, void* gs, int T, int B, int H,
                          int G, int hard, int dtype, void* stream) {
  return dispatch<true>(gx0, bias, w0, w_cats, masks, h0, c_state, ys, cs, gs, T, B, H, G,
                        hard, dtype, stream);
}

}  // extern "C"
