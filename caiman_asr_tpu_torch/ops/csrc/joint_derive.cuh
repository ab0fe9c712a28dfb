// Deriving the softmax numerators again in the joint's backward, for the
// routes that store no slab (joint_bwd_fused.cu, joint_bwd_recompute.cu):
//   v[n, k] = exp(h[n] . wt[k] + bias[k] - shift[n])
// with shift null (u = exp(z), K6) or the row's log-sum-exp (p = softmax,
// K4). One product of 2 N Hj K operations with an exp epilogue. The tile is
// written as fp32 (out32) or as bf16 (out16) or both; either may be null.
//
// fp32 inputs (derive_kernel): a [BM x BN] tile per block on the CUDA
// cores (joint_tile.cuh).
//
// bf16 inputs (derive_sm90_kernel): the Hopper product of
// joint_prod_sm90.cuh, a [128 x 256] tile of fp32 sums, with the exp
// epilogue from registers. What holds it back is the store: over a K4 row
// chunk the fp32 tile moves 8 bytes through HBM per element (written here,
// read by the pass after) against 2 Hj operations, a 128 KB tile against
// ~16 slices of products, ~5 us of an SM's share of HBM. The grid is
// persistent (one block per SM walking the tiles in groups of row tiles,
// see origin), the producer warp stages the next tile's slices while the
// consumers run the epilogue, and each warp stores its rows through a
// small buffer, whole 128-byte rows at a time (joint_prod_sm90.cuh's
// store_tile; element by element where K does not allow 16-byte stores).
// Staging the tile for TMA stores instead (3 ring stages to make room)
// was slower: 1.34 against 1.17 ms over a 15,360-row fp32 chunk at
// large-196M's widths (H100 80GB HBM3, 700 W). The mainloop keeps one
// accumulator over all of Hj (no flush): the outputs are held to 1e-3
// (fp32) or one bf16 step, and the drift stays near 2e-5 of z's scale. No
// atomics, no order between blocks: deterministic.

#pragma once

#include "joint_prod_sm90.cuh"
#include "joint_tile.cuh"

namespace joint {

__device__ __forceinline__ void derive_store(float v, size_t at, float* out32,
                                             __nv_bfloat16* out16) {
  if (out32 != nullptr) out32[at] = v;
  if (out16 != nullptr) out16[at] = __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(kThreads)
derive_kernel(const float* __restrict__ h,      // [N, Hj]
              const float* __restrict__ wt,     // [K, Hj]
              const float* __restrict__ bias,   // [K]
              const float* __restrict__ shift,  // [N] or null
              float* __restrict__ out32,        // [N, K] or null
              __nv_bfloat16* __restrict__ out16,  // [N, K] or null
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
    const float d = shift != nullptr ? shift[row] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < K)
        derive_store(expf(acc[i][j] + bias[col] - d), static_cast<size_t>(row) * K + col, out32,
                     out16);
    }
  }
}

namespace derive {

constexpr int kStages = 4;

struct Layout {
  static constexpr int kRing = kStages * prod::kStage;
  static constexpr int kBias = kRing;
  static constexpr int kBufs = kBias + prod::kBias;  // a store_tile buffer per consumer warp
  static constexpr int kBarriers = kBufs + (prod::kConsumers / 32) * prod::kStoreBuf;
  static constexpr int kBytes = kBarriers + 2 * kStages * 8 + 1024;  // + slack to align the base
  static_assert(kBytes <= 232448, "more shared memory than a Hopper block has");
};

struct Params {
  prod::Operands op;
  const float* bias;    // [K]
  const float* shift;   // [N] or null
  float* out32;         // [N, K] or null
  __nv_bfloat16* out16; // [N, K] or null
  int tiles_m, tiles_k, tiles;
};

// The first row and column of a tile. The tiles go in groups of kGroup row
// tiles, and within a group the row tiles run fastest: the blocks at work
// at one time share a few of wt's column tiles and the group's rows of h,
// and wt is read from HBM about once per group, whatever else the stores
// push out of L2 (8: 1.09 against 1.17 ms over a 15,360-row chunk in fp32
// at large-196M's widths, H100 80GB HBM3, 700 W).
constexpr int kGroup = 8;

__device__ __forceinline__ void origin(const Params& p, int tile, int& m0, int& n0) {
  const int per = kGroup * p.tiles_k;
  const int g = tile / per;
  const int at = tile % per;
  const int rows = min(kGroup, p.tiles_m - g * kGroup);  // row tiles of this group
  m0 = (g * kGroup + at % rows) * prod::BM;
  n0 = at / rows * prod::BN;
}

__global__ void __launch_bounds__(prod::kThreads, 1)
derive_sm90_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap, const Params p) {
  using namespace sm90;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t full0 = smem_addr(smem + Layout::kBarriers);
  const int N = p.op.N, K = p.op.K;
  if (threadIdx.x == 0) prod::init_ring<kStages>(full0, p.op);
  __syncthreads();

  if (threadIdx.x >= prod::kConsumers) {
    regs_dec<40>();
    if (threadIdx.x < prod::kConsumers + 32) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
      {
        int m0, n0;
        origin(p, tile, m0, n0);
        prod::produce<kStages>(smem, full0, &hmap, &wmap, p.op, m0, n0, it, threadIdx.x % 32);
      }
    }
    return;
  }
  regs_inc<232>();
  const int t = threadIdx.x;
  const int wg = t / 128;
  const int lane = t % 32;
  const int row_w = 64 * wg + 16 * (t / 32 % 4);  // the warp's first row in the tile
  uint8_t* buf = smem + Layout::kBufs + (t / 32) * prod::kStoreBuf;  // the warp's
  float acc[128];
  int it = 0, parity = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, parity ^= 1) {
    int m0, n0;
    origin(p, tile, m0, n0);
    const float* bias = prod::stage_bias(smem + Layout::kBias, parity, p.bias, n0, K);
    float d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_w + lane / 4 + 8 * h;
      d[h] = p.shift != nullptr && row < N ? p.shift[row] : 0.0f;
    }
    prod::products<kStages, false>(acc, smem, full0, p.op.Hj, it, wg, lane);
    named_sync<prod::kConsumers>(1);  // the tile's bias is staged
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * j + e] = expf(acc[4 * j + e] + ((e & 1) ? b.y : b.x) - d[e / 2]);
    }
    if (p.out32 != nullptr)
      prod::store_tile<float>(p.out32, N, K, m0 + row_w, n0, buf, lane,
                              [&](int i) { return acc[i]; });
    if (p.out16 != nullptr)
      prod::store_tile<__nv_bfloat16>(p.out16, N, K, m0 + row_w, n0, buf, lane,
                                      [&](int i) { return __float2bfloat16_rn(acc[i]); });
  }
}

// How a launch over these operands stages and tiles: the staging of h and
// wt, the tiles and the persistent grid (one block per SM at this shared
// memory, no more blocks than tiles).
struct Plan {
  int h_mode, w_mode, tiles_rows, tiles_k, blocks, stages, smem;
};

inline Params params(const void* h, const void* wt, const float* bias, const float* shift,
                     float* out32, __nv_bfloat16* out16, int N, int Hj, int K) {
  Params p{{static_cast<const uint8_t*>(h), static_cast<const uint8_t*>(wt), N, Hj, K, 0, 0},
           bias, shift, out32, out16, (N + prod::BM - 1) / prod::BM,
           (K + prod::BN - 1) / prod::BN, 0};
  prod::choose_staging(p.op);
  p.tiles = p.tiles_m * p.tiles_k;
  return p;
}

inline int plan(const Params& p, Plan* pl) {
  int dev = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  *pl = {p.op.h_mode, p.op.w_mode, p.tiles_m, p.tiles_k,
         p.tiles < sms ? p.tiles : sms, kStages, Layout::kBytes};
  return 0;
}

inline int launch(const Params& p, cudaStream_t stream) {
  Plan pl;
  int err = plan(p, &pl);
  CUtensorMap hmap{}, wmap{};  // left zero for an operand cp.async stages
  if (err == 0) err = prod::tensor_maps(p.op, &hmap, &wmap);
  if (err == 0)
    err = static_cast<int>(cudaFuncSetAttribute(
        derive_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::kBytes));
  if (err != 0) return err;
  derive_sm90_kernel<<<pl.blocks, prod::kThreads, Layout::kBytes, stream>>>(hmap, wmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace derive

// One launch over N rows; h and wt in the compute dtype (0 = float32,
// 1 = bfloat16). Returns the CUDA error (0 on success).
inline int launch_derive(const void* h, const void* wt, const float* bias, const float* shift,
                         float* out32, __nv_bfloat16* out16, int N, int Hj, int K, int dtype,
                         cudaStream_t s) {
  if (N <= 0 || K <= 0) return 0;
  if (dtype == 1)
    return derive::launch(derive::params(h, wt, bias, shift, out32, out16, N, Hj, K), s);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BM - 1) / BM, (K + BN - 1) / BN);
  derive_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(h),
                                          static_cast<const float*>(wt), bias, shift, out32,
                                          out16, N, Hj, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace joint
