// Joint + log-sum-exp forward for Hopper (sm_90a): the counterpart of the
// Pallas TPU kernels caiman_asr_tpu/ops/pallas_joint.py::_fwd_kernel (K2),
// with kStore == kBf16 ::_fwd_kernel_store (K5-store) and with
// kStore == kInt8 ::_fwd_kernel_store8 (K7-store8).
//
// For every lattice position (row) n:  sums[n] = sum_k exp(h[n] . w_k + b_k)
// with fp32 accumulation and NO max subtraction (the JAX contract,
// pallas_joint.py:41-51: a logit above ~88 overflows to inf, the loss goes
// non-finite and the train step skips the batch). kBf16 also writes
// u = exp(z) to a bf16 [N, K] slab for the backward passes. kInt8 writes it
// as scaled int8: per row and per kt-wide vocab tile, m = max u, the scale
// m / 127 goes to scales[tile, row] and q = round_to_nearest_even(u * (127 /
// m)) to the int8 [N, K] slab (m == 0 gives scale 0 and q 0); the sums use
// the unquantised fp32 u (pallas_joint.py:131-137).
//
// What bounds it: 2 N Hj K operations (1.86 TFLOP at the base-85M smoke
// cell, N = 139,360, Hj = 768, K = 8,704); the slab write (N K 2 bytes, or
// N K) is a third of a millisecond of HBM time beside that. So it is an
// operation-bound GEMM with an exp epilogue.
//
// fp32 inputs (joint_fwd_kernel) run on the CUDA cores (joint_tile.cuh):
// one block per 128 rows looping over all K, each thread keeping the
// partial sums of its 8 rows, the 16 threads sharing a row reducing with
// shuffles; kInt8 walks each scale tile twice (maxima, then quantisation).
//
// bf16 inputs (joint_fwd_sm90_kernel, all three modes) do the product once,
// on wgmma (joint_prod_sm90.cuh). A cluster of 8 blocks shares 128 rows and
// walks the vocabulary in rounds of 2,048 columns; in each round block r of
// the cluster computes the round's 256-column tile r, u = exp(z + b) in
// registers, and adds it into per-row partial sums it keeps over all
// rounds. Which block owns a column depends only on its index (never on
// kt), so the partials and the fixed order in which they are combined at
// the end (through distributed shared memory, in rank order, no atomics)
// are the same in every mode: K2's, K5-store's and K7-store8's sums are
// equal bit for bit. kInt8: a row's maximum over a scale tile (kt = 128 to
// 2,048, dividing 2,048) is known before any of it is quantised without
// doing the product again: each block writes its per-row maxima of the
// tile's two 128-column halves into its shared memory, the cluster meets at
// a barrier, and each block reads the kt / 256 partials of its scale tile
// from the blocks that hold them (at kt = 128 its tile holds two whole
// scale tiles and the maxima stay inside it), then quantises from
// registers. The slab and the scales are written once: each warp's rows
// through a small buffer, whole 128-byte rows at a time where K allows it
// (joint_prod_sm90.cuh's store_tile), else element by element. The
// mainloop sums each slice apart and adds it into the tile rounded to
// nearest (products' kFlush), so the row sums hold their 1e-5. A round
// that is partly past K (K = 8,704 is 4.25 rounds) leaves the blocks past
// it idle; they still meet every barrier.

#include <stdint.h>

#include "joint_prod_sm90.cuh"
#include "joint_tile.cuh"

namespace {

using namespace joint;

enum Store { kNone = 0, kBf16 = 1, kInt8 = 2 };

__device__ __forceinline__ float inv_scale(float m) { return m > 0.0f ? 127.0f / m : 0.0f; }
__device__ __forceinline__ int8_t quantise(float e, float inv) {
  return static_cast<int8_t>(__float2int_rn(e * inv));
}

template <int kStore>
__global__ void __launch_bounds__(kThreads)
joint_fwd_kernel(const float* __restrict__ h,    // [N, Hj]
                 const float* __restrict__ wt,   // [K, Hj] (w transposed)
                 const float* __restrict__ bias, // [K]
                 float* __restrict__ sums,       // [N]
                 void* __restrict__ slab,        // [N, K] bf16 (kBf16) or int8 (kInt8)
                 float* __restrict__ scales,     // [ceil(K / kt), N] (kInt8 only)
                 int N, int Hj, int K, int kt) {
  __shared__ Tiles s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  auto product = [&](float (&acc)[TM][TN], int n0) {
    zero(acc);
    mainloop(
        s, acc, Hj,
        [&](Tile& a, int k0) { load_kmajor(a, h, N, Hj, Hj, m0, k0); },
        [&](Tile& b, int k0) { load_kmajor(b, wt, K, Hj, Hj, n0, k0); });
  };
  float rsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rsum[i] = 0.0f;

  // one span for K2 / K5-store; one per scale tile (a multiple of BN) for kInt8
  const int span = kStore == kInt8 ? kt : K;
  for (int s0 = 0; s0 < K; s0 += span) {
    const int s1 = min(K, s0 + span);
    float inv[TM];
    if constexpr (kStore == kInt8) {
      float rmax[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) rmax[i] = 0.0f;
      for (int n0 = s0; n0 < s1; n0 += BN) {
        float acc[TM][TN];
        product(acc, n0);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col >= s1) continue;
#pragma unroll
          for (int i = 0; i < TM; ++i) rmax[i] = fmaxf(rmax[i], expf(acc[i][j] + bias[col]));
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float m = rmax[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        inv[i] = inv_scale(m);
        const int row = m0 + ty + 16 * i;
        if (tx == 0 && row < N)
          scales[static_cast<size_t>(s0 / kt) * N + row] = m * (1.0f / 127.0f);
      }
    }
    for (int n0 = s0; n0 < s1; n0 += BN) {
      float acc[TM][TN];
      product(acc, n0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row >= N) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col >= s1) continue;
          const float e = expf(acc[i][j] + bias[col]);
          const size_t at = static_cast<size_t>(row) * K + col;
          if constexpr (kStore == kBf16)
            static_cast<__nv_bfloat16*>(slab)[at] = __float2bfloat16_rn(e);
          if constexpr (kStore == kInt8) static_cast<int8_t*>(slab)[at] = quantise(e, inv[i]);
          rsum[i] += e;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = rsum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int row = m0 + ty + 16 * i;
    if (tx == 0 && row < N) sums[row] = v;
  }
}

namespace fwd {

constexpr int kRound = 2048;                 // vocab columns per round
constexpr int kCluster = kRound / prod::BN;  // blocks per cluster, one BN tile each
constexpr int kStages = 4;
constexpr int kHalf = prod::BN / 2;          // the narrowest scale tile

// kt, the int8 slab's scale tile: a multiple of 128 that divides 2,048
__host__ __device__ constexpr bool scale_tile_ok(int kt) {
  return kt >= kHalf && kt <= kRound && kRound % kt == 0;
}

struct Layout {
  static constexpr int kRing = kStages * prod::kStage;
  static constexpr int kBias = kRing;
  static constexpr int kBufs = kBias + prod::kBias;  // a store_tile buffer per consumer warp
  // float2 [2 rounds][BM]: the per-row maxima of the tile's halves
  static constexpr int kMax = kBufs + (prod::kConsumers / 32) * prod::kStoreBuf;
  static constexpr int kSum = kMax + 2 * prod::BM * 8;  // float [BM]: the block's row sums
  static constexpr int kBarriers = kSum + prod::BM * 4;
  static constexpr int kBytes = kBarriers + 2 * kStages * 8 + 1024;  // + slack to align the base
  static_assert(kBytes <= 232448, "more shared memory than a Hopper block has");
};

struct Params {
  prod::Operands op;
  const float* bias;  // [K]
  float* sums;        // [N]
  void* slab;         // [N, K] bf16 (kBf16) or int8 (kInt8)
  float* scales;      // [ceil(K / kt), N] (kInt8)
  int kt;
};

template <int kStore>
__global__ void __launch_bounds__(prod::kThreads, 1)
joint_fwd_sm90_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap, const Params p) {
  using namespace sm90;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // aligned by pointer arithmetic, so that accesses stay shared-memory ones;
  // the offset is the same in every block, so DSMEM addresses match
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float2* pmax = reinterpret_cast<float2*>(smem + Layout::kMax);
  float* psum = reinterpret_cast<float*>(smem + Layout::kSum);
  const uint32_t full0 = smem_addr(smem + Layout::kBarriers);
  const int rank = static_cast<int>(cluster_rank());
  const int m0 = static_cast<int>(cluster_id()) * prod::BM;
  const int N = p.op.N, K = p.op.K;
  const int rounds = (K + kRound - 1) / kRound;
  if (threadIdx.x == 0) prod::init_ring<kStages>(full0, p.op);
  __syncthreads();

  if (threadIdx.x >= prod::kConsumers) {
    // ------------------------------------------------------------ producer
    // Its four warps meet every cluster barrier; one stages. It arrives at
    // round r's barrier once round r is staged, and waits for round r - 1's
    // first, so it runs up to a round ahead of the consumers.
    regs_dec<40>();
    const int warp = (threadIdx.x - prod::kConsumers) / 32;
    const int lane = threadIdx.x % 32;
    int it = 0;
    for (int r = 0; r < rounds; ++r) {
      const int n0 = r * kRound + rank * prod::BN;
      if (warp == 0 && n0 < K)
        prod::produce<kStages>(smem, full0, &hmap, &wmap, p.op, m0, n0, it, lane);
      if constexpr (kStore == kInt8) {
        if (r > 0) cluster_wait();
        cluster_arrive();
      }
    }
    if constexpr (kStore == kInt8) cluster_wait();
    cluster_arrive();  // the row sums: partials written
    cluster_wait();
    cluster_arrive();  // and read
    cluster_wait();
    return;
  }

  // ------------------------------------------------------------- consumers
  regs_inc<232>();
  const int t = threadIdx.x;
  const int wg = t / 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int row_w = 64 * wg + 16 * (t / 32 % 4);  // the warp's first row in the tile
  const int row_lo = row_w + lane / 4;            // this thread's rows: row_lo, row_lo + 8
  uint8_t* buf = smem + Layout::kBufs + (t / 32) * prod::kStoreBuf;  // the warp's
  float acc[128];
  float rsum[2] = {0.0f, 0.0f};
  int it = 0;
  for (int r = 0; r < rounds; ++r) {
    const int n0 = r * kRound + rank * prod::BN;
    const bool has = n0 < K;
    float mx[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [row lo / hi][half of the tile]
    if (has) {
      const float* bias = prod::stage_bias(smem + Layout::kBias, r & 1, p.bias, n0, K);
      prod::products<kStages, true>(acc, smem, full0, p.op.Hj, it, wg, lane);
      named_sync<prod::kConsumers>(1);  // the tile's bias is staged
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * j + 2 * quad;
        const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = n0 + c + (e & 1) < K ? expf(acc[4 * j + e] + ((e & 1) ? b.y : b.x))
                                               : 0.0f;
          acc[4 * j + e] = u;
          part[e / 2] += u;
          if constexpr (kStore == kInt8) mx[e / 2][j / 16] = fmaxf(mx[e / 2][j / 16], u);
        }
      }
      rsum[0] += part[0];
      rsum[1] += part[1];
      if constexpr (kStore == kBf16)
        prod::store_tile<__nv_bfloat16>(static_cast<__nv_bfloat16*>(p.slab), N, K, m0 + row_w,
                                        n0, buf, lane,
                                        [&](int i) { return __float2bfloat16_rn(acc[i]); });
    }
    if constexpr (kStore == kInt8) {
      // the tile's per-row maxima of its two halves, shared with the cluster
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[h][half] = fmaxf(mx[h][half], __shfl_xor_sync(0xffffffffu, mx[h][half], 1));
          mx[h][half] = fmaxf(mx[h][half], __shfl_xor_sync(0xffffffffu, mx[h][half], 2));
        }
      float2* slot = pmax + (r & 1) * prod::BM;
      if (quad == 0) {
        slot[row_lo] = make_float2(mx[0][0], mx[0][1]);
        slot[row_lo + 8] = make_float2(mx[1][0], mx[1][1]);
      }
      cluster_arrive();
      cluster_wait();
      if (has) {
        float m[2][2];  // [row lo / hi][half]: the maximum of the half's scale tile
        if (p.kt == kHalf) {
#pragma unroll
          for (int h = 0; h < 2; ++h) m[h][0] = mx[h][0], m[h][1] = mx[h][1];
        } else {
          const int per = p.kt / prod::BN;  // blocks per scale tile
          const int g0 = rank - rank % per;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t a = smem_addr(slot + row_lo + 8 * h);
            float v = 0.0f;
            for (int i = 0; i < per; ++i) {
              const float2 x = cluster_load2(cluster_map(a, g0 + i));
              v = fmaxf(v, fmaxf(x.x, x.y));
            }
            m[h][0] = m[h][1] = v;
          }
        }
        // the scales: once per scale tile and row
        if (quad == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + row_lo + 8 * h;
            if (row >= N) continue;
            if (p.kt == kHalf) {
#pragma unroll
              for (int half = 0; half < 2; ++half)
                if (n0 + kHalf * half < K)
                  p.scales[static_cast<size_t>((n0 + kHalf * half) / kHalf) * N + row] =
                      m[h][half] * (1.0f / 127.0f);
            } else if (rank % (p.kt / prod::BN) == 0) {
              p.scales[static_cast<size_t>(n0 / p.kt) * N + row] = m[h][0] * (1.0f / 127.0f);
            }
          }
        }
        float inv[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) inv[h][0] = inv_scale(m[h][0]), inv[h][1] = inv_scale(m[h][1]);
        // acc[i] is at row lo / hi (i % 4) / 2, in half i / 64
        prod::store_tile<int8_t>(static_cast<int8_t*>(p.slab), N, K, m0 + row_w, n0, buf, lane,
                                 [&](int i) { return quantise(acc[i], inv[i % 4 / 2][i / 64]); });
      }
    }
  }

  // the row sums: the four threads of a row, then the 8 blocks in rank
  // order, block r finishing rows 16 r .. 16 r + 15
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
  }
  if (quad == 0) {
    psum[row_lo] = rsum[0];
    psum[row_lo + 8] = rsum[1];
  }
  cluster_arrive();
  cluster_wait();
  constexpr int kRows = prod::BM / kCluster;
  if (t < kRows) {
    const int row = kRows * rank + t;
    const uint32_t a = smem_addr(psum + row);
    float total = 0.0f;
    for (int i = 0; i < kCluster; ++i) total += cluster_load(cluster_map(a, i));
    if (m0 + row < N) p.sums[m0 + row] = total;
  }
  cluster_arrive();  // no block leaves while another reads its shared memory
  cluster_wait();
}

// One launch (or, with `resident`, the number of 8-block clusters that can
// stand at once at this kernel's shared memory, written there instead).
template <int kStore>
int launch(const Params& p, cudaStream_t stream, int* resident = nullptr) {
  CUtensorMap hmap{}, wmap{};  // left zero for an operand cp.async stages
  int err = prod::tensor_maps(p.op, &hmap, &wmap);
  if (err != 0) return err;
  const auto kernel = joint_fwd_sm90_kernel<kStore>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::kBytes));
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.op.N + prod::BM - 1) / prod::BM) * kCluster);
  cfg.blockDim = dim3(prod::kThreads);
  cfg.dynamicSmemBytes = Layout::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(resident, reinterpret_cast<const void*>(kernel), &cfg));
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, hmap, wmap, p));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

Params params(const void* h, const void* wt, const void* bias, void* sums, void* slab,
              void* scales, int N, int Hj, int K, int kt) {
  Params p{{static_cast<const uint8_t*>(h), static_cast<const uint8_t*>(wt), N, Hj, K, 0, 0},
           static_cast<const float*>(bias), static_cast<float*>(sums), slab,
           static_cast<float*>(scales), kt};
  prod::choose_staging(p.op);
  return p;
}

}  // namespace fwd

template <int kStore>
int run(const void* h, const void* wt, const void* bias, void* sums, void* slab, void* scales,
        int N, int Hj, int K, int kt, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return fwd::launch<kStore>(fwd::params(h, wt, bias, sums, slab, scales, N, Hj, K, kt),
                               stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  joint_fwd_kernel<kStore><<<dim3((N + BM - 1) / BM), kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(sums), slab,
      static_cast<float*>(scales), N, Hj, K, kt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch. h [N, Hj] and wt [K, Hj] contiguous in the compute dtype
// (0 = float32, 1 = bfloat16); bias [K] and sums [N] fp32; u: a bf16 [N, K]
// slab to fill (K5-store) or null (K2). Returns the CUDA error (0 on success).
int joint_fwd(const void* h, const void* wt, const void* bias, void* sums, void* u, int N,
              int Hj, int K, int dtype, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u != nullptr) return run<kBf16>(h, wt, bias, sums, u, nullptr, N, Hj, K, 0, dtype, s);
  return run<kNone>(h, wt, bias, sums, nullptr, nullptr, N, Hj, K, 0, dtype, s);
}

// One launch (K7-store8). As joint_fwd, filling q int8 [N, K] and scales
// fp32 [ceil(K / kt), N]; kt, the scale tile's width: with bfloat16 a
// multiple of 128 that divides 2,048, with float32 any multiple of 128.
int joint_fwd_store8(const void* h, const void* wt, const void* bias, void* sums, void* q,
                     void* scales, int N, int Hj, int K, int kt, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (kt <= 0 || kt % BN != 0 || (dtype == 1 && !fwd::scale_tile_ok(kt)))
    return static_cast<int>(cudaErrorInvalidValue);
  return run<kInt8>(h, wt, bias, sums, q, scales, N, Hj, K, kt, dtype,
                    static_cast<cudaStream_t>(stream));
}

// The bf16 forward's plan for these operands, for the logs: out[0..7] =
// how h and wt are staged (joint_sm90.cuh's Staging: 0 TMA, 8 or 4
// cp.async bytes, 2 or 1 element copies), blocks per cluster, blocks in
// the grid, rounds of 2,048 columns, clusters that can stand at once (the
// occupancy calculator's answer for this card), ring stages and dynamic
// shared memory bytes. store: 0 K2, 1 K5-store, 2 K7-store8.
int joint_fwd_plan(const void* h, const void* wt, int N, int Hj, int K, int store, int* out) {
  if (N <= 0 || K <= 0 || store < 0 || store > 2) return static_cast<int>(cudaErrorInvalidValue);
  const fwd::Params p = fwd::params(h, wt, nullptr, nullptr, nullptr, nullptr, N, Hj, K, 2048);
  int resident = 0;
  const int err = store == 0   ? fwd::launch<kNone>(p, nullptr, &resident)
                  : store == 1 ? fwd::launch<kBf16>(p, nullptr, &resident)
                               : fwd::launch<kInt8>(p, nullptr, &resident);
  if (err != 0) return err;
  const int v[8] = {p.op.h_mode, p.op.w_mode, fwd::kCluster,
                    (N + prod::BM - 1) / prod::BM * fwd::kCluster, (K + fwd::kRound - 1) / fwd::kRound,
                    resident, fwd::kStages, fwd::Layout::kBytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
