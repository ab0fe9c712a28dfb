// The joint's logits on Hopper (sm_90a): one [BM rows x BN vocab columns]
// tile of z = h . wt^T with fp32 sums, the contraction over Hj, for the
// bf16 forward (joint_fwd.cu: K2, K5-store, K7-store8) and the bf16
// derivation (joint_derive.cuh: K6-fused, K6-derive-a, K4-A, K4-B). Each
// kernel is a loop over tiles around these pieces, with an epilogue of its
// own on the fp32 tile the consumers hold in registers.
//
// h [N, Hj] and wt [K, Hj] both hold the contraction contiguous: wgmma's
// K-major layout, as pass A's operands (joint_bwd.cuh passa). One producer
// warp fills a ring of kStages stages, each a 64-wide slice of Hj: wt's
// [BN x BK] rows (32 KB) and h's [BM x BK] rows (16 KB), by TMA with the
// 128-byte swizzle where an operand's base and row are 16-byte aligned,
// else by cp.async, else element by element (joint_sm90.cuh's staging), a
// stage's `full` mbarrier completing when its bytes have landed. Two
// consumer warpgroups each run the slice over their 64 rows (see products:
// the forward in two 128-column halves of four m64n128k16 wgmmas whose
// slice sums are added into the fp32 tile rounded to nearest, the
// derivation as four m64n256k16 into the tile itself; the k16 step +32
// bytes inside the swizzled row) and free the stage (`empty` mbarrier).
// The epilogues read the tile's bias from shared memory and store through
// a small buffer per warp, whole 128-byte rows at a time (store_tile):
// stored straight from the accumulator layout, each instruction wrote 32
// bytes of 8 rows, and the stores added half again to the derivation
// (1.72 against 1.14 ms for a 15,360 x 17,408 fp32 tile at Hj = 1,024,
// H100 80GB HBM3, 700 W). Tails (N, K, Hj not a multiple of the tile,
// Hj < BK) arrive as zeros from TMA or from the zero-filling copies;
// nothing is padded on the host.
//
// Thread t of consumer warpgroup wg holds, for j < 32, acc[4 j + e] at tile
// row 64 wg + 16 ((t % 128) / 32) + (t % 32) / 4 + 8 (e / 2) and tile column
// 8 j + 2 (t % 4) + e % 2.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "joint_sm90.cuh"

namespace joint {
namespace prod {

constexpr int BM = 128;           // rows per tile: 64 per consumer warpgroup
constexpr int BN = 256;           // vocab columns per tile
constexpr int BK = 64;            // Hj per slice: one 128-byte swizzled bf16 row
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = 384;     // + one producer warpgroup (one warp stages)
constexpr int kW = BN * 128;      // wt's [BN x BK] slice: 32 KB
constexpr int kH = BM * 128;      // h's [BM x BK] slice: 16 KB
constexpr int kStage = kW + kH;   // a multiple of 1024, so every slice stays aligned
static_assert(kStage % 1024 == 0, "stages must keep the swizzle's 1024-byte alignment");

struct Operands {
  const uint8_t* h;   // [N, Hj] bf16
  const uint8_t* wt;  // [K, Hj] bf16
  int N, Hj, K;
  int h_mode, w_mode;  // sm90::Staging of each
};

// The staging of h and of wt (Hj == 0 stages nothing).
inline void choose_staging(Operands& op) {
  const size_t row = static_cast<size_t>(op.Hj) * 2;
  op.h_mode = op.Hj > 0 ? sm90::staging(op.h, row, 2) : sm90::kElement2;
  op.w_mode = op.Hj > 0 ? sm90::staging(op.wt, row, 2) : sm90::kElement2;
}

// Tensor maps of h ([BM x BK] boxes) and wt ([BN x BK] boxes), 128-byte
// swizzled, for the operands TMA stages; the others are left zero.
inline int tensor_maps(const Operands& op, CUtensorMap* hmap, CUtensorMap* wmap) {
  const uint64_t ld = static_cast<uint64_t>(op.Hj) * 2;
  int err = 0;
  if (op.h_mode == sm90::kTma)
    err = sm90::tensor_map_2d(hmap, op.h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, op.N, op.Hj, ld, BM,
                              BK, true);
  if (err == 0 && op.w_mode == sm90::kTma)
    err = sm90::tensor_map_2d(wmap, op.wt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, op.K, op.Hj, ld,
                              BN, BK, true);
  return err;
}

// The ring's barriers: kStages `full` then kStages `empty`, 8 bytes each.
template <int kStages>
__device__ __forceinline__ void init_ring(uint32_t full0, const Operands& op) {
  using namespace sm90;
  const bool tma = op.h_mode == kTma || op.w_mode == kTma;
  for (int s = 0; s < kStages; ++s) {
    mbar_init(full0 + 8 * s, 32 + (tma ? 1 : 0));     // the staging lanes (+ the TMA arrival)
    mbar_init(full0 + 8 * (kStages + s), kConsumers / 32);  // one arrival per consumer warp
  }
  mbar_init_fence();
}

// The producer warp stages the slices of the tile at (m0, n0), ring
// iterations it, it + 1, ... (it counts on across a block's tiles).
template <int kStages>
__device__ __forceinline__ void produce(uint8_t* ring, uint32_t full0, const CUtensorMap* hmap,
                                        const CUtensorMap* wmap, const Operands& op, int m0,
                                        int n0, int& it, int lane) {
  using namespace sm90;
  const uint32_t empty0 = full0 + 8 * kStages;
  const bool tma = op.h_mode == kTma || op.w_mode == kTma;
  const bool element = op.h_mode == kElement1 || op.h_mode == kElement2 ||
                       op.w_mode == kElement1 || op.w_mode == kElement2;
  const uint32_t tx = (op.w_mode == kTma ? kW : 0) + (op.h_mode == kTma ? kH : 0);
  const int rows = min(BM, op.N - m0);
  const int cols = min(BN, op.K - n0);
  const size_t ld = static_cast<size_t>(op.Hj) * 2;
  const auto swizzled = [](int r, int b) { return swz128(r, b, 0); };
  for (int k0 = 0; k0 < op.Hj; k0 += BK, ++it) {
    const int s = it % kStages;
    const uint32_t full = full0 + 8 * s;
    mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
    uint8_t* st = ring + s * kStage;
    const int k_valid = min(BK, op.Hj - k0);
    if (tma && lane == 0) {
      mbar_arrive_expect_tx(full, tx);
      if (op.w_mode == kTma) tma_load_2d(smem_addr(st), wmap, k0, n0, full);
      if (op.h_mode == kTma) tma_load_2d(smem_addr(st + kW), hmap, k0, m0, full);
    }
    if (op.w_mode != kTma)
      stage_box(op.w_mode, st, op.wt + (static_cast<size_t>(n0) * op.Hj + k0) * 2, ld, BN,
                BK * 2, cols, k_valid * 2, lane, swizzled);
    if (op.h_mode != kTma)
      stage_box(op.h_mode, st + kW, op.h + (static_cast<size_t>(m0) * op.Hj + k0) * 2, ld, BM,
                BK * 2, rows, k_valid * 2, lane, swizzled);
    if (element) {  // plain stores: published by the arrival's release
      cp_async_wait_all();
      mbar_arrive(full);
    } else {
      mbar_arrive_cp_async(full);
    }
  }
}

// A consumer warpgroup's products for one tile: acc = its 64 rows x BN of
// h . wt^T over all of Hj, from ring iterations it, it + 1, ... Every stage
// it read is freed on return.
// - kFlush (the forward): per slice and 128-column half, four m64n128k16
//   wgmmas sum into `part` (the first overwriting it), and part is added
//   into acc in registers, rounded to nearest, so the tensor cores'
//   truncating fp32 sums drift only over one slice's 4 k16 steps. The row
//   sums of exp(z) are held to 1e-5, and with one accumulator over all of
//   Hj = 1,024 they drifted by 1.9e-5 (z up to ~17 at the kernel tests'
//   inputs). The other warpgroup's wgmmas run while this one adds. It costs
//   ~20% against the single accumulator (601 against 744 TFLOP/s of the
//   products alone, H100 80GB HBM3, 700 W).
// - else (the derivation, whose outputs are held to 1e-3 or one bf16 step):
//   four m64n256k16 wgmmas per slice into acc itself, the slice before the
//   last waited for (wgmma.wait_group 1) and its stage freed, as passa.
template <int kStages, bool kFlush>
__device__ __forceinline__ void products(float (&acc)[128], uint8_t* ring, uint32_t full0,
                                         int Hj, int& it, int wg, int lane) {
  using namespace sm90;
  const uint32_t empty0 = full0 + 8 * kStages;
  const int slices = (Hj + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if constexpr (kFlush) {
    float part[64];
    for (int s = 0; s < slices; ++s, ++it) {
      const int st = it % kStages;
      mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      const uint32_t b0 = smem_addr(ring + st * kStage);
      const uint32_t a0 = b0 + kW + wg * 64 * 128;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wgmma_fence();
        fence_regs(part);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n128k16_k(part, desc_k_b128(a0 + 32 * kk),
                             desc_k_b128(b0 + half * (BN / 2) * 128 + 32 * kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[64 * half + i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this slice's rows were read
    }
  } else {
    for (int s = 0; s < slices; ++s, ++it) {
      const int st = it % kStages;
      mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      const uint32_t b0 = smem_addr(ring + st * kStage);
      const uint32_t a0 = b0 + kW + wg * 64 * 128;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16_k(acc, desc_k_b128(a0 + 32 * kk), desc_k_b128(b0 + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (s > 0) {  // the slice before: its wgmmas are done and its rows were read
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (slices > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
  }
}

// The epilogue's operands in shared memory: the tile's 256 bias values,
// two tiles apart, so that one tile's are written while the last tile's
// may still be read.
constexpr int kBias = 2 * BN * 4;
constexpr int kStoreBuf = 16 * 144;  // a warp's store_tile buffer: 16 rows of 128 bytes + padding

// bias[n0 .. n0 + BN) (0 past K) into the tile's slot at `at`, one value
// per consumer thread; read after named_sync<kConsumers> once the products
// are done.
__device__ __forceinline__ float* stage_bias(uint8_t* at, int tile_parity, const float* bias,
                                             int n0, int K) {
  float* slot = reinterpret_cast<float*>(at) + tile_parity * BN;
  const int t = threadIdx.x;
  slot[t] = n0 + t < K ? bias[n0 + t] : 0.0f;
  return slot;
}

// A consumer warp stores its 16 rows x BN of the tile (value(i) gives the
// element of acc[i] as T) to the row-major [N, K] array `out`, rows from
// row0: through its kStoreBuf bytes at `buf`, in chunks of 128 bytes of
// each row, so that each store instruction writes whole 128-byte rows (16
// bytes a lane) where K and `out` allow it, else element by element.
template <typename T, class Value>
__device__ __forceinline__ void store_tile(T* out, int N, int K, int row0, int n0, uint8_t* buf,
                                           int lane, Value value) {
  constexpr int kE = static_cast<int>(sizeof(T));
  constexpr int kC = 128 / kE;   // columns per chunk
  constexpr int kLd = 144;       // buffer row, bytes
  constexpr int kV = 16 / kE;    // elements per 16-byte piece
  const bool vec = (static_cast<size_t>(K) * kE) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
#pragma unroll
  for (int c = 0; c < BN / kC; ++c) {
#pragma unroll
    for (int jj = 0; jj < kC / 8; ++jj) {
      const int j = c * (kC / 8) + jj;
      const int b = (8 * jj + 2 * (lane % 4)) * kE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T pair[2] = {value(4 * j + 2 * h), value(4 * j + 2 * h + 1)};
        uint8_t* at = buf + (lane / 4 + 8 * h) * kLd + b;
        if constexpr (kE == 4) *reinterpret_cast<float2*>(at) = *reinterpret_cast<float2*>(pair);
        if constexpr (kE == 2) *reinterpret_cast<uint32_t*>(at) = *reinterpret_cast<uint32_t*>(pair);
        if constexpr (kE == 1) *reinterpret_cast<uint16_t*>(at) = *reinterpret_cast<uint16_t*>(pair);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane / 8 + 4 * i;
      const int b = (lane % 8) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(buf + r * kLd + b);
      const int row = row0 + r;
      const int col = n0 + c * kC + b / kE;
      if (row < N && col < K) {
        T* dst = out + static_cast<size_t>(row) * K + col;
        if (vec && col + kV <= K) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int q = 0; q < kV; ++q)
            if (col + q < K) dst[q] = e[q];
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace prod
}  // namespace joint
