// The joint's two backward passes as templates over where u = exp(z) is read
// from. The sources of u and who instantiates the passes for them:
//   SlabBf16, the stored bf16 slab (or a row chunk's bf16 tile): joint_bwd.cu
//     (K5-A, K5-B, each a call), joint_bwd_fused.cu (K5-fused-u, both behind
//     one call), joint_bwd_recompute.cu (K6-derive-a's pass A, bf16 weights);
//   SlabI8, the scaled-int8 slab: joint_bwd.cu (K7-A8, K7-B8),
//     joint_bwd_fused.cu (K7-fused-u8);
//   SlabF32, a fixed-size fp32 workspace a row chunk is derived into:
//     joint_bwd_fused.cu (K6-fused), joint_bwd_recompute.cu (K6-derive-a
//     with fp32 weights; K4-A and K4-B, where it holds the softmax p itself
//     and cs below is the unscaled cb + cl).
//
// With cs = (cb + cl) exp(-denom) per row (the softmax row scale folded in
// by the caller):
//   pass A: smear[n, j] = -cs[n] * sum_k round_a(u[n, k]) w[j, k]    [N, Hj]
//   pass B: dz[n, k]    = -cs[n] u[n, k] + (label[n] == k) cl[n]
//           dw[j, k]    = sum_n h[n, j] round_to_h_dtype(dz[n, k])    [Hj, K]
//           db[k]       = sum_n dz[n, k]  (unrounded, fp32)
// The blank column's h^T cb and sum cb (pallas_joint.py:441-451) are added
// by the caller. All sums accumulate in fp32. round_a: bf16 inputs stage u
// as bf16 for the tensor cores whatever its source; fp32 inputs take u as
// it is, except from the int8 slab, whose dequantised value the TPU kernel
// rounds to bf16 for pass A whatever the weight dtype
// (pallas_joint.py:333-336). A label outside [0, K) (the caller shifted it
// to a range of columns that does not hold it) meets no column: the compare
// is signed.
//
// Design. A Hopper block cannot carry a sum across a sequential grid axis
// as the TPU kernels do, so each block owns one output tile and loops over
// the whole contraction: in pass A a [BM rows x BN of Hj] tile of smear
// looping over K; in pass B a [BM of Hj x BN of K] tile of dw looping over
// the rows. dz is built from u as it is staged in shared memory, rounded to
// h's dtype there. db is summed by the blocks of the first Hj tile: each
// thread always stages the same columns, keeps its partial sums in
// registers, and the partials of a column are added in a fixed order. No
// atomics: the results are deterministic. With ``accumulate`` pass B adds
// its tile to what dw and db hold, so a caller can walk the rows in chunks;
// the block that owns a tile is the only one that touches it.
//
// With bf16 weights both passes are Hopper kernels of their own on
// joint_sm90.cuh, wgmma fed by a producer warp's TMA or cp.async ring:
// pass B (passb below), the counterpart of _bwd_dw_kernel_u (K5-B),
// _bwd_dw_kernel_u8 (K7-B8), _bwd_dw_kernel (K4-B) and the B half of the
// fused backwards (pallas_joint.py:408, :459, :502), dz built by the
// consumers beside the tensor cores; pass A (passa below), the counterpart
// of _bwd_dh_kernel_u (K5-A), _bwd_dh_kernel_u8 (K7-A8), _bwd_dh_kernel
// (K4-A), the A half of the fused backwards and _derive_a_kernel's pass
// (pallas_joint.py:369, :388, :144, :190, :165), u and w read K-major as
// they lie. 2 N Hj K operations bound each. The fp32 passes run on the CUDA
// cores with joint_tile.cuh's synchronous tiles.

#pragma once

#include <stdint.h>

#include "joint_sm90.cuh"
#include "joint_tile.cuh"

namespace joint {

// ------------------------------------------------------------- sources of u
// at(row, col): one value, for the fp32 passes. kRoundA: the fp32 pass A
// rounds the value to bf16 (the bf16 one always does). For the bf16
// passes, which stage the raw rows themselves: raw() and kBytes (the array
// and its element size), kTmaType, unpack8(v, p) (the 8 values at p in
// shared memory, unscaled) and kScaled (multiply by the int8 slab's scale).

struct SlabBf16 {  // the stored bf16 slab [N, K]
  const __nv_bfloat16* u;
  int K;
  static constexpr bool kRoundA = false;
  static constexpr bool kScaled = false;
  static constexpr int kBytes = 2;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __host__ __device__ const void* raw() const { return u; }
  static __device__ __forceinline__ void unpack8(float (&v)[8], const uint8_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ float at(int row, int col) const {
    return to_f32(u[static_cast<size_t>(row) * K + col]);
  }
};

struct SlabI8 {  // q int8 [N, K] and one fp32 scale per (kt-wide vocab tile, row): s [K / kt, N]
  const int8_t* q;
  const float* s;
  int K;
  int N;
  int kt;  // a multiple of 8
  static constexpr bool kRoundA = true;
  static constexpr bool kScaled = true;
  static constexpr int kBytes = 1;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __host__ __device__ const void* raw() const { return q; }
  // 0x4B000000 | (q + 128) is the float 2^23 + 128 + q, so a byte permute
  // and a subtraction give q exactly, without an int-to-float conversion
  static __device__ __forceinline__ void unpack8(float (&v)[8], const uint8_t* p) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const uint32_t lo = w.x ^ 0x80808080u, hi = w.y ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + i)) - 8388736.0f;
      v[4 + i] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + i)) - 8388736.0f;
    }
  }
  __device__ __forceinline__ float scale(int row, int col) const {
    return s[static_cast<size_t>(col / kt) * N + row];
  }
  __device__ __forceinline__ float at(int row, int col) const {
    return static_cast<float>(q[static_cast<size_t>(row) * K + col]) * scale(row, col);
  }
};

struct SlabF32 {  // fp32 u [rows, K], the no-slab backward's workspace
  const float* u;
  int K;
  static constexpr bool kRoundA = false;
  static constexpr bool kScaled = false;
  static constexpr int kBytes = 4;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __host__ __device__ const void* raw() const { return u; }
  static __device__ __forceinline__ void unpack8(float (&v)[8], const uint8_t* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ float at(int row, int col) const {
    return u[static_cast<size_t>(row) * K + col];
  }
};

// ------------------------------------------------------------------ pass A
template <class U>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dh_kernel(U src,                        // u [N, K]
                    const float* __restrict__ w,  // [Hj, K]
                    const float* __restrict__ cs, // [N]
                    float* __restrict__ smear,    // [N, Hj]
                    int N, int Hj, int K) {
  __shared__ Tiles s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero(acc);
  mainloop(
      s, acc, K,
      [&](Tile& a, int k0) {
        for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
          const int r = i / BK;
          const int k = i % BK;
          const int gr = m0 + r;
          const int gk = k0 + k;
          float v = 0.0f;
          if (gr < N && gk < K) {
            v = src.at(gr, gk);
            if (U::kRoundA) v = __bfloat162float(__float2bfloat16_rn(v));
          }
          a[k][r] = v;
        }
      },
      [&](Tile& b, int k0) { load_kmajor(b, w, Hj, K, K, n0, k0); });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= N) continue;
    const float c = -cs[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Hj) smear[static_cast<size_t>(row) * Hj + col] = c * acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ pass B
template <class U>
__global__ void __launch_bounds__(kThreads)
joint_bwd_dw_kernel(const float* __restrict__ h,          // [N, Hj]
                    U src,                                // u [N, K]
                    const float* __restrict__ cs,         // [N]
                    const float* __restrict__ cl,         // [N]
                    const int* __restrict__ labels,       // [N]
                    float* __restrict__ dw,               // [Hj, K]
                    float* __restrict__ db,               // [K]
                    int N, int Hj, int K, bool accumulate) {
  static_assert(kThreads % BN == 0, "a thread stages one fixed dz column");
  __shared__ Tiles s;
  __shared__ float db_s[kThreads];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;  // Hj
  const int n0 = blockIdx.y * BN;  // K
  float db_part = 0.0f;
  float acc[TM][TN];
  zero(acc);
  mainloop(
      s, acc, N,
      [&](Tile& a, int k0) { load_mnmajor(a, h, Hj, N, Hj, m0, k0); },
      [&](Tile& b, int k0) {
        for (int i = threadIdx.x; i < BN * BK; i += kThreads) {
          const int k = i / BN;
          const int c = i % BN;
          const int row = k0 + k;
          const int col = n0 + c;
          float v = 0.0f;
          if (row < N && col < K) {
            v = -cs[row] * src.at(row, col);
            if (labels[row] == col) v += cl[row];
          }
          db_part += v;
          b[k][c] = v;
        }
      });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= Hj) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= K) continue;
      float* out = dw + static_cast<size_t>(row) * K + col;
      *out = accumulate ? *out + acc[i][j] : acc[i][j];
    }
  }
  if (blockIdx.x != 0) return;
  db_s[threadIdx.x] = db_part;
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < K) {
    float v = 0.0f;
    for (int p = threadIdx.x; p < kThreads; p += BN) v += db_s[p];
    float* out = db + n0 + threadIdx.x;
    *out = accumulate ? *out + v : v;
  }
}

// The bf16 pass B for Hopper: see the note on passb below.
namespace passb {

constexpr int BM = 128;            // Hj per block: one 64-wide panel per consumer warpgroup
constexpr int BN = 128;            // vocab columns per block
constexpr int BK = 64;             // rows per slice
constexpr int kFlushSlices = 4;    // 256 rows summed on the tensor cores per flush
constexpr int kConsumers = 256;    // two warpgroups: dz and the products
constexpr int kThreads = 384;      // + one producer warpgroup (one warp stages)
constexpr int kDzBufs = 3;         // dz of slices s - 1, s, s + 1
constexpr int kPanel = BK * 128;   // one 64-wide bf16 panel of a slice: 8 KB
constexpr int kH = 2 * kPanel;     // h's [BK x BM] slice
constexpr int kDz = 2 * kPanel;    // dz's [BK x BN] slice
constexpr int kRows = 3 * BK * 4;  // cs, cl, labels of the slice
constexpr int kScaleTiles = BN / 8;  // int8 scale tiles one block's columns can meet (kt >= 8)
constexpr int kDwLd = BN + 8;      // row of the staged dw tile, floats

// A stage of the ring: [h panels | raw u [BK][BN] | cs | cl | labels | scales].
template <class U>
struct Layout {
  static constexpr int kU = BK * BN * U::kBytes;
  static constexpr int kScales = U::kScaled ? kScaleTiles * BK * 4 : 0;
  static constexpr int kStage = sm90::align1024(kH + kU + kRows + kScales);
  static constexpr int kStages = U::kBytes == 4 ? 3 : 4;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBarriers = kRing + kDzBufs * kDz;
  static constexpr int kBytes = kBarriers + 2 * kStages * 8 + 1024;  // + slack to align the base
  static_assert(kRing >= BM * kDwLd * 4 + 16 * BN * 4, "the epilogue reuses the ring");
  static_assert(kBytes <= 232448, "more shared memory than a Hopper block has");
};

struct Params {
  const uint8_t* h;       // [N, Hj] bf16
  const float* cs;        // [N]
  const float* cl;        // [N]
  const int* labels;      // [N]
  float* dw;              // [Hj, K]
  float* db;              // [K]
  int N, Hj, K;
  int h_mode, u_mode;     // sm90::Staging of each
  int accumulate;
};

// Pass B over bf16 h: dw[j, k] = sum_n h[n, j] bf16(dz[n, k]) and db[k] =
// sum_n dz[n, k] for one [BM of Hj x BN of K] tile per block, looping over
// the rows in slices of BK. The product is 2 N Hj K operations on the
// tensor cores (bf16, fp32 sums); the bytes (h once per Hj tile group, u
// once, N Hj 2 + N K kBytes) are far below it, so it is operation-bound.
//
// Design: warp specialisation. One producer warp fills a ring of kStages
// shared-memory stages, each with a slice's h [BK x BM], its raw u
// [BK x BN] in the slab's own dtype, its cs, cl and labels (and the int8
// slab's scales); by TMA where the operand is 16-byte aligned, else by
// cp.async (8 or 4 bytes, zero-filled past the edges), else element by
// element; each stage's `full` mbarrier completes when its bytes have
// landed. Two consumer warpgroups (setmaxnreg: 224 registers each, the
// producer 56) build bf16 dz of slice s from the raw u into a 128-byte
// swizzled buffer (each thread 4 rows x 8 fixed columns, its fp32 db
// partials in registers) while the wgmmas of slice s - 1 run; then
// fence.proxy.async, a barrier of the 256, and four m64n128k16 wgmmas per
// warpgroup (A: its 64-wide panel of h, B: dz, both MN-major as they lie,
// so nothing is transposed in shared memory); wgmma.wait_group 1 frees
// slice s - 1's stage (`empty` mbarrier) and dz buffer. Three dz buffers,
// so the one written next is one both warpgroups' waits have freed.
// Drift: the tensor cores' fp32 sums truncate, so every kFlushSlices slices
// (256 rows) the running set is added, rounded to nearest, into a second
// set and restarted (scale-d 0). That flush waits for the group's last
// wgmmas only after the next slice's dz is built, so the build still
// overlaps them. Both warpgroups issue on every slice, even where the
// second Hj panel lies past Hj (those rows are never stored): ptxas waits
// for every wgmma at the end of a loop that issues them under a branch it
// cannot prove uniform, and dz would no longer overlap the tensor cores.
// The epilogue stages the tile through
// shared memory into 16-byte stores (added to dw with accumulate); db:
// the blocks of the first Hj tile add their partials in a fixed order. No
// atomics: deterministic.
template <class U>
__global__ void __launch_bounds__(kThreads, 1)
joint_bwd_dw_sm90_kernel(const __grid_constant__ CUtensorMap hmap,
                         const __grid_constant__ CUtensorMap umap, const U src,
                         const Params p) {
  using namespace sm90;
  using L = Layout<U>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // aligned by pointer arithmetic, so that accesses stay shared-memory ones
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* dz_bufs = smem + L::kRing;
  const uint32_t full0 = smem_addr(smem + L::kBarriers);
  const uint32_t empty0 = full0 + 8 * L::kStages;
  const int m0 = blockIdx.x * BM;  // Hj
  const int n0 = blockIdx.y * BN;  // K
  const int slices = (p.N + BK - 1) / BK;
  const bool tma = p.h_mode == kTma || p.u_mode == kTma;
  const bool element = (p.h_mode == kElement1 || p.h_mode == kElement2 ||
                        p.u_mode == kElement1 || p.u_mode == kElement2);
  const bool panel1 = m0 + 64 < p.Hj;  // the second 64 of the Hj tile hold any column
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 32 + (tma ? 1 : 0));
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    regs_dec<56>();
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x % 32;
      const int es = U::kBytes;
      const int h_valid = min(p.Hj - m0, BM) * 2;
      const int u_valid = min(p.K - n0, BN) * es;
      const uint32_t tx = (p.h_mode == kTma ? (panel1 ? kH : kPanel) : 0) +
                          (p.u_mode == kTma ? L::kU : 0);
      for (int it = 0; it < slices; ++it) {
        const int s = it % L::kStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / L::kStages) & 1) ^ 1);
        uint8_t* st = smem + s * L::kStage;
        const int r0 = it * BK;
        const int rows = min(BK, p.N - r0);
        if (tma && lane == 0) {
          mbar_arrive_expect_tx(full, tx);
          if (p.h_mode == kTma) {
            tma_load_2d(smem_addr(st), &hmap, m0, r0, full);
            if (panel1) tma_load_2d(smem_addr(st + kPanel), &hmap, m0 + 64, r0, full);
          }
          if (p.u_mode == kTma) tma_load_2d(smem_addr(st + kH), &umap, n0, r0, full);
        }
        if (p.h_mode != kTma)
          stage_box(p.h_mode, st, p.h + (static_cast<size_t>(r0) * p.Hj + m0) * 2,
                    static_cast<size_t>(p.Hj) * 2, BK, BM * 2, rows, h_valid, lane,
                    [](int r, int b) { return swz128(r, b, kPanel); });
        if (p.u_mode != kTma)
          stage_box(p.u_mode, st + kH,
                    static_cast<const uint8_t*>(src.raw()) +
                        (static_cast<size_t>(r0) * p.K + n0) * es,
                    static_cast<size_t>(p.K) * es, BK, BN * es, rows, u_valid, lane,
                    [](int r, int b) { return static_cast<uint32_t>(r * BN * U::kBytes + b); });
        uint8_t* row_data = st + kH + L::kU;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = lane + 32 * h2;
          const int n = r < rows ? 4 : 0;
          cp_async<4>(smem_addr(row_data + 4 * r), p.cs + r0 + (n ? r : 0), n);
          cp_async<4>(smem_addr(row_data + 4 * (BK + r)), p.cl + r0 + (n ? r : 0), n);
          cp_async<4>(smem_addr(row_data + 4 * (2 * BK + r)), p.labels + r0 + (n ? r : 0), n);
        }
        if constexpr (U::kScaled) {
          // the scales of every kt-wide tile the block's columns meet
          const int t0 = n0 / src.kt;
          const int tiles = (min(n0 + BN, p.K) - 1) / src.kt - t0 + 1;
          for (int i = lane; i < tiles * BK; i += 32) {
            const int r = i % BK;
            const int n = r < rows ? 4 : 0;
            cp_async<4>(smem_addr(row_data + kRows + 4 * i),
                        src.s + static_cast<size_t>(t0 + i / BK) * src.N + r0 + (n ? r : 0), n);
          }
        }
        if (element) {  // plain stores: published by the arrival's release
          cp_async_wait_all();
          mbar_arrive(full);
        } else {
          mbar_arrive_cp_async(full);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_inc<224>();
    const int t = threadIdx.x;
    const int wg = t / 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int cg = t % 16;     // columns n0 + 8 cg .. + 8 of dz
    const int rslot = t / 16;  // rows rslot + 16 i of a slice
    const int col0 = n0 + 8 * cg;
    int scale_tile = 0;
    if constexpr (U::kScaled)
      scale_tile = col0 < p.K ? col0 / src.kt - n0 / src.kt : 0;
    const int raw_off = kH + (rslot * BN + 8 * cg) * U::kBytes;  // in a stage
    const uint32_t dz_off = swz128(rslot, 16 * cg, kPanel);     // in a dz buffer
    float part[64], acc[64], db_part[8];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = acc[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) db_part[q] = 0.0f;

    for (int it = 0; it < slices; ++it) {
      const int s = it % L::kStages;
      mbar_wait(full0 + 8 * s, (it / L::kStages) & 1);
      const uint8_t* st = smem + s * L::kStage;
      const float* cs_s = reinterpret_cast<const float*>(st + kH + L::kU);
      const float* cl_s = cs_s + BK;
      const int* lab_s = reinterpret_cast<const int*>(cs_s + 2 * BK);
      uint8_t* dz = dz_bufs + (it % kDzBufs) * kDz;
      // dz of this slice, while the wgmmas of the last one run; rows
      // rslot + 16 i share r % 8, so the swizzled chunk is the same for all i
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rslot + 16 * i;
        float d[8];
        U::unpack8(d, st + raw_off + i * 16 * BN * U::kBytes);
        if constexpr (U::kScaled) {
          const float sc = cs_s[3 * BK + scale_tile * BK + r];
#pragma unroll
          for (int q = 0; q < 8; ++q) d[q] *= sc;
        }
        const float c = -cs_s[r];
        const float l = cl_s[r];
        const int lab = lab_s[r] - col0;  // the row's label, if it is one of these 8
#pragma unroll
        for (int q = 0; q < 8; ++q) d[q] = c * d[q];
#pragma unroll
        for (int q = 0; q < 8; ++q) d[q] += q == lab ? l : 0.0f;  // branch-free
        alignas(16) __nv_bfloat162 out[4];
#pragma unroll
        for (int q = 0; q < 8; q += 2) {
          db_part[q] += d[q];
          db_part[q + 1] += d[q + 1];
          out[q / 2] = __floats2bfloat162_rn(d[q], d[q + 1]);
        }
        *reinterpret_cast<uint4*>(dz + dz_off + i * 16 * 128) = *reinterpret_cast<const uint4*>(out);
      }
      fence_proxy_async();
      named_sync<kConsumers>(1);
      if (it % kFlushSlices == 0 && it > 0) {  // flush the group that ended with slice it - 1
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      const uint32_t a0 = smem_addr(st + wg * kPanel);
      const uint32_t b0 = smem_addr(dz);
      wgmma_fence();
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16_mn(part, desc_mn_b128(a0 + 2048 * kk, kPanel),
                            desc_mn_b128(b0 + 2048 * kk, kPanel),
                            (kk > 0 || it % kFlushSlices != 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0) {  // slice it - 1: its wgmmas are done and its rows were read
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % L::kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];

    // epilogue: the tile through shared memory (the ring is free: every
    // stage has been read), then 16-byte rows of dw
    named_sync<kConsumers>(1);
    float* tile = reinterpret_cast<float*>(smem);  // [BM][kDwLd]
    float* db_s = tile + BM * kDwLd;                // [16][BN]
    const int row_lo = 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(tile + row_lo * kDwLd + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile + (row_lo + 8) * kDwLd + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (blockIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) db_s[rslot * BN + 8 * cg + q] = db_part[q];
    }
    named_sync<kConsumers>(1);
    const bool vec = p.K % 4 == 0 && reinterpret_cast<size_t>(p.dw) % 16 == 0;
    const int c = 4 * lane;
    for (int r = warp; r < BM && m0 + r < p.Hj; r += kConsumers / 32) {
      const float4 v = *reinterpret_cast<const float4*>(tile + r * kDwLd + c);
      float* out = p.dw + static_cast<size_t>(m0 + r) * p.K + n0 + c;
      if (vec && n0 + c + 4 <= p.K) {
        float4 o = v;
        if (p.accumulate) {
          const float4 w = *reinterpret_cast<const float4*>(out);
          o.x += w.x; o.y += w.y; o.z += w.z; o.w += w.w;
        }
        *reinterpret_cast<float4*>(out) = o;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n0 + c + q < p.K) out[q] = p.accumulate ? out[q] + e[q] : e[q];
      }
    }
    if (blockIdx.x == 0 && t < BN && n0 + t < p.K) {
      float total = 0.0f;
      for (int r = 0; r < kConsumers / 16; ++r) total += db_s[r * BN + t];
      float* out = p.db + n0 + t;
      *out = p.accumulate ? *out + total : total;
    }
  }
}

// How a launch over these operands stages and tiles (for the kernel and
// for the logs): the staging of h and of u, the grid.
struct Plan {
  int h_mode, u_mode, tiles_hj, tiles_k, stages, smem;
};

template <class U>
Plan plan(const void* h, U src, int N, int Hj, int K) {
  Plan pl{sm90::kAsync4, sm90::kAsync4, (Hj + BM - 1) / BM, (K + BN - 1) / BN,
          Layout<U>::kStages, Layout<U>::kBytes};
  if (N > 0) {
    pl.h_mode = sm90::staging(h, static_cast<size_t>(Hj) * 2, 2);
    pl.u_mode = sm90::staging(src.raw(), static_cast<size_t>(K) * U::kBytes, U::kBytes);
  }
  return pl;
}

template <class U>
int launch(const void* h, U src, const float* cs, const float* cl, const int* labels,
           float* dw, float* db, int N, int Hj, int K, bool accumulate, cudaStream_t stream) {
  const Plan pl = plan(h, src, N, Hj, K);
  CUtensorMap hmap{}, umap{};  // left zero for an operand cp.async stages
  int err = 0;
  if (pl.h_mode == sm90::kTma)
    err = sm90::tensor_map_2d(&hmap, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, Hj,
                              static_cast<uint64_t>(Hj) * 2, BK, 64, true);
  if (err == 0 && pl.u_mode == sm90::kTma)
    err = sm90::tensor_map_2d(&umap, src.raw(), U::kTmaType, N, K,
                              static_cast<uint64_t>(K) * U::kBytes, BK, BN, false);
  if (err != 0) return err;
  const auto kernel = joint_bwd_dw_sm90_kernel<U>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem));
  if (err != 0) return err;
  const Params params{static_cast<const uint8_t*>(h), cs, cl, labels, dw, db, N, Hj, K,
                      pl.h_mode, pl.u_mode, accumulate ? 1 : 0};
  kernel<<<dim3(pl.tiles_hj, pl.tiles_k), kThreads, pl.smem, stream>>>(hmap, umap, src, params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace passb

// The bf16 pass A for Hopper: see the note on passa below.
namespace passa {

constexpr int BM = 128;             // rows per block: 64 per consumer warpgroup
constexpr int BN = 256;             // Hj per block: one m64n256k16 per k16 step and warpgroup
constexpr int BK = 64;              // vocab columns per slice: one 128-byte swizzled bf16 row
constexpr int kConsumers = 256;     // two warpgroups: the A operand (if built) and the products
constexpr int kThreads = 384;       // + one producer warpgroup (one warp stages)
constexpr int kA = BM * 128;        // u's bf16 [BM x BK] slice, K-major: 16 KB
constexpr int kW = BN * 128;        // w's [BN x BK] slice, K-major: 32 KB
constexpr int kScaleTiles = BK / 8; // int8 scale tiles one slice can meet (kt >= 8)
constexpr int kOutLd = BN + 8;      // row of the staged smear tile, floats

// A stage of the ring: [w | u: the bf16 A operand itself, or the raw rows
// of the int8 slab or the fp32 workspace | the int8 slab's scales]. The
// consumers build A from raw rows into buffers of their own, one for the
// slice whose products run and one for the slice being built.
template <class U>
struct Layout {
  static constexpr bool kDirect = U::kBytes == 2;  // the bf16 slab is staged as A
  static constexpr int kU = kDirect ? kA : BM * BK * U::kBytes;
  static constexpr int kScales = U::kScaled ? kScaleTiles * BM * 4 : 0;
  static constexpr int kStage = sm90::align1024(kW + kU + kScales);
  static constexpr int kStages = U::kBytes == 4 ? 3 : 4;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBuilt = kDirect ? 0 : 2 * kA;
  static constexpr int kBarriers = kRing + kBuilt;
  static constexpr int kBytes = kBarriers + 2 * kStages * 8 + 1024;  // + slack to align the base
  static_assert(kRing >= BM * kOutLd * 4, "the epilogue reuses the ring");
  static_assert(kBytes <= 232448, "more shared memory than a Hopper block has");
};

struct Params {
  const uint8_t* w;       // [Hj, K] bf16
  const float* cs;        // [N]
  float* smear;           // [N, Hj]
  int N, Hj, K;
  int u_mode, w_mode;     // sm90::Staging of each
  int tiles_hj;
};

// Pass A over bf16 w: smear[n, j] = -cs[n] sum_k bf16(u[n, k]) w[j, k] for
// one [BM rows x BN of Hj] tile per block, looping over the vocabulary in
// slices of BK. The product is 2 N Hj K operations on the tensor cores
// (bf16, fp32 sums); the bytes (u once, N K kBytes, w, smear N Hj 4) are
// far below it, so it is operation-bound.
//
// Design: warp specialisation, as passb. One producer warp fills a ring of
// kStages stages, each with a slice's w [BN x BK] and u [BM x BK] (and the
// int8 slab's scales); by TMA where the operand is 16-byte aligned, else by
// cp.async, else element by element, each stage's `full` mbarrier
// completing when its bytes have landed. u and w both hold the contraction
// index contiguous, which is wgmma's own K-major layout: TMA's 128-byte
// swizzle writes them as the descriptors read them, nothing is transposed.
// The bf16 slab is staged as the A operand itself and the consumers only
// start the products; the int8 slab (dequantised, q * s[k / kt, n], the scale looked up
// per 8-column group since a slice may straddle scale tiles) and the fp32
// workspace are staged raw, and each consumer warpgroup builds its 64 rows
// of bf16 A in the swizzle while the wgmmas of the last slice run. Two
// consumer warpgroups (setmaxnreg: 232 registers each, the producer 40)
// each run four m64n256k16 wgmmas per slice into 128 fp32 accumulators
// per thread; wgmma.wait_group 1 frees slice s - 1's stage (`empty`
// mbarrier) and built buffer. No flush: over K = 17,408 (1,088 k16 steps)
// the truncating fp32 sums stay within 1e-4 of the output's scale, and a
// second set of 128 accumulators does not fit (PERF.md has the measured
// drift). Raster: the Hj tiles of a row tile are adjacent in launch order,
// so they run in one wave and u comes from HBM once; w stays in L2. The
// epilogue scales each row by -cs and stages the tile through the freed
// ring into 16-byte stores (scalar where smear or Hj is not 16-byte
// aligned). No atomics: deterministic.
template <class U>
__global__ void __launch_bounds__(kThreads, 1)
joint_bwd_dh_sm90_kernel(const __grid_constant__ CUtensorMap umap,
                         const __grid_constant__ CUtensorMap wmap, const U src,
                         const Params p) {
  using namespace sm90;
  using L = Layout<U>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // aligned by pointer arithmetic, so that accesses stay shared-memory ones
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* built = smem + L::kRing;
  const uint32_t full0 = smem_addr(smem + L::kBarriers);
  const uint32_t empty0 = full0 + 8 * L::kStages;
  const int n0 = static_cast<int>(blockIdx.x % p.tiles_hj) * BN;  // Hj, fastest
  const int m0 = static_cast<int>(blockIdx.x / p.tiles_hj) * BM;  // rows
  const int slices = (p.K + BK - 1) / BK;
  const bool tma = p.u_mode == kTma || p.w_mode == kTma;
  const bool element = (p.u_mode == kElement1 || p.u_mode == kElement2 ||
                        p.w_mode == kElement1 || p.w_mode == kElement2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 32 + (tma ? 1 : 0));
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    regs_dec<40>();
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x % 32;
      const int es = U::kBytes;
      const int rows = min(BM, p.N - m0);
      const int hj_rows = min(BN, p.Hj - n0);
      const uint32_t tx = (p.w_mode == kTma ? kW : 0) + (p.u_mode == kTma ? L::kU : 0);
      const auto swizzled = [](int r, int b) { return swz128(r, b, 0); };
      for (int it = 0; it < slices; ++it) {
        const int s = it % L::kStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / L::kStages) & 1) ^ 1);
        uint8_t* st = smem + s * L::kStage;
        const int k0 = it * BK;
        const int k_valid = min(BK, p.K - k0);
        if (tma && lane == 0) {
          mbar_arrive_expect_tx(full, tx);
          if (p.w_mode == kTma) tma_load_2d(smem_addr(st), &wmap, k0, n0, full);
          if (p.u_mode == kTma) tma_load_2d(smem_addr(st + kW), &umap, k0, m0, full);
        }
        if (p.w_mode != kTma)
          stage_box(p.w_mode, st, p.w + (static_cast<size_t>(n0) * p.K + k0) * 2,
                    static_cast<size_t>(p.K) * 2, BN, BK * 2, hj_rows, k_valid * 2, lane,
                    swizzled);
        if (p.u_mode != kTma) {
          const uint8_t* u = static_cast<const uint8_t*>(src.raw()) +
                             (static_cast<size_t>(m0) * p.K + k0) * es;
          if constexpr (L::kDirect)
            stage_box(p.u_mode, st + kW, u, static_cast<size_t>(p.K) * es, BM, BK * es, rows,
                      k_valid * es, lane, swizzled);
          else
            stage_box(p.u_mode, st + kW, u, static_cast<size_t>(p.K) * es, BM, BK * es, rows,
                      k_valid * es, lane,
                      [](int r, int b) { return static_cast<uint32_t>(r * BK * U::kBytes + b); });
        }
        if constexpr (U::kScaled) {
          // the scales of every kt-wide tile the slice's columns meet
          const int t0 = k0 / src.kt;
          const int tiles = (k0 + k_valid - 1) / src.kt - t0 + 1;
          uint8_t* scales = st + kW + L::kU;
          for (int i = lane; i < tiles * BM; i += 32) {
            const int r = i % BM;
            const int n = r < rows ? 4 : 0;
            cp_async<4>(smem_addr(scales + 4 * i),
                        src.s + static_cast<size_t>(t0 + i / BM) * src.N + m0 + (n ? r : 0), n);
          }
        }
        if (element) {  // plain stores: published by the arrival's release
          cp_async_wait_all();
          mbar_arrive(full);
        } else {
          mbar_arrive_cp_async(full);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_inc<232>();
    const int t = threadIdx.x;
    const int wg = t / 128;
    const int warp = t / 32;
    const int lane = t % 32;
    // building A: each thread 8 fixed columns (cg) of 4 rows of its
    // warpgroup's 64; rows r + 16 i share r % 8, so one swizzled chunk
    const int cg = t % 8;
    const int r_own = 64 * wg + (t % 128) / 8;
    const uint32_t a_off = swz128(r_own, 16 * cg, 0);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    for (int it = 0; it < slices; ++it) {
      const int s = it % L::kStages;
      mbar_wait(full0 + 8 * s, (it / L::kStages) & 1);
      const uint8_t* st = smem + s * L::kStage;
      uint32_t a0;
      if constexpr (L::kDirect) {
        a0 = smem_addr(st + kW + wg * 64 * 128);
      } else {
        uint8_t* a = built + (it % 2) * kA;
        const uint8_t* raw = st + kW;
        const float* sc = nullptr;
        if constexpr (U::kScaled) {
          const int k0 = it * BK;
          const int col = k0 + 8 * cg;
          sc = reinterpret_cast<const float*>(st + kW + L::kU) +
               (col < p.K ? col / src.kt - k0 / src.kt : 0) * BM;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r_own + 16 * i;
          float v[8];
          U::unpack8(v, raw + (r * BK + 8 * cg) * U::kBytes);
          if constexpr (U::kScaled) {
            const float f = sc[r];
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] *= f;
          }
          alignas(16) __nv_bfloat162 out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
          *reinterpret_cast<uint4*>(a + a_off + i * 16 * 128) =
              *reinterpret_cast<const uint4*>(out);
        }
        fence_proxy_async();
        named_sync<128>(1 + wg);  // this warpgroup's 64 rows are built
        a0 = smem_addr(a + wg * 64 * 128);
      }
      const uint32_t b0 = smem_addr(st);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16_k(acc, desc_k_b128(a0 + 32 * kk), desc_k_b128(b0 + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0) {  // slice it - 1: its wgmmas are done and its rows were read
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % L::kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: rows scaled by -cs, the tile through shared memory (the ring
    // is free once both warpgroups are done with it), then 16-byte rows
    const int row_lo = 64 * wg + 16 * (warp % 4) + lane / 4;
    const float c_lo = m0 + row_lo < p.N ? -p.cs[m0 + row_lo] : 0.0f;
    const float c_hi = m0 + row_lo + 8 < p.N ? -p.cs[m0 + row_lo + 8] : 0.0f;
    named_sync<kConsumers>(3);
    float* tile = reinterpret_cast<float*>(smem);  // [BM][kOutLd]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(tile + row_lo * kOutLd + col) =
          make_float2(c_lo * acc[4 * j], c_lo * acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile + (row_lo + 8) * kOutLd + col) =
          make_float2(c_hi * acc[4 * j + 2], c_hi * acc[4 * j + 3]);
    }
    named_sync<kConsumers>(3);
    const bool vec = p.Hj % 4 == 0 && reinterpret_cast<size_t>(p.smear) % 16 == 0;
    for (int r = warp; r < BM && m0 + r < p.N; r += kConsumers / 32) {
      for (int c = 4 * lane; c < BN && n0 + c < p.Hj; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(tile + r * kOutLd + c);
        float* out = p.smear + static_cast<size_t>(m0 + r) * p.Hj + n0 + c;
        if (vec) {  // Hj % 4 == 0: the 4 columns are all inside
          *reinterpret_cast<float4*>(out) = v;
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n0 + c + q < p.Hj) out[q] = e[q];
        }
      }
    }
  }
}

// How a launch over these operands stages and tiles (for the kernel and
// for the logs): the staging of u and of w, the grid.
struct Plan {
  int u_mode, w_mode, tiles_rows, tiles_hj, stages, smem;
};

template <class U>
Plan plan(U src, const void* w, int N, int Hj, int K) {
  Plan pl{sm90::kAsync4, sm90::kAsync4, (N + BM - 1) / BM, (Hj + BN - 1) / BN,
          Layout<U>::kStages, Layout<U>::kBytes};
  if (K > 0) {
    pl.u_mode = sm90::staging(src.raw(), static_cast<size_t>(K) * U::kBytes, U::kBytes);
    pl.w_mode = sm90::staging(w, static_cast<size_t>(K) * 2, 2);
  }
  return pl;
}

template <class U>
int launch(U src, const void* w, const float* cs, float* smear, int N, int Hj, int K,
           cudaStream_t stream) {
  const Plan pl = plan(src, w, N, Hj, K);
  CUtensorMap umap{}, wmap{};  // left zero for an operand cp.async stages
  int err = 0;
  if (pl.u_mode == sm90::kTma)
    err = sm90::tensor_map_2d(&umap, src.raw(), U::kTmaType, N, K,
                              static_cast<uint64_t>(K) * U::kBytes, BM, BK, Layout<U>::kDirect);
  if (err == 0 && pl.w_mode == sm90::kTma)
    err = sm90::tensor_map_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, Hj, K,
                              static_cast<uint64_t>(K) * 2, BN, BK, true);
  if (err != 0) return err;
  const auto kernel = joint_bwd_dh_sm90_kernel<U>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem));
  if (err != 0) return err;
  const Params params{static_cast<const uint8_t*>(w), cs, smear, N, Hj, K,
                      pl.u_mode, pl.w_mode, pl.tiles_hj};
  const unsigned blocks = static_cast<unsigned>(pl.tiles_rows) * pl.tiles_hj;
  kernel<<<blocks, kThreads, pl.smem, stream>>>(umap, wmap, src, params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace passa

// ------------------------------------------------------------------ launches
// One launch each; dtype 0 = float32, 1 = bfloat16 (of w for pass A, of h
// for pass B). Return the CUDA error (0 on success).
template <class U>
int launch_dh(U src, const void* w, const float* cs, float* smear, int N, int Hj, int K,
              int dtype, cudaStream_t s) {
  if (N <= 0 || Hj <= 0) return 0;
  const dim3 grid((N + BM - 1) / BM, (Hj + BN - 1) / BN);
  if (dtype == 0)
    joint_bwd_dh_kernel<U><<<grid, kThreads, 0, s>>>(
        src, static_cast<const float*>(w), cs, smear, N, Hj, K);
  else if (dtype == 1)
    return passa::launch(src, w, cs, smear, N, Hj, K, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <class U>
int launch_dw(const void* h, U src, const float* cs, const float* cl, const int* labels,
              float* dw, float* db, int N, int Hj, int K, bool accumulate, int dtype,
              cudaStream_t s) {
  if (Hj <= 0 || K <= 0) return 0;
  const dim3 grid((Hj + BM - 1) / BM, (K + BN - 1) / BN);
  if (dtype == 0)
    joint_bwd_dw_kernel<U><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), src, cs, cl, labels, dw, db, N, Hj, K, accumulate);
  else if (dtype == 1)
    return passb::launch(h, src, cs, cl, labels, dw, db, N, Hj, K, accumulate, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace joint
