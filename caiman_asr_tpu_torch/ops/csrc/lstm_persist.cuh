// The persistent LSTM recurrences for Hopper (sm_90a): what the forward
// (lstm_recurrence.cu, K1 and K3a) and the backward (lstm_recurrence_bwd.cu,
// K3b) share. One cooperative launch runs a whole layer. Each block owns a
// fixed run of `units` hidden units and keeps the rows of w_hh that its
// units need resident in shared memory from the first step to the last,
// as the Pallas kernels keep w_hh in VMEM (pallas_lstm.py:1-24). Steps are
// separated by one grid-wide barrier on a counter in global memory.
//
// The per-step product is out[row][b] = sum_k A[row][k] * X[b][k], with A
// the block's resident rows ([rows][K], row stride `ld`) and X the state
// the whole grid exchanges through global memory ([B][K], written by every
// block the step before): h_{t-1} (K = H) in the forward, dgates[t+1]
// (K = 4H) in the backward. Where the rows do not all fit, the first
// `res_rows` are resident and the rest are read from global memory (L2)
// every step (in fp32 staged with X): the plan's partly resident mode,
// chosen on the host by lstm_plan (lstm_kernel.py) and validated here.
//
// bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), rows as M and the
// batch as N. The contraction order inside a 32-wide k block is permuted
// the same way for A and X, so that a thread's A and X fragments are each
// one 16-byte load: lane (g = lane / 4, q = lane % 4) loads k in
// [8q, 8q + 8) of its rows and batch row, and the two mmas of the block
// take [8q, 8q + 4) and [8q + 4, 8q + 8). The 8 warps split the k blocks
// (ksplit) and the batch group (nsplit); their partial sums go to shared
// memory and are added in a fixed order, so two calls are bitwise equal.
// fp32: CUDA cores (no TF32). The group's rows of X, and the block's rows
// that are not resident, pass through shared memory in chunks of the
// contraction with cp.async, several chunks in flight, so that a step
// waits on L2 about once; each thread then sums a tile of 4 to 8 rows by 4
// or 8 batch rows over its share of k, and the shares meet in shared
// memory in a fixed order. A group holds up to 64 batch rows (the plan's),
// so that a step stages the rows that are not resident once: the L2 reads
// of the staging set fp32's pace. bf16 takes batch rows in groups of 64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace lstmp {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Batch rows a group holds at most: in bf16 64; in fp32 the plan's
// `group`, a multiple of 8 up to 64 (a step stages the rows that are not
// resident once a group). bf16's partial sums per row of red (ksplit *
// group).
constexpr int kGroupBf16 = 64;
constexpr int kRedFloatsBf16 = 256;
// The bf16 product's tiles a warp carries, a kernel's template parameters:
// kMT 16-row tiles of the block's rows (1 to 4) and kNT 8-row batch tiles
// (2 or 4), chosen from the shape by pick_tiles. fp32 takes them as the
// rows and the batch rows of a thread's tile (fp32_tile_rows,
// fp32_tile_batch).
constexpr size_t kMaxSmem = 232448;
// fp32: chunks of the contraction staged at once (kXStages - 1 in flight
// while one is summed; the chunk itself is the plan's, `chunk` floats).
constexpr int kXStages = 4;
constexpr int kPiecesPerLane = 4;  // stage pieces a lane owns in a row (see Pieces)
constexpr int kMaxPieces = 32 * kPiecesPerLane;

// Error codes the host maps to ValueError (CUDA's own are positive).
constexpr int kNotCoResident = -1;
constexpr int kBadPlan = -2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// --------------------------------------------------------------- the plan
// Row stride of the resident rows, in elements: 16-byte aligned; in bf16
// also an odd multiple of 64 bytes, so that the 16-byte fragment loads of
// 8 lanes (two rows, four k offsets) fall on distinct banks.
__host__ __device__ inline int resident_ld(int K, int esize) {
  return esize == 2 ? K + (((32 - K) % 64) + 64) % 64 : K + 4;
}
// Rows padded to whole 16-row tiles (the bf16 product's M).
__host__ __device__ inline int padded_rows(int rows) { return (rows + 15) / 16 * 16; }
// Row stride of the partial sums red[(part * group + col) * stride + row]:
// 4 past the padded rows, so that the product's stores (8 rows by 4 column
// pairs a warp) and the gate math's loads (consecutive rows) are free of
// bank conflicts.
__host__ __device__ inline int red_stride(int rows) { return padded_rows(rows) + 4; }
// fp32's product: each thread sums a tile of fp32_tile_rows(rows) rows by
// fp32_tile_batch batch rows of a group of G over one of fp32_ksplit
// interleaved parts of the contraction. The tile's rows divide the block's
// into a power of two where 8, 6 or 4 can; its batch rows are 8 where that
// leaves at most 32 parts (a chunk of 128 floats gives each one 4-column
// step), else 4.
__host__ __device__ inline int fp32_tile_rows(int rows) {
  const int tr[3] = {8, 6, 4};
  for (int i = 0; i < 3; ++i) {
    const int m = rows / tr[i];
    if (rows % tr[i] == 0 && (m & (m - 1)) == 0) return tr[i];
  }
  return rows % 8 == 0 ? 8 : 4;
}
__host__ __device__ inline int fp32_row_tiles(int rows) {
  return (rows + fp32_tile_rows(rows) - 1) / fp32_tile_rows(rows);
}
__host__ __device__ inline int fp32_tile_batch(int rows, int G) {
  return fp32_row_tiles(rows) * (G / 8) >= 8 ? 8 : 4;
}
__host__ __device__ inline int fp32_ksplit(int rows, int G) {
  const int tiles = fp32_row_tiles(rows) * (G / fp32_tile_batch(rows, G));
  return tiles < kThreads ? kThreads / tiles : 1;
}
// fp32's partial sums red[part * (G rows + 1) + col * rows + row], a part
// per k-split (the odd stride puts the parts of one output on distinct
// banks; the gate math reads consecutive rows).
__host__ __device__ inline int fp32_part_stride(int rows, int G) { return G * rows + 1; }
// fp32's chunk stages: kXStages of [G + rows - res_rows][chunk + 4] floats
// (the group's rows of X, then the rows that are not resident; the row
// stride puts consecutive 16-byte loads on distinct banks).
__host__ __device__ inline size_t xstage_bytes(int rows, int res_rows, int chunk, int G) {
  return sizeof(float) * kXStages * (G + rows - res_rows) * static_cast<size_t>(chunk + 4);
}
// A block's scratch: bf16's partial sums; in fp32 the chunk stages, whose
// space the partial sums take once a product has read its last chunk.
__host__ __device__ inline size_t scratch_bytes(int rows, int res_rows, int esize, int chunk,
                                                int G) {
  if (esize == 2) return sizeof(float) * kRedFloatsBf16 * red_stride(rows);
  const size_t red = sizeof(float) * static_cast<size_t>(fp32_ksplit(rows, G)) *
                     fp32_part_stride(rows, G);
  const size_t xs = xstage_bytes(rows, res_rows, chunk, G);
  return xs > red ? xs : red;
}
// Shared memory of a block: the resident rows, two stages of the per-step
// inputs of one batch group of G rows (`stage_elems` per batch row: 4u for
// the forward's gx, 8u for the backward's), the scratch and the fp32 carry
// of the block's units over its batch rows (`carry` floats).
__host__ __device__ inline size_t smem_bytes(int rows, int res_rows, int K, int stage_elems,
                                             int esize, int carry, int chunk, int G) {
  return static_cast<size_t>(res_rows) * resident_ld(K, esize) * esize +
         2ull * G * stage_elems * esize + scratch_bytes(rows, res_rows, esize, chunk, G) +
         sizeof(float) * carry;
}

// Batch rows of each of `bsplit` slices (the grid's y), the last one fewer.
__host__ __device__ inline int batch_slice(int B, int bsplit) { return (B + bsplit - 1) / bsplit; }

// Checks a plan from the host against the shape: `blocks` blocks of
// `units` units cover H once, each of the `bsplit` batch slices holds a
// row, fp32 stages chunks of a multiple of 32 floats (bf16 none) in
// groups of a multiple of 8 batch rows up to 64 (bf16 64), and the shared
// memory is what this file computes; returns 0 or kBadPlan.
inline int check_plan(int H, int B, int blocks, int bsplit, int units, int rows, int res_rows,
                      int K, int stage_elems, int esize, int chunk, int group, size_t smem) {
  if (units <= 0 || units % 4 != 0 || blocks <= 0 || bsplit <= 0) return kBadPlan;
  if (esize == 4 ? chunk <= 0 || chunk % 32 != 0 : chunk != 0) return kBadPlan;
  if (esize == 4 ? group <= 0 || group > 64 || group % 8 != 0 : group != kGroupBf16)
    return kBadPlan;
  if (stage_elems / 4 > kMaxPieces) return kBadPlan;
  if (static_cast<long>(blocks) * units < H || static_cast<long>(blocks - 1) * units >= H)
    return kBadPlan;
  if (static_cast<long>(bsplit - 1) * batch_slice(B, bsplit) >= B) return kBadPlan;
  if (res_rows < 0 || res_rows > rows) return kBadPlan;
  const int carry = batch_slice(B, bsplit) * units;
  if (smem != smem_bytes(rows, res_rows, K, stage_elems, esize, carry, chunk, group) ||
      smem > kMaxSmem)
    return kBadPlan;
  return 0;
}

// Sets the kernel's shared memory and checks that the whole grid can be
// resident at once (a cooperative launch needs it).
template <typename Kernel>
int prepare(Kernel kernel, long blocks, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  return static_cast<long>(per_sm) * sms >= blocks ? 0 : kNotCoResident;
}

// --------------------------------------------------------- synchronisation
// The step barrier: every block adds one to `ctr` with release semantics
// once its writes are done; thread 0 then spins with acquire loads until
// all blocks of this step have arrived. The counter only grows (the host
// zeroes it before the launch), so the s-th barrier waits for blocks * s.
// A wait of 2^28 polls (tens of seconds; a step takes microseconds) traps,
// so that a fault surfaces as a launch error and not as a hung card.
__device__ __forceinline__ void grid_sync(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
    unsigned v;
    for (unsigned polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
      if (v >= target) break;
      if (polls == (1u << 28)) __trap();
    }
  }
  __syncthreads();
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The per-step inputs a block stages, in pieces of 4 units (16 bytes fp32,
// 8 bytes bf16) of a batch row: lane l of each warp owns pieces l, l + 32,
// ... of every row, warp w rows w, w + 8, ...; so the costly divisions that
// place a piece are made once. A piece's source column (or -1 past H), and
// its array and place in the staged row packed as array << 20 | dst.
struct Pieces {
  int col[kPiecesPerLane], dst[kPiecesPerLane];
};

// Issues the copies of one batch group: `src(arr, row)` gives the start of
// global batch row `row` (of the step) in array `arr`; rows [0, nb) of the
// group land at stage + b * row_elems.
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows(const Pieces& pc, int npieces, int nb, int row0,
                                           int row_elems, T* stage, Src src) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kPiecesPerLane; ++k) {
    if (k * 32 >= npieces) break;
    if (pc.col[k] < 0) continue;
    const int arr = pc.dst[k] >> 20, dst = pc.dst[k] & 0xFFFFF;
    for (int b = warp; b < nb; b += kWarps)
      cp_async<4 * sizeof(T)>(stage + b * row_elems + dst, src(arr, row0 + b) + pc.col[k]);
  }
}

// ------------------------------------------------------- timing variants
// Built only for bench_lstm.phases (nvcc -D...), never for the model:
// LSTM_PHASES records the global timer of thread 0 of the first and the
// last block at four points of each of the first kPhaseItems batch groups
// (after the step barrier, after the product, after the stage's wait,
// after the gate math); LSTM_NO_EXCHANGE replaces the product's loads of
// the exchanged state by zeros, so that the two variants' product phases
// differ by what the exchange costs (its results are wrong: timing only).
constexpr int kPhaseItems = 4096;
#ifdef LSTM_PHASES
__device__ unsigned long long lstm_phase_ns[2][kPhaseItems][4];
__device__ __forceinline__ void phase(int item, int point) {
  const bool first = blockIdx.x == 0 && blockIdx.y == 0;
  const bool last = blockIdx.x == gridDim.x - 1 && blockIdx.y == gridDim.y - 1;
  if (threadIdx.x == 0 && (first || last) && item < kPhaseItems) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    lstm_phase_ns[first ? 0 : 1][item][point] = ns;
  }
}
#define LSTM_PHASE_READ                                                          \
  extern "C" int lstm_phases_read(void* dst) {                                   \
    return static_cast<int>(cudaMemcpyFromSymbol(dst, lstmp::lstm_phase_ns,      \
                                                 sizeof(lstmp::lstm_phase_ns))); \
  }
#else
__device__ __forceinline__ void phase(int, int) {}
#define LSTM_PHASE_READ
#endif
#ifdef LSTM_NO_EXCHANGE
constexpr bool kExchange = false;
#else
constexpr bool kExchange = true;
#endif

// ---------------------------------------------------------------- products
// The block's rows of a product: the first res_rows resident in shared
// memory (row stride ld), the rest read through the caller's row_ptr.
struct Rows {
  const void* smem;
  int rows, res_rows, ld, K;
};
// fp32's chunk stages (xstage_bytes), the plan's chunk and the group's
// batch rows; unused in bf16.
struct XStage {
  float* buf;
  int chunk, group;
};

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Batch-group layout of a launch: bf16 splits the 8 warps over k blocks
// (ksplit) and 32-row halves of the group (nsplit), so that a block's rows
// of w_hh are read from shared memory once per 32 batch rows of a step;
// fp32 splits the threads over tiles and fp32_ksplit parts of k, in
// groups of 16 batch rows.
struct Split {
  int group, ksplit, nsplit;
};
template <typename T, int kNT>
__device__ __forceinline__ Split split_of(int B, int rows, int G) {
  if (sizeof(T) == 4) return Split{G, fp32_ksplit(rows, G), 1};
  return B <= 8 * kNT ? Split{8 * kNT, 8, 1} : Split{16 * kNT, 4, 2};
}

// (kMT, kNT) for `rows` rows and batch slices of at most `bslice` rows.
inline void pick_tiles(int rows, int bslice, int* mt, int* nt) {
  *mt = min(4, padded_rows(rows) / 16);
  *nt = bslice <= 16 ? 2 : 4;
}

// Partial sums of out[row][b0 + col] for the block's rows and one batch
// group, into red[(part * group + col) * red_stride(rows) + row]. `row_ptr(r)` gives
// the global source of a row that is not resident, or nullptr for a row
// that is zero (a padded tile row or a unit past H).
template <int kMT, int kNT, typename RowPtr>
__device__ void product(const __nv_bfloat16* X, int B, int b0, const Rows& A, RowPtr row_ptr,
                        float* red, const XStage&) {
  const Split sp = split_of<__nv_bfloat16, kNT>(B, A.rows, kGroupBf16);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = warp % sp.ksplit, ns = warp / sp.ksplit;
  const int g = lane / 4, q = lane % 4;
  const int tiles = padded_rows(A.rows) / 16, rs = red_stride(A.rows);
  const int nk = (A.K + 31) / 32;
  // batch tiles of this warp holding a row (warp-uniform)
  const int ntiles = min(kNT, max(0, (B - b0 - ns * 8 * kNT + 7) / 8));
  const __nv_bfloat16* As = static_cast<const __nv_bfloat16*>(A.smem);
  const __nv_bfloat16* xrow[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int b = b0 + ns * 8 * kNT + nt * 8 + g;
    xrow[nt] = b < B ? X + static_cast<size_t>(b) * A.K : nullptr;
  }
  for (int m0 = 0; m0 < tiles; m0 += kMT) {
    // where each of this lane's 2 * kMT rows comes from
    const __nv_bfloat16* arow[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (m0 + mt) * 16 + h * 8 + g;
        arow[mt][h] = r >= A.rows || m0 + mt >= tiles ? nullptr
                      : r < A.res_rows ? As + static_cast<size_t>(r) * A.ld
                                       : static_cast<const __nv_bfloat16*>(row_ptr(r));
      }
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    // This warp's k blocks in rounds of kD: a round first loads all its X
    // fragments (kD * kNT 16-byte loads in flight), then runs their mmas, so
    // a step pays one L2 latency a round and not one a k block.
    constexpr int kD = kNT == 2 ? 8 : 4;
    const int nkw = (nk - ks + sp.ksplit - 1) / sp.ksplit;
    for (int i0 = 0; i0 < nkw; i0 += kD) {
      uint4 x[kD][kNT];
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const int k = (ks + (i0 + d) * sp.ksplit) * 32 + 8 * q;
        const bool ok = i0 + d < nkw && k < A.K;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          x[d][nt] = kExchange && ok && xrow[nt] ? *reinterpret_cast<const uint4*>(xrow[nt] + k)
                                                 : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (i0 + d >= nkw) break;
        const int k = (ks + (i0 + d) * sp.ksplit) * 32 + 8 * q;
        const bool kin = k < A.K;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (m0 + mt >= tiles) break;
          uint4 a[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[h] = kin && arow[mt][h] ? *reinterpret_cast<const uint4*>(arow[mt][h] + k)
                                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt >= ntiles) break;
            mma_bf16(acc[mt][nt], a[0].x, a[1].x, a[0].y, a[1].y, x[d][nt].x, x[d][nt].y);
            mma_bf16(acc[mt][nt], a[0].z, a[1].z, a[0].w, a[1].w, x[d][nt].z, x[d][nt].w);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (m0 + mt >= tiles) break;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= ntiles) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (m0 + mt) * 16 + h * 8 + g;
          const int col = ns * 8 * kNT + nt * 8 + 2 * q;
          float* dst = red + (ks * sp.group + col) * rs + row;
          dst[0] = acc[mt][nt][2 * h];
          dst[rs] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
}

// fp32: streams the contraction through the chunk stages. Stage row r < G
// holds batch row b0 + r of X (rows past the slice are left unfilled: their
// sums are never read), row G + i the block's row res_rows + i. kXStages
// - 1 chunks are in flight while one is summed; `sum(st, k0, len)` sums the
// chunk [k0, k0 + len) of stage st. Ends with every thread past its reads.
template <typename RowPtr, typename Sum>
__device__ void stream_chunks(const float* X, int B, int b0, const Rows& A, RowPtr row_ptr,
                              const XStage& xs, Sum sum) {
  const int G = xs.group, nb = min(G, B - b0), ld_s = xs.chunk + 4;
  const int srows = G + A.rows - A.res_rows;
  const int nc = (A.K + xs.chunk - 1) / xs.chunk;
  auto issue = [&](int c) {
    if (c < nc) {
      const int k0 = c * xs.chunk, pieces = min(xs.chunk, A.K - k0) / 4;
      float* st = xs.buf + (c % kXStages) * srows * ld_s;
      for (int i = threadIdx.x; i < srows * pieces; i += kThreads) {
        const int r = i / pieces, k = 4 * (i - r * pieces);
        const float* src = r >= G ? static_cast<const float*>(row_ptr(A.res_rows + r - G))
                           : kExchange && r < nb ? X + static_cast<size_t>(b0 + r) * A.K
                                                 : nullptr;
        if (src) cp_async<16>(st + r * ld_s + k, src + k0 + k);
      }
    }
    cp_async_commit();  // empty past the last chunk: the wait below counts groups
  };
#pragma unroll
  for (int c = 0; c < kXStages - 1; ++c) issue(c);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kXStages - 2>();  // chunk c (and the older stage of gx) landed
    __syncthreads();                // for every thread; and chunk c - 1 is summed
    issue(c + kXStages - 1);        // into chunk c - 1's stage
    sum(xs.buf + (c % kXStages) * srows * ld_s, c * xs.chunk, min(xs.chunk, A.K - c * xs.chunk));
  }
  __syncthreads();
}

// fp32 on CUDA cores (no TF32): thread t sums the tile (row tile, batch
// tile) = t / S of kTR rows by kTB batch rows over the 4-column steps
// t % S, t % S + S, ... of each chunk (S = fp32_ksplit), as outer products
// of 16-byte loads from shared memory: a step's kTR + kTB loads feed
// 4 kTR kTB FMAs, and the 32 lanes of a warp read 32 consecutive 16-byte
// pieces of a row. The FMAs go column by column of the step, consecutive
// ones on different sums. A tile's rows past the block's repeat its first
// row and are not stored. The parts go to red
// (fp32_part_stride) once the last chunk is read, over the chunk stages.
template <int kTR, int kTB, typename RowPtr>
__device__ void product(const float* X, int B, int b0, const Rows& A, RowPtr row_ptr,
                        float* red, const XStage& xs) {
  const int G = xs.group, bt = G / kTB;
  const int row_tiles = (A.rows + kTR - 1) / kTR, S = fp32_ksplit(A.rows, G);
  const int tile = threadIdx.x / S, s = threadIdx.x % S;
  const bool active = tile < row_tiles * bt;
  const int tr0 = (tile / bt) * kTR, tb0 = (tile % bt) * kTB;
  const int ld_s = xs.chunk + 4;
  const float* As = static_cast<const float*>(A.smem);
  float acc[kTR][kTB];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTB; ++j) acc[i][j] = 0.0f;
  stream_chunks(X, B, b0, A, row_ptr, xs, [&](const float* st, int k0, int len) {
    if (!active) return;
    const float* arow[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = tr0 + i < A.rows ? tr0 + i : tr0;
      arow[i] = r < A.res_rows ? As + static_cast<size_t>(r) * A.ld + k0
                               : st + (G + r - A.res_rows) * ld_s;
    }
    const float* xrow = st + tb0 * ld_s;
    for (int k = 4 * s; k < len; k += 4 * S) {
      float4 x[kTB], w[kTR];
#pragma unroll
      for (int j = 0; j < kTB; ++j)
        x[j] = *reinterpret_cast<const float4*>(xrow + j * ld_s + k);
#pragma unroll
      for (int i = 0; i < kTR; ++i) w[i] = *reinterpret_cast<const float4*>(arow[i] + k);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(w[i].x, x[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(w[i].y, x[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(w[i].z, x[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(w[i].w, x[j].w, acc[i][j]);
    }
  });
  if (!active) return;
  float* part = red + s * fp32_part_stride(A.rows, G) + tb0 * A.rows + tr0;
#pragma unroll
  for (int i = 0; i < kTR; ++i)
    if (tr0 + i < A.rows)
#pragma unroll
      for (int j = 0; j < kTB; ++j) part[j * A.rows + i] = acc[i][j];
}

// The block's sum for (row, col) of the group, its parts added in order
// (a count known at compile time, so that all the loads issue at once).
template <int kParts>
__device__ __forceinline__ float sum_parts(const float* at, int part_stride) {
  float part[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) part[p] = at[p * part_stride];
  float v = 0.0f;
#pragma unroll
  for (int p = 0; p < kParts; ++p) v += part[p];
  return v;
}
template <typename T>
__device__ __forceinline__ float reduced(const float* red, const Split& sp, int rows, int row,
                                         int col) {
  if constexpr (sizeof(T) == 4) {  // fp32_ksplit parts: four running sums, then their sum
    const int ps = fp32_part_stride(rows, sp.group);
    const float* at = red + col * rows + row;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int p = 0;
    for (; p + 4 <= sp.ksplit; p += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] += at[(p + q) * ps];
    }
    for (; p < sp.ksplit; ++p) v[0] += at[p * ps];
    return (v[0] + v[1]) + (v[2] + v[3]);
  } else {
    const int rs = red_stride(rows);
    const float* at = red + col * rs + row;
    return sp.ksplit == 8 ? sum_parts<8>(at, sp.group * rs) : sum_parts<4>(at, sp.group * rs);
  }
}

// Copies the resident rows into shared memory once; `row_src(r)` gives a
// row's K elements in global memory (nullptr: leave it, it is never read).
template <typename T, typename RowSrc>
__device__ void load_resident(T* dst, int res_rows, int ld, int K, RowSrc row_src) {
  constexpr int N = 16 / sizeof(T);
  const int per_row = K / N;
  for (int i = threadIdx.x; i < res_rows * per_row; i += kThreads) {
    const int r = i / per_row, k = (i % per_row) * N;
    const T* src = row_src(r);
    if (src) *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + k) =
                 *reinterpret_cast<const uint4*>(src + k);
  }
  __syncthreads();
}

}  // namespace lstmp
