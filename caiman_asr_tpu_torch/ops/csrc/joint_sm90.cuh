// Hopper (sm_90a) building blocks of the joint's tensor-core kernels:
// mbarriers, TMA and cp.async staging into shared memory, warpgroup matrix
// multiplies (wgmma) reading both operands from shared memory, the
// register hand-over between a producer warpgroup and its consumers, and
// cluster barriers with loads from another block's shared memory.
// joint_bwd.cuh's two bf16 passes are built from them (pass B, passb, and
// pass A, passa), and so is joint_prod_sm90.cuh, the product of the bf16
// forward and derivation.
//
// Shared-memory operands of wgmma are stored in 128-byte-swizzled rows:
// a row is 64 bf16 (128 bytes); row r sits 128 r bytes in, and its 16-byte
// chunk c at chunk c ^ (r % 8). That is what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes into a 1024-byte-aligned destination
// and what a wgmma descriptor of layout B128 reads; swz128() gives the same
// offsets to threads that write such rows themselves (cp.async staging, a
// tile built in registers). Pass B's operands are MN-major (the M or N
// index runs along a row, the contraction over rows, in panels of 64);
// pass A's are K-major (the contraction runs along a row, 64 of it per
// slice). No operand is transposed element by element: wgmma's transpose
// bits read both as they lie (1, 1 for MN-major, 0, 0 for K-major).
//
// TMA descriptors are encoded on the host with the driver's
// cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint so that
// the library needs no -lcuda, and passed to kernels as
// `const __grid_constant__ CUtensorMap` parameters.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace joint {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int align1024(int n) { return (n + 1023) / 1024 * 1024; }

// ----------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of the given parity has completed. There is no
// watchdog (a poll count that traps): in pass B one made the kernel spill
// registers and cost it time. A pipeline's arrivals and byte counts are
// fixed by its plan, which the kernel tests cover on every staging path.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// An arrival that also expects `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// An arrival made once every cp.async this thread has issued so far has
// landed (counted in the barrier's init count).
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// ------------------------------------------------------------------ staging
// A 2-D box of a tensor map into shared memory at dst; c0 is the
// contiguous coordinate. Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// G bytes to shared memory at dst, the first src_bytes of them from src and
// the rest zero (src_bytes = 0: nothing is read).
template <int G>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  static_assert(G == 4 || G == 8 || G == 16, "cp.async moves 4, 8 or 16 bytes");
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src), "n"(G),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// How an operand whose rows are row_bytes apart is staged: by TMA when its
// base and row stride are 16-byte aligned, else by cp.async in the largest
// granule (8 or 4 bytes) both allow, else element by element (elem_bytes,
// 1 or 2) with plain loads and stores. The int8 slab at K = 600 takes
// 8-byte cp.async; a bf16 array of odd width, element copies.
enum Staging : int { kTma = 0, kElement1 = 1, kElement2 = 2, kAsync4 = 4, kAsync8 = 8 };

inline int staging(const void* p, size_t row_bytes, int elem_bytes) {
  const size_t a = reinterpret_cast<size_t>(p) | row_bytes;
  if (a % 16 == 0) return kTma;
  if (a % 8 == 0) return kAsync8;
  if (a % 4 == 0) return kAsync4;
  return elem_bytes;
}

// Byte offset of byte b of row r in a tile of 128-byte-wide swizzled
// panels, each `panel` bytes (rows x 128) long.
__host__ __device__ constexpr uint32_t swz128(int r, int b, int panel) {
  return static_cast<uint32_t>((b >> 7) * panel + r * 128 + ((((b >> 4) & 7) ^ (r & 7)) << 4) +
                               (b & 15));
}

// One warp's lanes stage a box of `rows` rows of row_bytes bytes, row r
// read from src + r * ld, into shared memory at dst + at(r, b): the first
// valid_rows rows and valid_bytes bytes of each are read, the rest is
// zero. G is the staging mode (a cp.async granule of 4 or 8 bytes, or the
// element size 1 or 2 for plain copies); each G-byte piece stays inside
// one 16-byte chunk of the destination.
template <int G, class At>
__device__ __forceinline__ void stage_box(uint8_t* dst, const uint8_t* src, size_t ld, int rows,
                                          int row_bytes, int valid_rows, int valid_bytes,
                                          int lane, At at) {
  const int per_row = row_bytes / G;
  for (int i = lane; i < rows * per_row; i += 32) {
    const int r = i / per_row;
    const int b = (i - r * per_row) * G;
    int n = r < valid_rows ? valid_bytes - b : 0;
    n = n < 0 ? 0 : (n > G ? G : n);
    const uint8_t* p = n > 0 ? src + static_cast<size_t>(r) * ld + b : src;
    if constexpr (G >= 4) {
      cp_async<G>(smem_addr(dst + at(r, b)), p, n);
    } else {
      using T = std::conditional_t<G == 2, uint16_t, uint8_t>;
      *reinterpret_cast<T*>(dst + at(r, b)) = n > 0 ? *reinterpret_cast<const T*>(p) : T(0);
    }
  }
}

// stage_box with the mode chosen at run time (mode != kTma).
template <class At>
__device__ __forceinline__ void stage_box(int mode, uint8_t* dst, const uint8_t* src, size_t ld,
                                          int rows, int row_bytes, int valid_rows,
                                          int valid_bytes, int lane, At at) {
  switch (mode) {
    case kAsync8: stage_box<8>(dst, src, ld, rows, row_bytes, valid_rows, valid_bytes, lane, at); break;
    case kAsync4: stage_box<4>(dst, src, ld, rows, row_bytes, valid_rows, valid_bytes, lane, at); break;
    case kElement2: stage_box<2>(dst, src, ld, rows, row_bytes, valid_rows, valid_bytes, lane, at); break;
    default: stage_box<1>(dst, src, ld, rows, row_bytes, valid_rows, valid_bytes, lane, at); break;
  }
}

// --------------------------------------------------------- warp roles, fences
// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier among the first kCount threads of the block (id 0 is
// __syncthreads's).
template <int kCount>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kCount) : "memory");
}

// ------------------------------------------------------------------ clusters
// The block's rank in its thread-block cluster and the cluster's index.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// A barrier over every thread of the cluster: the arrival releases this
// thread's writes to shared memory, the wait acquires the others'. Each
// thread alternates arrive and wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The address of the same shared-memory location in block `rank` of the
// cluster, and loads from it (distributed shared memory).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float cluster_load(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 cluster_load2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr)
               : "memory");
  return v;
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// --------------------------------------------------------------------- wgmma
// Descriptor of a 1024-byte-aligned MN-major operand in 128-byte-swizzled
// panels: 64 MN elements per panel, panels mn_panel bytes apart (the
// leading byte offset), groups of 8 contraction rows 1024 bytes apart (the
// stride byte offset).
__device__ __forceinline__ uint64_t desc_mn_b128(uint32_t addr, uint32_t mn_panel) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((mn_panel >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Descriptor of a 1024-byte-aligned K-major operand in 128-byte-swizzled
// rows: 64 contraction elements per row, groups of 8 rows 1024 bytes apart
// (the stride byte offset; this layout does not read the leading byte
// offset). The k16 steps of a 64-wide slice lie inside the row: step kk
// starts 32 kk bytes in (not a panel further on, as MN-major steps do); the
// hardware swizzles the addresses it forms from that start, so they match
// what TMA wrote.
__device__ __forceinline__ uint64_t desc_k_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for one warpgroup: A [64 x 16] and B [16 x 128], bf16, both
// MN-major in shared memory (transpose bits 1, 1), d fp32 in registers.
// accumulate = 0 overwrites d. Thread t of the warpgroup holds, for
// j < 16, d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and
// column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for one warpgroup: A [64 x 16] and B [16 x 128], bf16, both
// K-major in shared memory (transpose bits 0, 0), d fp32 in registers,
// laid out as wgmma_m64n128k16_mn's.
__device__ __forceinline__ void wgmma_m64n128k16_k(float (&d)[64], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for one warpgroup: A [64 x 16] and B [16 x 256], bf16, both
// K-major in shared memory (transpose bits 0, 0), d fp32 in registers.
// accumulate = 0 overwrites d. Thread t of the warpgroup holds, for
// j < 32, d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and
// column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n256k16_k(float (&d)[128], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ------------------------------------------------------- host: tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of the row-major [rows, cols] array at base (rows ld_bytes apart,
// a multiple of 16) read in boxes of box_rows x box_cols, 128-byte
// swizzled or not. Returns the CUDA error (0 on success).
inline int tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                         uint64_t rows, uint64_t cols, uint64_t ld_bytes, uint32_t box_rows,
                         uint32_t box_cols, bool swizzle128) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace joint
