// The fused LAMB finish for Hopper (sm_90a): the counterpart of the JAX
// package's caiman_asr_tpu/training/fused_finish.py::fused_lamb_ema_update,
// which has no Pallas kernel (XLA fuses its three passes on the TPU). The
// tail of every train step: the non-finite guard, the global gradient norm
// before the clip, the clip, LAMB (Adam with bias correction, weight decay,
// the trust ratio with its zero-norm guard, the learning rate times the
// module's factor) and the EMA of the weights, as three multi-tensor passes
// over a table of leaves, one launch each:
//
//   pass 0  read g                   -> per-leaf sum of nan_to_num(g)^2
//   pass 1  read g, mu, nu, p        -> write mu', nu'; per-leaf ||p||^2, ||u||^2
//           (the direction u is formed in registers and dropped)
//   pass 2  read mu', nu', p, ema    -> write p', ema' (u recomputed)
//
// The leaf table (Leaf, cached on the device while the parameters' storage
// is unchanged) holds each leaf's pointers, its element count, its first
// chunk of kChunk elements and its lr factor. What changes from call to call
// is passed by value as a kernel parameter (Ptrs, read in place through
// __grid_constant__): each leaf's gradient in passes 0 and 1 (null: no
// gradient, taken as zeros) and its overwrite source in pass 2 (null: none;
// else p' is that value, a batch-norm running statistic, before the EMA), so
// that a call copies nothing to the card before its launch. In passes 1
// and 2 block b takes chunk b of the leaf whose chunks hold it; pass 0 runs
// a persistent grid over the same chunks (below).
//
// No atomics in any result: each chunk is reduced in a fixed order into one
// partial; in passes 1 and 2 the last block of a leaf to finish (found by
// the leaf's ticket, which it resets for the next launch) sums the leaf's
// partials in a fixed order, in double, and the last leaf to finish (the
// grid's ticket) takes the sum over the leaves; in pass 0 the last block of
// the grid does both. So two runs give the same bits. mu' and nu' are
// formed in the plain version's operation order with explicit
// round-to-nearest intrinsics (no FMA contraction), so that they equal it to
// the bit; u divides by the bias corrections as the plain version does on
// the card, by multiplying with their fp32 reciprocals.
//
// What bounds it: 52 bytes a parameter in fp32 (pass 0 reads 4, pass 1
// reads 16 and writes 8, pass 2 reads 16 and writes 8) against a few dozen
// operations: the bytes. Passes 1 and 2: one block per 4,096 elements of a
// leaf, each thread 16 of them with neighbouring threads on neighbouring
// addresses. Pass 0, whose blocks had too little to do to hide their
// set-up: a persistent grid whose warps each reduce whole chunks with
// 16-byte loads, 4 KB a warp in flight.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr long long kChunk = static_cast<long long>(kThreads) * kItems;
constexpr int kWarps = kThreads / 32;

struct Leaf {
  float* p;
  float* m;
  float* v;
  float* e;
  long long n;       // elements
  long long chunk0;  // the leaf's first chunk
  double factor;     // the module's lr factor
  long long sharded; // 1: this rank's shard of a whole tensor
};
static_assert(sizeof(Leaf) == 64, "the host builds this layout");

// Each leaf's gradient (passes 0 and 1) or overwrite source (pass 2), null
// for none: a kernel parameter of kCap entries, the first L set.
template <int kCap>
struct Ptrs {
  const float* p[kCap];
};
// the two capacities instantiated: up to kSmallCap leaves a 2 KB parameter,
// up to kLargeCap the 32 KB that CUDA 12.1 allows from Volta on
constexpr int kSmallCap = 256;
constexpr int kLargeCap = 4000;

__device__ __forceinline__ long long chunks_of(long long n) { return (n + kChunk - 1) / kChunk; }

// nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float finite(float x) {
  if (x != x) return 0.f;
  if (fabsf(x) > FLT_MAX) return x > 0.f ? FLT_MAX : -FLT_MAX;
  return x;
}

// The LAMB direction (m2 / bc1) / (sqrt(v2 / bc2) + eps) + wd * p, in the
// plain version's order; ib1, ib2: the fp32 reciprocals of bc1, bc2.
__device__ __forceinline__ float direction(float m2, float v2, float p, float ib1, float ib2,
                                           float eps, float wd) {
  float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, ib2)), eps);
  return __fadd_rn(__fdiv_rn(__fmul_rn(m2, ib1), den), __fmul_rn(wd, p));
}

// This block's leaf (the last whose first chunk is at or before it), its
// entries and its chunk's first element, in shared memory.
struct Block {
  Leaf lf;
  const float* ptr;  // the leaf's entry of the call's Ptrs
  long long base;
  int leaf;
};

__device__ void find_block(const Leaf* leaves, const float* const* ptrs, int L, Block* blk) {
  if (threadIdx.x == 0) {
    const long long b = blockIdx.x;
    int lo = 0, hi = L - 1;
    while (lo < hi) {
      int mid = (lo + hi + 1) / 2;
      if (leaves[mid].chunk0 <= b) lo = mid; else hi = mid - 1;
    }
    blk->lf = leaves[lo];
    blk->ptr = ptrs[lo];
    blk->base = (b - blk->lf.chunk0) * kChunk;
    blk->leaf = lo;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's sum of x, in a fixed order; valid in thread 0.
template <typename T>
__device__ T block_sum(T x, T* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Thread 0 has written this block's results: true in every thread of the
// block that is the `of`-th to arrive at *ticket, which it then resets.
__device__ bool last_of(unsigned* ticket, unsigned of) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == of - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Called by every block after thread 0 has written part[b * k + j] for
// j < k: the last block of this leaf writes out[leaf * k + j], the sum of
// the leaf's partials in double in a fixed order; true in the block that
// wrote the last leaf's (tickets[L]: of the leaves with elements, `live`).
template <int k>
__device__ bool leaf_sums(const Block& blk, const float* part, float* out, unsigned* tickets,
                          int L, int live) {
  __shared__ double red[kWarps];
  const long long c0 = blk.lf.chunk0, nc = chunks_of(blk.lf.n);
  if (!last_of(tickets + blk.leaf, static_cast<unsigned>(nc))) return false;
  for (int j = 0; j < k; ++j) {
    double acc = 0.0;
    for (long long c = threadIdx.x; c < nc; c += kThreads)
      acc += static_cast<double>(__ldcg(part + (c0 + c) * k + j));
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) out[blk.leaf * k + j] = static_cast<float>(acc);
  }
  return last_of(tickets + L, static_cast<unsigned>(live));
}

// ------------------------------------------------------------------ pass 0
// A persistent grid (kNormBlocksPerSM blocks of kNormThreads on each SM, as
// the occupancy API allows): block b walks the fixed, contiguous run of
// chunks [C b / G, C (b + 1) / G), its warps taking the run's chunks in
// turn, and a warp reduces a whole chunk with no barrier. A chunk's
// elements are read as 16-byte vectors, kNormVec of them a lane in flight
// before the first is used; a leaf may start at any 4-byte address (a view
// into the all-reduced flat buffer), so its elements before the first
// 16-byte boundary (0-3) belong to its chunk 0 and are read one by one, as
// is the tail past its last whole vector. Each chunk's sum lands in part[c];
// the last block to finish (one ticket a block) sums each leaf's partials in
// double in chunk order, a warp a leaf, then the grid total. The partial of a
// chunk does not depend on the grid, so neither do the bits of any sum.

constexpr int kNormThreads = 512;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormBlocksPerSM = 2;
constexpr int kNormVec = 8;  // 16-byte loads a lane issues before the first use
constexpr int kNormRounds = static_cast<int>(kChunk / (32 * 4 * kNormVec));
static_assert(kChunk == 32LL * 4 * kNormVec * kNormRounds, "a chunk is whole rounds of a warp");

// A leaf as pass 0 reads it, in shared memory.
struct NormLeaf {
  const float* g;
  long long n;
  long long chunk0;
  long long sharded;
};

// nan_to_num(x)^2: NaN -> 0, +-inf -> FLT_MAX^2 (inf in fp32, as the plain
// version's square)
__device__ __forceinline__ float sq_finite(float x) {
  const float a = x == x ? fminf(fabsf(x), FLT_MAX) : 0.f;
  return __fmul_rn(a, a);
}

__device__ __forceinline__ float sq4(float4 x) {
  return __fadd_rn(__fadd_rn(sq_finite(x.x), sq_finite(x.y)),
                   __fadd_rn(sq_finite(x.z), sq_finite(x.w)));
}

// Chunk k of a leaf of n elements at g, reduced by one warp: its sum of
// nan_to_num(g)^2, in every lane. A round's 32 squares a lane are summed
// pairwise before they join the lane's sum.
__device__ float chunk_sq(const float* __restrict__ g, long long n, long long k, int lane) {
  const int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(g) & 15u)) & 15u) >> 2);
  const long long s0 = head < n ? head : n;  // the body starts 16-byte aligned
  const long long lo = s0 + k * kChunk, hi = lo + kChunk < n ? lo + kChunk : n;
  float acc = k == 0 && lane < s0 ? sq_finite(__ldg(g + lane)) : 0.f;
  if (hi - lo == kChunk) {
    const float4* v = reinterpret_cast<const float4*>(g + lo) + lane;
#pragma unroll
    for (int r = 0; r < kNormRounds; ++r) {
      float4 x[kNormVec];
#pragma unroll
      for (int u = 0; u < kNormVec; ++u) x[u] = __ldg(v + (r * kNormVec + u) * 32);
      float t[kNormVec];
#pragma unroll
      for (int u = 0; u < kNormVec; ++u) t[u] = sq4(x[u]);
#pragma unroll
      for (int w = 1; w < kNormVec; w *= 2)
#pragma unroll
        for (int u = 0; u < kNormVec; u += 2 * w) t[u] = __fadd_rn(t[u], t[u + w]);
      acc = __fadd_rn(acc, t[0]);
    }
  } else if (hi > lo) {  // the leaf's last chunk
    const long long nv = (hi - lo) >> 2;
    const float4* v = reinterpret_cast<const float4*>(g + lo);
    for (long long q = lane; q < nv; q += 32) acc = __fadd_rn(acc, sq4(__ldg(v + q)));
    const long long t = lo + 4 * nv + lane;  // the 0-3 elements past the last vector
    if (t < hi) acc = __fadd_rn(acc, sq_finite(__ldg(g + t)));
  }
  return warp_sum(acc);
}

template <int kCap>
__global__ void __launch_bounds__(kNormThreads, kNormBlocksPerSM)
norms_kernel(const Leaf* __restrict__ leaves, const __grid_constant__ Ptrs<kCap> grads, int L,
             long long chunks, float* part, float* leaf_sq, float* __restrict__ grad_sq,
             unsigned* __restrict__ ticket) {
  extern __shared__ NormLeaf tab[];  // [L]
  for (int l = threadIdx.x; l < L; l += kNormThreads)
    tab[l] = {grads.p[l], leaves[l].n, leaves[l].chunk0, leaves[l].sharded};
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long end = chunks * (blockIdx.x + 1) / gridDim.x;
  long long c = chunks * blockIdx.x / gridDim.x + warp;
  if (c < end) {
    int lo = 0, hi = L - 1;  // the leaf of the first chunk: the last to start at or before it
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tab[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    for (int l = lo; c < end; c += kNormWarps) {
      while (l + 1 < L && tab[l + 1].chunk0 <= c) ++l;
      const float s = tab[l].g ? chunk_sq(tab[l].g, tab[l].n, c - tab[l].chunk0, lane) : 0.f;
      if (lane == 0) part[c] = s;
    }
    if (lane == 0) __threadfence();
  }
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;  // zero for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int l = warp; l < L; l += kNormWarps) {  // each leaf's partials in chunk order
    const float* p = part + tab[l].chunk0;
    const long long nc = chunks_of(tab[l].n);
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (long long i = lane; i < nc; i += 32 * kNormVec) {
      float x[kNormVec];
#pragma unroll
      for (int u = 0; u < kNormVec; ++u) x[u] = i + 32 * u < nc ? __ldcg(p + i + 32 * u) : 0.f;
#pragma unroll
      for (int u = 0; u < kNormVec; ++u) acc[u & 3] += static_cast<double>(x[u]);
    }
    const double s = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (lane == 0) leaf_sq[l] = static_cast<float>(s);  // 0 for a leaf without elements
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;  // the leaves not sharded, in leaf order
    for (int l = 0; l < L; ++l)
      if (!tab[l].sharded) t += static_cast<double>(__ldcg(leaf_sq + l));
    *grad_sq = static_cast<float>(t);
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const Leaf* __restrict__ leaves, const __grid_constant__ Ptrs<kCap> grads, int L,
               int live,
               const float* __restrict__ grad_norm, int has_clip, float clip, float b1, float c1,
               float b2, float c2, float ib1, float ib2, float eps, float wd,
               float* part, float* leaf_pu, unsigned* __restrict__ tickets) {
  __shared__ Block blk;
  __shared__ float red[kWarps];
  find_block(leaves, grads.p, L, &blk);
  float cs = 1.f;  // the clip's scale
  if (has_clip) {
    const float nrm = *grad_norm;
    cs = nrm < clip ? 1.f : __fdiv_rn(clip, nrm);
  }
  const float* g = blk.ptr;
  float* m = blk.lf.m;
  float* v = blk.lf.v;
  const float* p = blk.lf.p;
  const long long n = blk.lf.n, base = blk.base;
  float accp = 0.f, accu = 0.f;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long j = base + k * kThreads + threadIdx.x;
    if (j < n) {
      const float gc = __fmul_rn(g ? finite(g[j]) : 0.f, cs);
      const float m2 = __fadd_rn(__fmul_rn(m[j], b1), __fmul_rn(c1, gc));
      const float v2 = __fadd_rn(__fmul_rn(v[j], b2), __fmul_rn(c2, __fmul_rn(gc, gc)));
      m[j] = m2;
      v[j] = v2;
      const float pj = p[j];
      const float u = direction(m2, v2, pj, ib1, ib2, eps, wd);
      accp = __fadd_rn(accp, __fmul_rn(pj, pj));
      accu = __fadd_rn(accu, __fmul_rn(u, u));
    }
  }
  const float sp = block_sum(accp, red);
  const float su = block_sum(accu, red);
  if (threadIdx.x == 0) {
    part[2 * static_cast<long long>(blockIdx.x)] = sp;
    part[2 * static_cast<long long>(blockIdx.x) + 1] = su;
  }
  if (!leaf_sums<2>(blk, part, leaf_pu, tickets, L, live)) return;
  if (threadIdx.x == 0)
    for (int l = 0; l < L; ++l)
      if (leaves[l].n == 0) leaf_pu[2 * l] = leaf_pu[2 * l + 1] = 0.f;
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const Leaf* __restrict__ leaves, const __grid_constant__ Ptrs<kCap> sources, int L,
             const float* __restrict__ leaf_pu, double lr, float ib1, float ib2, float eps,
             float wd, float ce) {
  __shared__ Block blk;
  find_block(leaves, sources.p, L, &blk);
  const float pn = __fsqrt_rn(leaf_pu[2 * blk.leaf]);
  const float un = __fsqrt_rn(leaf_pu[2 * blk.leaf + 1]);
  const float trust = (pn == 0.f || un == 0.f) ? 1.f : __fdiv_rn(pn, un);
  // (-lr * factor) in double, rounded to fp32, times the trust ratio
  const float s = __fmul_rn(static_cast<float>(-lr * blk.lf.factor), trust);
  const float* src = blk.ptr;
  float* p = blk.lf.p;
  float* e = blk.lf.e;
  const float* m = blk.lf.m;
  const float* v = blk.lf.v;
  const long long n = blk.lf.n, base = blk.base;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long j = base + k * kThreads + threadIdx.x;
    if (j < n) {
      const float pj = p[j];
      const float p2 = src ? src[j]
                           : __fadd_rn(pj, __fmul_rn(s, direction(m[j], v[j], pj, ib1, ib2,
                                                                  eps, wd)));
      const float ej = e[j];
      e[j] = __fadd_rn(ej, __fmul_rn(ce, __fsub_rn(p2, ej)));
      p[j] = p2;
    }
  }
}

int launched() { return static_cast<int>(cudaGetLastError()); }

// Pass 0's grid: blocks of kNormThreads, as many as fit on the card's SMs
// at once with L leaves in shared memory (at most kNormBlocksPerSM each).
// Returns 0 and sets *blocks, or a CUDA error.
template <int kCap>
int norms_grid(int L, int* blocks) {
  static int cached_dev = -1, cached_L = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev || L != cached_L) {
    const size_t smem = sizeof(NormLeaf) * static_cast<size_t>(L);
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(norms_kernel<kCap>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, norms_kernel<kCap>,
                                                             kNormThreads, smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_dev = dev, cached_L = L, cached_blocks = per_sm * sms;
  }
  *blocks = cached_blocks;
  return 0;
}

// The call's pointers (L of them, from the host) as a kernel parameter.
template <int kCap>
Ptrs<kCap> ptrs_of(const void* host, int L) {
  Ptrs<kCap> out{};
  std::memcpy(out.p, host, sizeof(const float*) * static_cast<size_t>(L));
  return out;
}

template <int kCap>
int launch_norms(const Leaf* leaves, const void* grads, int L, long long chunks, float* part,
                 float* leaf_sq, float* grad_sq, unsigned* ticket, cudaStream_t stream) {
  int blocks = 0;
  const int err = norms_grid<kCap>(L, &blocks);
  if (err != 0) return err;
  if (blocks > chunks) blocks = static_cast<int>(chunks);
  norms_kernel<kCap><<<blocks, kNormThreads, sizeof(NormLeaf) * static_cast<size_t>(L), stream>>>(
      leaves, ptrs_of<kCap>(grads, L), L, chunks, part, leaf_sq, grad_sq, ticket);
  return launched();
}

template <int kCap>
int launch_moments(const Leaf* leaves, const void* grads, int L, int live, long long chunks,
                   const float* grad_norm, int has_clip, float clip, float b1, float c1, float b2,
                   float c2, float ib1, float ib2, float eps, float wd, float* part,
                   float* leaf_pu, unsigned* tickets, cudaStream_t stream) {
  moments_kernel<kCap><<<static_cast<unsigned>(chunks), kThreads, 0, stream>>>(
      leaves, ptrs_of<kCap>(grads, L), L, live, grad_norm, has_clip, clip, b1, c1, b2, c2, ib1,
      ib2, eps, wd, part, leaf_pu, tickets);
  return launched();
}

template <int kCap>
int launch_apply(const Leaf* leaves, const void* sources, int L, long long chunks,
                 const float* leaf_pu, double lr, float ib1, float ib2, float eps, float wd,
                 float ce, cudaStream_t stream) {
  apply_kernel<kCap><<<static_cast<unsigned>(chunks), kThreads, 0, stream>>>(
      leaves, ptrs_of<kCap>(sources, L), L, leaf_pu, lr, ib1, ib2, eps, wd, ce);
  return launched();
}

// f(the capacity) for the smallest Ptrs that holds L leaves
template <typename F>
int by_cap(int L, F&& f) {
  if (L <= kSmallCap) return f(std::integral_constant<int, kSmallCap>{});
  if (L <= kLargeCap) return f(std::integral_constant<int, kLargeCap>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The elements a block takes: the host sizes the grid and the leaves'
// first chunks with it.
long long lamb_finish_chunk() { return kChunk; }

// The most leaves a call takes (the larger Ptrs).
int lamb_finish_max_leaves() { return kLargeCap; }

// Pass 0's grid for L leaves (blocks of its persistent grid; 0 where the
// launch would be refused).
int lamb_finish_norms_grid(int L) {
  int blocks = 0;
  const int err = by_cap(L, [&](auto cap) { return norms_grid<decltype(cap)::value>(L, &blocks); });
  return err == 0 ? blocks : 0;
}

// Pass 0 over `chunks` chunks of kChunk elements (the Leaf table's); grads:
// L host pointers (null: no gradient); part [chunks] scratch; leaf_sq [L]
// the leaves' sums of nan_to_num(g)^2 (0 for one without elements or
// gradient); grad_sq [1] their sum over the leaves not sharded; ticket: one
// uint32, zero (left zero).
int lamb_finish_norms(const void* leaves, const void* grads, int L, long long chunks, void* part,
                      void* leaf_sq, void* grad_sq, void* ticket, void* stream) {
  return by_cap(L, [&](auto cap) {
    return launch_norms<decltype(cap)::value>(
        static_cast<const Leaf*>(leaves), grads, L, chunks, static_cast<float*>(part),
        static_cast<float*>(leaf_sq), static_cast<float*>(grad_sq),
        static_cast<unsigned*>(ticket), static_cast<cudaStream_t>(stream));
  });
}

// Pass 1: mu, nu updated in place with the gradients (grads: L host
// pointers, as pass 0's) clipped by the global norm *grad_norm (when
// has_clip); part [chunks, 2] scratch; leaf_pu [L, 2] each leaf's ||p||^2
// and ||u||^2. c1 = 1 - b1, c2 = 1 - b2, ib1 = 1 / bc1 and ib2 = 1 / bc2 as
// fp32; tickets: L + 1 uint32, zero (left zero).
int lamb_finish_moments(const void* leaves, const void* grads, int L, int live, long long chunks,
                        const void* grad_norm, int has_clip, float clip, float b1, float c1,
                        float b2, float c2, float ib1, float ib2, float eps, float wd, void* part,
                        void* leaf_pu, void* tickets, void* stream) {
  return by_cap(L, [&](auto cap) {
    return launch_moments<decltype(cap)::value>(
        static_cast<const Leaf*>(leaves), grads, L, live, chunks,
        static_cast<const float*>(grad_norm), has_clip, clip, b1, c1, b2, c2, ib1, ib2, eps, wd,
        static_cast<float*>(part), static_cast<float*>(leaf_pu),
        static_cast<unsigned*>(tickets), static_cast<cudaStream_t>(stream));
  });
}

// Pass 2: p and the EMA updated in place from leaf_pu [L, 2] (the sharded
// leaves' rows all-reduced), the learning rate lr and ce = 1 - decay as
// fp32; sources: L host pointers, each leaf's overwrite source (null: none).
int lamb_finish_apply(const void* leaves, const void* sources, int L, long long chunks,
                      const void* leaf_pu, double lr, float ib1, float ib2, float eps, float wd,
                      float ce, void* stream) {
  return by_cap(L, [&](auto cap) {
    return launch_apply<decltype(cap)::value>(
        static_cast<const Leaf*>(leaves), sources, L, chunks,
        static_cast<const float*>(leaf_pu), lr, ib1, ib2, eps, wd, ce,
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
