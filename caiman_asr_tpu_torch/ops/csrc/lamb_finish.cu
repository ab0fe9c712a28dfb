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
// chunk and its lr factor; a second table (Dyn, copied from pinned host
// memory on the stream every call) holds the gradient (null: no gradient,
// taken as zeros) and the overwrite source (null: none; else p' is that
// value, a batch-norm running statistic, before the EMA). Block b takes
// chunk b of kChunk elements of the leaf whose chunks hold it.
//
// No atomics in any result: each block reduces its chunk in a fixed order
// and writes one partial; the last block of a leaf to finish (found by the
// leaf's ticket, which it resets for the next launch) sums the leaf's
// partials in a fixed order, in double, and the last leaf to finish (the
// grid's ticket) takes the sum over the leaves, so two runs give the same
// bits and only the last leaf's sum waits for the rest of the grid. mu' and
// nu' are formed in the plain version's operation order with explicit
// round-to-nearest intrinsics (no FMA contraction), so that they equal it to
// the bit; u divides by the bias corrections as the plain version does on
// the card, by multiplying with their fp32 reciprocals.
//
// What bounds it: 52 bytes a parameter in fp32 (pass 0 reads 4, pass 1
// reads 16 and writes 8, pass 2 reads 16 and writes 8) against a few dozen
// operations: the bytes. Design: one block per 4,096 elements of a leaf,
// each thread 16 of them with neighbouring threads on neighbouring
// addresses; the table is read once per block.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

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

struct Dyn {
  const float* g;    // null: no gradient
  const float* src;  // null: no overwrite
};
static_assert(sizeof(Dyn) == 16, "the host builds this layout");

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
  Dyn dy;
  long long base;
  int leaf;
};

__device__ void find_block(const Leaf* leaves, const Dyn* dyn, int L, Block* blk) {
  if (threadIdx.x == 0) {
    const long long b = blockIdx.x;
    int lo = 0, hi = L - 1;
    while (lo < hi) {
      int mid = (lo + hi + 1) / 2;
      if (leaves[mid].chunk0 <= b) lo = mid; else hi = mid - 1;
    }
    blk->lf = leaves[lo];
    blk->dy = dyn[lo];
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

__global__ void __launch_bounds__(kThreads)
norms_kernel(const Leaf* __restrict__ leaves, const Dyn* __restrict__ dyn, int L, int live,
             float* part, float* leaf_sq, float* __restrict__ grad_sq,
             unsigned* __restrict__ tickets) {
  __shared__ Block blk;
  __shared__ float red[kWarps];
  find_block(leaves, dyn, L, &blk);
  const float* g = blk.dy.g;
  const long long n = blk.lf.n, base = blk.base;
  float acc = 0.f;
  if (g) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long j = base + k * kThreads + threadIdx.x;
      if (j < n) {
        const float x = finite(g[j]);
        acc = __fadd_rn(acc, __fmul_rn(x, x));
      }
    }
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
  if (!leaf_sums<1>(blk, part, leaf_sq, tickets, L, live)) return;
  if (threadIdx.x == 0) {
    double t = 0.0;  // the leaves not sharded, in leaf order
    for (int l = 0; l < L; ++l) {
      if (leaves[l].n == 0) leaf_sq[l] = 0.f;
      else if (!leaves[l].sharded) t += static_cast<double>(__ldcg(leaf_sq + l));
    }
    *grad_sq = static_cast<float>(t);
  }
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const Leaf* __restrict__ leaves, const Dyn* __restrict__ dyn, int L, int live,
               const float* __restrict__ grad_norm, int has_clip, float clip, float b1, float c1,
               float b2, float c2, float ib1, float ib2, float eps, float wd,
               float* part, float* leaf_pu, unsigned* __restrict__ tickets) {
  __shared__ Block blk;
  __shared__ float red[kWarps];
  find_block(leaves, dyn, L, &blk);
  float cs = 1.f;  // the clip's scale
  if (has_clip) {
    const float nrm = *grad_norm;
    cs = nrm < clip ? 1.f : __fdiv_rn(clip, nrm);
  }
  const float* g = blk.dy.g;
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

__global__ void __launch_bounds__(kThreads)
apply_kernel(const Leaf* __restrict__ leaves, const Dyn* __restrict__ dyn, int L,
             const float* __restrict__ leaf_pu, double lr, float ib1, float ib2, float eps,
             float wd, float ce) {
  __shared__ Block blk;
  find_block(leaves, dyn, L, &blk);
  const float pn = __fsqrt_rn(leaf_pu[2 * blk.leaf]);
  const float un = __fsqrt_rn(leaf_pu[2 * blk.leaf + 1]);
  const float trust = (pn == 0.f || un == 0.f) ? 1.f : __fdiv_rn(pn, un);
  // (-lr * factor) in double, rounded to fp32, times the trust ratio
  const float s = __fmul_rn(static_cast<float>(-lr * blk.lf.factor), trust);
  const float* src = blk.dy.src;
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

}  // namespace

extern "C" {

// The elements a block takes: the host sizes the grid and the leaves'
// first chunks with it.
long long lamb_finish_chunk() { return kChunk; }

// Pass 0 over `chunks` blocks, `live` of the L leaves with elements: part
// [chunks] scratch; leaf_sq [L] the leaves' sums of nan_to_num(g)^2;
// grad_sq [1] their sum over the leaves not sharded; tickets: L + 1 uint32,
// zero (left zero).
int lamb_finish_norms(const void* leaves, const void* dyn, int L, int live, long long chunks,
                      void* part, void* leaf_sq, void* grad_sq, void* tickets, void* stream) {
  norms_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Dyn*>(dyn), L, live,
      static_cast<float*>(part), static_cast<float*>(leaf_sq), static_cast<float*>(grad_sq),
      static_cast<unsigned*>(tickets));
  return launched();
}

// Pass 1: mu, nu updated in place with the gradients clipped by the global
// norm *grad_norm (when has_clip); part [chunks, 2] scratch; leaf_pu [L, 2]
// each leaf's ||p||^2 and ||u||^2. c1 = 1 - b1, c2 = 1 - b2, ib1 = 1 / bc1
// and ib2 = 1 / bc2 as fp32; tickets as pass 0's.
int lamb_finish_moments(const void* leaves, const void* dyn, int L, int live, long long chunks,
                        const void* grad_norm, int has_clip, float clip, float b1, float c1,
                        float b2, float c2, float ib1, float ib2, float eps, float wd, void* part,
                        void* leaf_pu, void* tickets, void* stream) {
  moments_kernel<<<static_cast<unsigned>(chunks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Dyn*>(dyn), L, live,
      static_cast<const float*>(grad_norm), has_clip, clip, b1, c1, b2, c2, ib1, ib2, eps, wd,
      static_cast<float*>(part), static_cast<float*>(leaf_pu), static_cast<unsigned*>(tickets));
  return launched();
}

// Pass 2: p and the EMA updated in place from leaf_pu [L, 2] (the sharded
// leaves' rows all-reduced), the learning rate lr and ce = 1 - decay as
// fp32.
int lamb_finish_apply(const void* leaves, const void* dyn, int L, long long chunks,
                      const void* leaf_pu, double lr, float ib1, float ib2, float eps, float wd,
                      float ce, void* stream) {
  apply_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Dyn*>(dyn), L,
      static_cast<const float*>(leaf_pu), lr, ib1, ib2, eps, wd, ce);
  return launched();
}

}  // extern "C"
