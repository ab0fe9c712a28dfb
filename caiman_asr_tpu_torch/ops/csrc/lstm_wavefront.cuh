// The persistent wavefront LSTM for Hopper (sm_90a): what the forward
// (lstm_wavefront.cu, K8-fwd) and the backward (lstm_wavefront_bwd.cu,
// K8-bwd) share. It carries the design of the per-layer kernels
// (lstm_persist.cuh, whose barrier, occupancy check, copies and mma it
// uses) across the G layers of the wavefront:
//
// - One cooperative launch runs every superstep of a call; supersteps are
//   separated by one grid barrier (lstmp::grid_sync). A layer outside its
//   window still arrives at every barrier.
// - The grid is split over the layers in proportion to their weights: the
//   plan's type A (the forward's layer 0, 4H rows of length H; the
//   backward's top layer, H rows of w_hh^T, length 4H) gets `blocks` blocks
//   and each layer of type B (the forward's inner layers, 4H rows of
//   [w_ih ; w_hh], length 2H; the backward's lower layers, H rows of
//   [w_hh^T ; w_ih^T of the layer above], length 8H) about twice as many.
//   A block owns `units` hidden units of one layer, all four gates, so the
//   gate math stays in the block.
// - A block keeps its first `res` rows resident in shared memory for the
//   whole call. The rest are streamed once a superstep, in chunks of `kc`
//   columns, through a ring of kStages stages, each filled by one bulk copy
//   (TMA) of the chunk's image, which the block itself packs from the
//   weights into a scratch buffer before its first superstep (one launch
//   does it all); the weights never change, so the ring runs ahead across
//   the gate math and the barrier into the next superstep's first chunks.
//   The exchanged state X (all batch rows of a chunk's columns) has a
//   cp.async ring of its own.
// - The product out[row][b] = sum_k A[row][k] X[b][k] walks the chunks
//   with the sums in registers. bf16: mma.sync.m16n8k16 (rows as M, batch
//   as N; the fragment layout of lstm_persist.cuh), each warp owning
//   `pairs` (16-row, 8-column) tiles and one of `wk` parts of the k blocks.
//   fp32: CUDA cores, each thread an 8 x 8 tile (rows and batch rows
//   strided, so a warp's loads fall on distinct banks) and one of `tk`
//   parts of k, the parts in adjacent lanes added by a butterfly. The sums
//   meet in shared memory in a fixed order: two calls are bitwise equal.
// - The fp32 carry (c forward, dc backward) stays in the owning block's
//   shared memory for the whole call; h_{t-1}, the handoff and the dgates
//   are exchanged through L2 (the kernels' outputs), read only after the
//   barrier and only through cp.async.cg (L2, never a stale L1 line).
//
// The host's plan (wavefront_plan in ops/wavefront_kernel.py) chooses
// blocks, units, res, kc and the warps' split per type; check_plan here
// recomputes the layout and refuses a plan that does not fit (kBadPlan).

#pragma once

#include "joint_sm90.cuh"
#include "lstm_persist.cuh"

namespace wfp {

using lstmp::kBadPlan;
using lstmp::kMaxSmem;
using lstmp::kThreads;
using lstmp::kWarps;

constexpr int kStages = 3;     // the weights' ring: kStages - 1 chunks in flight
constexpr int kMaxXStages = 8;  // X's ring: the plan's xs stages, xs - 1 chunks in flight
// A block has 8 warps: in bf16 each accumulates up to kMaxPairs mma tiles,
// in fp32 each thread an 8 x 8 tile; kAcc sums either way.
constexpr int kMaxPairs = 16;
constexpr int kTile = 8;
constexpr int kAcc = 64;
constexpr int kTypeInts = 8;   // a type in the plan: blocks, units, res, kc, xs, pairs, wk, tk

struct Type {
  int blocks, units, res, kc, xs, pairs, wk, tk;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A block of one type in shared memory (byte offsets): res resident rows of
// the full row length K (row stride ld_res); the weights' ring, kStages
// stages of srows streamed rows, and X's, xs stages of bp batch rows, both
// of row stride ld_stage and kc columns; the sums
// red[(part * bp + col) * rs + row]; the backward's own sums (two
// segments); the fp32 carry [B][units]; the forward's fp32 bias of its
// rows; the gate math's inputs of a step, naux ranges of `units` values a
// batch row; the ring's mbarriers.
struct Layout {
  int rows, rows_pad, bp, ld_res, ld_stage, srows, parts, rs, kseg, nch_seg, nch;
  size_t ring, astage, xring, xstage, red, own, carry, bias, aux, bars, total;
};

__host__ __device__ inline Layout layout(const Type& ty, int rows, int K, int nseg, int naux,
                                         int B, int esize) {
  Layout L;
  L.rows = rows;
  L.rows_pad = round_up(rows, 16);
  L.bp = round_up(B, 8);
  L.ld_res = lstmp::resident_ld(K, esize);
  L.ld_stage = esize == 2 ? lstmp::resident_ld(ty.kc, 2) : ty.kc + 4;
  L.srows = L.rows_pad - ty.res;
  L.parts = esize == 2 ? ty.wk : 1;
  L.rs = L.rows_pad + 4;
  L.kseg = K / nseg;
  L.nch_seg = (L.kseg + ty.kc - 1) / ty.kc;
  L.nch = nseg * L.nch_seg;
  size_t off = static_cast<size_t>(ty.res) * L.ld_res * esize;
  L.ring = off;
  L.astage = static_cast<size_t>(L.srows) * L.ld_stage * esize;
  off += kStages * L.astage;
  L.xring = off;
  L.xstage = static_cast<size_t>(L.bp) * L.ld_stage * esize;
  off += ty.xs * L.xstage;
  L.red = off;
  off += sizeof(float) * static_cast<size_t>(L.parts) * L.bp * L.rs;
  L.own = off;
  if (nseg == 2) off += sizeof(float) * static_cast<size_t>(L.bp) * L.rs;
  L.carry = off;
  off += sizeof(float) * static_cast<size_t>(ty.units) * B;
  L.bias = off;
  if (nseg == 1 && rows == 4 * ty.units) off += sizeof(float) * rows;  // the forward's
  L.aux = off;
  off += (static_cast<size_t>(naux) * ty.units * B * esize + 15) / 16 * 16;
  L.bars = off;
  off += 8 * kStages;
  L.total = off;
  return L;
}

// Checks one type against the shape: its blocks cover H once, its resident
// rows and chunk are in range, its warps' split covers the block's tiles,
// and its layout fits `smem`; returns 0 or kBadPlan.
inline int check_type(const Type& ty, int H, int B, int rows, int K, int nseg, int naux,
                      int esize, size_t smem) {
  if (ty.blocks <= 0 || ty.units <= 0 || ty.units % 2) return kBadPlan;
  if (static_cast<long>(ty.blocks) * ty.units < H ||
      static_cast<long>(ty.blocks - 1) * ty.units >= H)
    return kBadPlan;
  if (ty.res < 0 || ty.res > rows) return kBadPlan;
  if (ty.kc <= 0 || ty.kc % (esize == 2 ? 32 : 8) != 0) return kBadPlan;
  if (ty.xs < 2 || ty.xs > kMaxXStages) return kBadPlan;
  const Layout L = layout(ty, rows, K, nseg, naux, B, esize);
  if (esize == 2) {
    const int tiles = L.rows_pad / 16 * (L.bp / 8);
    if (ty.pairs < 1 || ty.pairs > kMaxPairs || ty.wk < 1 || ty.tk != 0) return kBadPlan;
    if ((tiles + ty.pairs - 1) / ty.pairs * ty.wk > kWarps) return kBadPlan;
  } else {
    const int tiles = L.rows_pad / kTile * (L.bp / kTile);
    if (ty.tk < 1 || ty.tk > 32 || (ty.tk & (ty.tk - 1)) || ty.pairs != 0 || ty.wk != 0)
      return kBadPlan;
    if (static_cast<long>(tiles) * ty.tk > kThreads) return kBadPlan;
  }
  return L.total <= smem ? 0 : kBadPlan;
}

// The shape of each type: type A (forward layer 0, backward top layer) and
// type B (the other layers). Rows per unit: 4 forward (the gates), 1
// backward; row length K and its segments (the backward's lower layers:
// own [0, 4H) and from-above [4H, 8H), summed apart); the gate math's
// inputs a step, ranges of a unit a batch row (forward: layer 0's 4 gates
// of gx, then the mask of the handoff a layer below the top writes;
// backward: the 4 gates of gs, cs, c_prev, dys, dcs and, below the top,
// the mask).
struct Shape {
  int rows, K, nseg, naux;
};
__host__ __device__ inline Shape shape_of(int type, int units, int H, bool backward) {
  if (backward) return type == 0 ? Shape{units, 4 * H, 1, 8} : Shape{units, 8 * H, 2, 9};
  return Shape{4 * units, type == 0 ? H : 2 * H, 1, type == 0 ? 5 : 1};
}

// The whole plan: both types, the grid (type A's blocks and G - 1 layers
// of type B's), and the launch's shared memory, the larger of the two
// layouts exactly; returns 0 or kBadPlan.
inline int check_plan(const Type* ty, int G, int H, int B, int esize, bool backward,
                      size_t smem) {
  if (G < 1 || smem > kMaxSmem) return kBadPlan;
  size_t need = 0;
  for (int type = 0; type < (G > 1 ? 2 : 1); ++type) {
    const Shape s = shape_of(type, ty[type].units, H, backward);
    const int err = check_type(ty[type], H, B, s.rows, s.K, s.nseg, s.naux, esize, smem);
    if (err) return err;
    const size_t total = layout(ty[type], s.rows, s.K, s.nseg, s.naux, B, esize).total;
    need = total > need ? total : need;
  }
  return need == smem ? 0 : kBadPlan;
}

// A type that streams rows needs a scratch buffer for their packed image.
template <typename T>
inline int check_packed(const Type* ty, T* const* packed, int G, int H, int B,
                        bool backward) {
  for (int type = 0; type < (G > 1 ? 2 : 1); ++type) {
    const Shape s = shape_of(type, ty[type].units, H, backward);
    if (layout(ty[type], s.rows, s.K, s.nseg, s.naux, B, sizeof(T)).srows > 0 && !packed[type])
      return kBadPlan;
  }
  return 0;
}

inline long grid_of(const Type* ty, int G) {
  return ty[0].blocks + static_cast<long>(G - 1) * (G > 1 ? ty[1].blocks : 0);
}

// ------------------------------------------------------------ device side
using joint::sm90::smem_addr;

__device__ __forceinline__ void cp_async_cg(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void st_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(dst), "r"(0) : "memory");
}
// The mma of lstm_persist.cuh, not volatile: the compiler may move it among
// the loads (its operands and sums are its only dependencies).
__device__ __forceinline__ void mma(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// chunk c of a superstep: its segment, first column in the segment,
// columns, and the columns its product walks (bf16: whole k blocks)
struct Chunk {
  int seg, col0, kc, kw;
};
__device__ __forceinline__ Chunk chunk_of(const Layout& L, int kc, int c, int esize) {
  Chunk ch;
  ch.seg = c / L.nch_seg;
  ch.col0 = (c % L.nch_seg) * kc;
  ch.kc = min(kc, L.kseg - ch.col0);
  ch.kw = esize == 2 ? round_up(ch.kc, 32) : ch.kc;
  return ch;
}

// Copies nrows rows of npc 16-byte pieces, load(row, piece) then
// store(row, piece, v). The threads span the fast dimension (the rows with
// kRowsFastest, else the pieces) in groups of 8, 16 or 32 lanes (the fewest
// idle) and step over the other; each issues kCopyUnroll loads before its
// stores, so that a block keeps up to kThreads * kCopyUnroll loads in
// flight.
template <bool kRowsFastest, typename Load, typename Store>
__device__ __forceinline__ void copy_rows(int nrows, int npc, Load load, Store store) {
  constexpr int kCopyUnroll = 8;
  const int fast_n = kRowsFastest ? nrows : npc, slow_n = kRowsFastest ? npc : nrows;
  int fw = 32;
  for (int w = 16; w >= 8; w /= 2)
    if ((fast_n + w - 1) / w * w < (fast_n + fw - 1) / fw * fw) fw = w;
  const int f = threadIdx.x & (fw - 1), s0 = threadIdx.x / fw, ss = kThreads / fw;
  for (int fi = f; fi - f < fast_n; fi += fw) {
    for (int sb = s0; sb < slow_n; sb += ss * kCopyUnroll) {
      uint4 v[kCopyUnroll];
#pragma unroll
      for (int j = 0; j < kCopyUnroll; ++j) {
        const int si = sb + j * ss;
        if (fi < fast_n && si < slow_n) v[j] = kRowsFastest ? load(fi, si) : load(si, fi);
      }
#pragma unroll
      for (int j = 0; j < kCopyUnroll; ++j) {
        const int si = sb + j * ss;
        if (fi < fast_n && si < slow_n) {
          if (kRowsFastest)
            store(fi, si, v[j]);
          else
            store(si, fi, v[j]);
        }
      }
    }
  }
}

// A block's weights, once a call, from `piece(r, seg, k)`: the 16 bytes of
// block row r, segment seg, columns [k, k + kPe) of the segment (zero for a
// row past the block's). Rows [0, res) into shared memory, zero past K up
// to whole k blocks; rows [res, rows_pad) into the block's image `pk`,
// chunk by chunk, each chunk a stage's image ([srows][ld_stage]), zero past
// the row, the chunk and the segment (a row's pieces of every chunk in one
// walk). kUnitsFastest: consecutive threads take consecutive rows (a gather
// down a column, the backward's), else consecutive pieces of a row. The
// kernels call it before the product's addresses are set, so that little
// else is live while it runs. A proxy fence then orders the image's writes
// before the ring's bulk copies (the async proxy) read it; the caller's
// next __syncthreads (Product::prefetch's) makes that block-wide.
template <typename T, bool kUnitsFastest, typename Piece>
__device__ __forceinline__ void load_weights(unsigned char* smem, T* pk, const Layout L,
                                             const Type ty, Piece piece) {
  constexpr int kPe = 16 / sizeof(T);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  T* dst = reinterpret_cast<T*>(smem);
  const int K = L.kseg * (L.nch / L.nch_seg);  // nseg is 1 or 2
  const int width = sizeof(T) == 2 ? round_up(K, 32) : K;
  copy_rows<kUnitsFastest>(ty.res, width / kPe, [&](int r, int p) {
    const int k = p * kPe, seg = k >= L.kseg;
    return k < K ? piece(r, seg, k - seg * L.kseg) : zero;
  }, [&](int r, int p, const uint4& v) {
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * L.ld_res + p * kPe) = v;
  });
  const int pps = L.ld_stage / kPe;  // pieces a stage row
  copy_rows<kUnitsFastest>(L.srows, L.nch * pps, [&](int ri, int q) {
    const int c = q / pps, k = (q - c * pps) * kPe;
    const Chunk ch = chunk_of(L, ty.kc, c, sizeof(T));
    return k < ch.kc && ty.res + ri < L.rows ? piece(ty.res + ri, ch.seg, ch.col0 + k) : zero;
  }, [&](int ri, int q, const uint4& v) {
    const int c = q / pps;
    *reinterpret_cast<uint4*>(pk + (static_cast<size_t>(c) * L.srows + ri) * L.ld_stage +
                              (q - c * pps) * kPe) = v;
  });
  asm volatile("fence.proxy.async;" ::: "memory");
}

// A block's product over its layer's rows. The rows past `res` come from
// `pk`, this block's streamed rows, which load_weights packs in the order
// the ring takes them, chunk by chunk, each chunk the image of a stage
// ([srows][ld_stage], zero past the row's end), so a stage fills with one
// bulk copy (TMA) that completes on the stage's mbarrier; X and the gate math's
// inputs come by cp.async (16 and 4 bytes). The smem addresses of a
// thread's operand rows are set once (init) and moved per chunk by the
// chunk's column (resident rows) or its stage (staged rows and X).
template <typename T>
struct Product {
  static constexpr int kPe = 16 / sizeof(T);  // elements of a 16-byte piece
  static constexpr int kRows = sizeof(T) == 2 ? kMaxPairs : kTile;
  unsigned char* smem;
  T* pk;
  Layout L;
  Type ty;
  int B, g;  // the batch, and the chunks this block has consumed
  // bf16: this warp's tiles [p0, p0 + np) and k part kp of wk; fp32: this
  // thread's tile (rt, bt) of (r8, nb8) and k part kp of tk
  int np, kp;
  bool active;
  // bf16: per tile, the addresses of the lane's rows g and g + 8 and its X
  // row; fp32: of the tile's 8 rows and 8 X rows. Bit p of res0 / res1:
  // that row is resident.
  uint32_t a0[kRows], a1[kRows], xa[kRows], res0, res1;
  int rt, bt, r8, nb8;

  __device__ void init(unsigned char* s, T* packed, const Layout& lay, const Type& t,
                       int batch) {
    smem = s;
    pk = packed;
    L = lay;
    ty = t;
    B = batch;
    g = 0;
    res0 = res1 = 0;
    const uint32_t sb = 0, ring = static_cast<uint32_t>(L.ring);  // offsets into smem
    const uint32_t xs = static_cast<uint32_t>(L.xring);
    auto addr = [&](int r, uint32_t& bit, int p) -> uint32_t {
      if (r < ty.res) {
        bit |= 1u << p;
        return sb + r * L.ld_res * sizeof(T);
      }
      return ring + (r - ty.res) * L.ld_stage * sizeof(T);
    };
    if constexpr (sizeof(T) == 2) {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, q = lane % 4;
      const int NT = L.bp / 8, tiles = L.rows_pad / 16 * NT;
      kp = warp % ty.wk;
      const int p0 = warp / ty.wk * ty.pairs;
      np = max(0, min(ty.pairs, tiles - p0));
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        const int pair = p0 + p, mt = pair / NT, nt = pair - mt * NT;
        a0[p] = addr(mt * 16 + gr, res0, p) + 16 * q;
        a1[p] = addr(mt * 16 + 8 + gr, res1, p) + 16 * q;
        xa[p] = xs + (nt * 8 + gr) * L.ld_stage * 2 + 16 * q;
      }
    } else {
      r8 = L.rows_pad / kTile;
      nb8 = L.bp / kTile;
      const int tile = threadIdx.x / ty.tk;
      kp = threadIdx.x % ty.tk;
      active = tile < r8 * nb8;
      rt = tile % r8;
      bt = tile / r8;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        a0[i] = addr(rt + i * r8, res0, i);
        xa[i] = xs + (bt + i * nb8) * L.ld_stage * 4;
      }
    }
    if (threadIdx.x == 0) {
      for (int st = 0; st < kStages; ++st) joint::sm90::mbar_init(bar(st), 1);
      joint::sm90::mbar_init_fence();
    }
  }

  // 16 bytes at byte offset `off` of the block's shared memory
  __device__ __forceinline__ uint4 lds128(uint32_t off) const {
    return *reinterpret_cast<const uint4*>(smem + off);
  }
  __device__ __forceinline__ float4 ldsf4(uint32_t off) const {
    return *reinterpret_cast<const float4*>(smem + off);
  }

  __device__ __forceinline__ uint32_t bar(int st) const {
    return smem_addr(smem + L.bars) + 8 * st;
  }

  __device__ __forceinline__ Chunk chunk(int c) const {
    return chunk_of(L, ty.kc, c, sizeof(T));
  }
  __device__ __forceinline__ T* stage(int st) const {
    return reinterpret_cast<T*>(smem + L.ring + st * L.astage);
  }
  __device__ __forceinline__ T* xstage(int xi) const {
    return reinterpret_cast<T*>(smem + L.xring + xi * L.xstage);
  }

  // chunk c's streamed rows into stage st: one bulk copy by thread 0,
  // after every thread's reads of the stage (a __syncthreads before)
  __device__ __forceinline__ void stage_a(int c, int st) const {
    if (threadIdx.x != 0 || L.srows == 0) return;
    const uint32_t bytes = static_cast<uint32_t>(L.astage), b = bar(st);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    joint::sm90::mbar_arrive_expect_tx(b, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(stage(st))), "l"(reinterpret_cast<const unsigned char*>(pk) + c * L.astage),
        "r"(bytes), "r"(b)
        : "memory");
  }
  // global chunk gc's streamed rows have landed; 2^28 polls (seconds; a
  // chunk takes microseconds) trap, so that a fault surfaces as a launch
  // error and not as a hung card
  __device__ __forceinline__ void wait_a(int gc) const {
    if (!L.srows) return;
    const uint32_t b = bar(gc % kStages), parity = (gc / kStages) & 1;
    for (unsigned polls = 0;; ++polls) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(parity)
          : "memory");
      if (done) break;
      if (polls == (1u << 28)) __trap();
    }
  }
  // Waits for every copy still in flight (the ring's run into a superstep
  // that never comes), before the block exits.
  __device__ void drain() const {
    for (int j = 0; j < kStages - 1; ++j) wait_a(g + j);
    lstmp::cp_async_wait_all();
  }
  // chunk c's columns of X's bp batch rows into X's stage c % xs (zero past
  // B and past the segment)
  template <typename X>
  __device__ __forceinline__ void stage_x(int c, X x) const {
    const Chunk ch = chunk(c);
    const int ppr = ch.kw / kPe;
    const uint32_t base = smem_addr(xstage(c % ty.xs));
    for (int i = threadIdx.x; i < L.bp * ppr; i += kThreads) {
      const int b = i / ppr, k = (i - b * ppr) * kPe, col = ch.col0 + k;
      const T* p = b < B && col < L.kseg ? x(b, ch.seg, col) : nullptr;
      const uint32_t d = base + (b * L.ld_stage + k) * sizeof(T);
      if (p)
        cp_async_cg(d, p);
      else
        st_zero16(d);
    }
  }
  // The gate math's inputs of a step: naux ranges of n values a batch row
  // (src(b, q): the range's first value, nullptr for none) into
  // aux[(b * naux + q) * units], by 4-byte copies, a warp a range.
  template <typename Src>
  __device__ __forceinline__ void stage_aux(int naux, int n, Src src) const {
    const uint32_t base = smem_addr(smem + L.aux);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int pieces = n * static_cast<int>(sizeof(T)) / 4;
    for (int i = warp; i < B * naux; i += kWarps) {
      const T* p = src(i / naux, i % naux);
      if (!p) continue;
      const uint32_t d = base + i * ty.units * sizeof(T);
      for (int k = lane; k < pieces; k += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d + 4 * k),
                     "l"(reinterpret_cast<const char*>(p) + 4 * k)
                     : "memory");
    }
  }
  __device__ __forceinline__ const T* aux(int b, int q, int naux) const {
    return reinterpret_cast<const T*>(smem + L.aux) + (b * naux + q) * ty.units;
  }

  // The first kStages - 1 chunks' streamed rows, before the first superstep
  // (after init's mbarriers are visible to every thread).
  __device__ void prefetch() {
    __syncthreads();
    for (int j = 0; j < kStages - 1; ++j) stage_a(j % L.nch, j % kStages);
  }

  // cp.async.wait_group for a count known only at run time (X's stages)
  __device__ __forceinline__ static void wait_groups(int n) {
    switch (n) {
      case 0: lstmp::cp_async_wait<0>(); break;
      case 1: lstmp::cp_async_wait<1>(); break;
      case 2: lstmp::cp_async_wait<2>(); break;
      case 3: lstmp::cp_async_wait<3>(); break;
      case 4: lstmp::cp_async_wait<4>(); break;
      case 5: lstmp::cp_async_wait<5>(); break;
      default: lstmp::cp_async_wait<6>(); break;
    }
  }

  // One superstep's product into the registers `acc`, chunk by chunk; at
  // the start of each segment past the first, `seg_end(acc)` takes the
  // sums so far (and must leave acc zero). X runs xs - 1 chunks ahead in a
  // cp.async group per chunk (the first with `aux_in()`, the gate math's
  // inputs); the weights kStages - 1 chunks ahead, across supersteps.
  // Every thread takes part.
  template <typename X, typename SegEnd, typename Aux>
  __device__ __forceinline__ void run(float* acc, X x, SegEnd seg_end, Aux aux_in) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int j = 0; j < ty.xs - 1; ++j) {
      if (j < L.nch) stage_x(j, x);
      if (j == 0) aux_in();
      lstmp::cp_async_commit();
    }
    for (int c = 0; c < L.nch; ++c) {
      wait_groups(ty.xs - 2);  // X's chunk c (and the gate inputs)
      wait_a(g + c);
      __syncthreads();  // chunk c landed for every thread; chunk c - 1 is summed
      const int cn = c + kStages - 1;
      stage_a(cn % L.nch, (g + cn) % kStages);  // the weights run into the next superstep
      if (c + ty.xs - 1 < L.nch) stage_x(c + ty.xs - 1, x);
      lstmp::cp_async_commit();
      if (c > 0 && c % L.nch_seg == 0) seg_end(acc);
      if constexpr (sizeof(T) == 2)
        sum_bf16(acc, c, (g + c) % kStages);
      else
        sum_f32(acc, c, (g + c) % kStages);
    }
    g += L.nch;
  }

  // bf16: the chunk's k blocks of this warp's k part over its tiles, the
  // tile count a template parameter (a switch a chunk) so that the loads and
  // mmas of its tiles are straight runs of code the compiler interleaves,
  // four tiles' fragments at a time.
  template <int kN>
  __device__ __forceinline__ void sum_tiles(float* acc, uint32_t kr, uint32_t ks, uint32_t kx,
                                            int kb0, int nkb) const {
    for (int kb = kb0; kb < nkb; kb += ty.wk) {
      const uint32_t o = kb * 64;
#pragma unroll
      for (int p0 = 0; p0 < kN; p0 += 4) {
        uint4 a[4], b[4], x[4];
#pragma unroll
        for (int p = p0; p < p0 + 4 && p < kN; ++p) {
          a[p - p0] = lds128(a0[p] + ((res0 >> p) & 1 ? kr : ks) + o);
          b[p - p0] = lds128(a1[p] + ((res1 >> p) & 1 ? kr : ks) + o);
          x[p - p0] = lds128(xa[p] + kx + o);
        }
#pragma unroll
        for (int p = p0; p < p0 + 4 && p < kN; ++p) {
          const uint4 &fa = a[p - p0], &fb = b[p - p0], &fx = x[p - p0];
          mma(acc + 4 * p, fa.x, fb.x, fa.y, fb.y, fx.x, fx.y);
          mma(acc + 4 * p, fa.z, fb.z, fa.w, fb.w, fx.z, fx.w);
        }
      }
    }
  }
  __device__ __forceinline__ void sum_bf16(float* acc, int c, int st) const {
    const Chunk ch = chunk(c);
    const uint32_t kr = (ch.seg * L.kseg + ch.col0) * 2;
    const uint32_t ks = st * static_cast<uint32_t>(L.astage);
    const uint32_t kx = (c % ty.xs) * static_cast<uint32_t>(L.xstage);
    const int nkb = ch.kw / 32;
    switch (np) {
      case 1: sum_tiles<1>(acc, kr, ks, kx, kp, nkb); break;
      case 2: sum_tiles<2>(acc, kr, ks, kx, kp, nkb); break;
      case 3: sum_tiles<3>(acc, kr, ks, kx, kp, nkb); break;
      case 4: sum_tiles<4>(acc, kr, ks, kx, kp, nkb); break;
      case 5: sum_tiles<5>(acc, kr, ks, kx, kp, nkb); break;
      case 6: sum_tiles<6>(acc, kr, ks, kx, kp, nkb); break;
      case 7: sum_tiles<7>(acc, kr, ks, kx, kp, nkb); break;
      case 8: sum_tiles<8>(acc, kr, ks, kx, kp, nkb); break;
      case 9: sum_tiles<9>(acc, kr, ks, kx, kp, nkb); break;
      case 10: sum_tiles<10>(acc, kr, ks, kx, kp, nkb); break;
      case 11: sum_tiles<11>(acc, kr, ks, kx, kp, nkb); break;
      case 12: sum_tiles<12>(acc, kr, ks, kx, kp, nkb); break;
      case 13: sum_tiles<13>(acc, kr, ks, kx, kp, nkb); break;
      case 14: sum_tiles<14>(acc, kr, ks, kx, kp, nkb); break;
      case 15: sum_tiles<15>(acc, kr, ks, kx, kp, nkb); break;
      case 16: sum_tiles<16>(acc, kr, ks, kx, kp, nkb); break;
      default: break;
    }
  }

  __device__ __forceinline__ void sum_f32(float* acc, int c, int st) const {
    if (!active) return;
    const Chunk ch = chunk(c);
    const int tk = ty.tk;
    const uint32_t dr = (ch.seg * L.kseg + ch.col0) * 4, ds = st * static_cast<uint32_t>(L.astage);
    const uint32_t dx = (c % ty.xs) * static_cast<uint32_t>(L.xstage);
    uint32_t ar[kTile], xr[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      ar[i] = a0[i] + ((res0 >> i) & 1 ? dr : ds);
      xr[i] = xa[i] + dx;
    }
    for (int k = 4 * kp; k < ch.kc; k += 4 * tk) {
      float4 w[kTile], x[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) w[i] = ldsf4(ar[i] + k * 4);
#pragma unroll
      for (int j = 0; j < kTile; ++j) x[j] = ldsf4(xr[j] + k * 4);
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i * kTile + j] = fmaf(w[i].x, x[j].x, acc[i * kTile + j]);
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i * kTile + j] = fmaf(w[i].y, x[j].y, acc[i * kTile + j]);
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i * kTile + j] = fmaf(w[i].z, x[j].z, acc[i * kTile + j]);
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i * kTile + j] = fmaf(w[i].w, x[j].w, acc[i * kTile + j]);
    }
  }

  // The registers' sums into red (bf16: part kp; fp32: the tk parts added
  // by a butterfly in fixed order first), then zero. Every thread takes part.
  __device__ __forceinline__ void flush(float* acc) const {
    float* red = reinterpret_cast<float*>(smem + L.red);
    if constexpr (sizeof(T) == 2) {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, q = lane % 4;
      const int NT = L.bp / 8, p0 = warp / ty.wk * ty.pairs;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        if (p >= np) break;
        const int pair = p0 + p, mt = pair / NT, nt = pair - mt * NT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + h * 8 + gr, col = nt * 8 + 2 * q;
          float* dst = red + (kp * L.bp + col) * L.rs + row;
          dst[0] = acc[4 * p + 2 * h];
          dst[L.rs] = acc[4 * p + 2 * h + 1];
        }
      }
    } else {
      for (int o = ty.tk / 2; o > 0; o /= 2)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (active && kp == 0) {
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            red[(bt + j * nb8) * L.rs + rt + i * r8] = acc[i * kTile + j];
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  }

  // The block's sum for (row, col), its parts added in order.
  __device__ __forceinline__ float sum(int row, int col) const {
    const float* red = reinterpret_cast<const float*>(smem + L.red);
    float v = 0.0f;
    for (int part = 0; part < L.parts; ++part) v += red[(part * L.bp + col) * L.rs + row];
    return v;
  }
};

}  // namespace wfp
