// LSTM forward recurrence for Hopper (sm_90a): the counterpart of the Pallas
// TPU kernels caiman_asr_tpu/ops/pallas_lstm.py::_kernel (K1) and, with the
// kStoreGates flag, ::_kernel_sg (K3a), which also writes the full
// pre-activations gs[t] = gx[t] + h_{t-1} @ w_hh^T in the compute dtype for
// the backward recurrence (pallas_lstm.py:108).
//
// One layer, time-major: for t in [0, T)
//   gates = gx[t] + h_{t-1} @ w_hh^T          (fp32 accumulation)
//   c_t   = sig(f) * c_{t-1} + sig(i) * tnh(g)
//   h_t   = sig(o) * tnh(c_t)
// with gate order i, f, g, o; soft (sigmoid/tanh) or hard (clip(0.5 + z/8,
// 0, 1) / clip(z, -1, 1)) activations. h and c are carried in fp32; h is
// cast to the weight dtype for the product; ys[t] and cs[t] are written in
// the compute dtype (float32 or bfloat16).
//
// What bounds it: 2 B H 4H operations a step against w_hh, read once, and
// the per-step tensors; far too little to fill the card, so a layer is set
// by its T sequential steps. Design (lstm_persist.cuh): one cooperative
// launch per layer. Block x owns hidden units [x u, x u + u), all four
// gates, and copies those 4u rows of w_hh ([4H, H], torch's layout) into
// shared memory once. Step t: the block prefetches gx[t] for its columns
// with cp.async (a batch group ahead, across the step barrier), contracts
// h_{t-1} against its resident rows, runs the gate math, and writes ys[t],
// cs[t] and, with kStoreGates, gs[t]. h_{t-1} in the weight dtype is
// ys[t-1] itself (h0 at t = 0), so ys is the exchange buffer every block
// reads (in fp32 staged through shared memory chunk by chunk, with the
// rows that are not resident); c is carried in fp32 in shared memory. The
// plan (lstm_plan) may also split the batch over the grid's y (bsplit
// slices), so that a block reads only its slice's rows of the exchange.
// One grid-wide barrier a step.

#include "lstm_persist.cuh"

namespace {

using namespace lstmp;

template <typename T>
struct FwdArgs {
  const T* gx;    // [T, B, 4H]
  const T* w;     // [4H, H]
  const T* h0;    // [B, H]
  const T* c0;    // [B, H]
  T* ys;          // [T, B, H]
  T* cs;          // [T, B, H]
  T* gs;          // [T, B, 4H] (kStoreGates only)
  unsigned* ctr;  // step barrier, zero on entry
  int steps, B, H, hard, units, res_rows, chunk, group;
};

template <typename T, bool kStoreGates, int kMT, int kNT>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(const FwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int u = p.units, rows = 4 * u, H = p.H, B = p.B;
  const int u0 = blockIdx.x * u;
  const int bslice = batch_slice(B, gridDim.y), bb0 = blockIdx.y * bslice;
  const int Bl = min(bslice, B - bb0);  // this block's batch rows [bb0, bb0 + Bl)
  const int ld = resident_ld(H, sizeof(T)), G = p.group;
  T* w_s = reinterpret_cast<T*>(smem);
  T* stage = reinterpret_cast<T*>(smem + static_cast<size_t>(p.res_rows) * ld * sizeof(T));
  float* red = reinterpret_cast<float*>(stage + 2 * G * rows);  // stage: [2][G][4u]
  const XStage xs{red, p.chunk, G};  // the scratch: partial sums, and fp32's chunk stages
  float* c_s = red + scratch_bytes(rows, p.res_rows, sizeof(T), p.chunk, G) / 4;  // [Bl][u]
  for (int i = threadIdx.x; i < Bl * u; i += kThreads)
    if (u0 + i % u < H) c_s[i] = to_f32(p.c0[static_cast<size_t>(bb0 + i / u) * H + u0 + i % u]);

  // row r of the block: gate r / u of unit u0 + r % u (nullptr past H)
  auto row_src = [&](int r) -> const T* {
    const int unit = u0 + r % u;
    return unit < H ? p.w + static_cast<size_t>((r / u) * H + unit) * H : nullptr;
  };
  load_resident(w_s, p.res_rows, ld, H, row_src);
  const Rows A{w_s, rows, p.res_rows, ld, H};
  const Split sp = split_of<T, kNT>(Bl, rows, G);
  const int groups = (Bl + sp.group - 1) / sp.group;
  const int items = p.steps * groups;

  // gx[t] of a batch group for the block's 4u columns, in pieces of 4
  // units: stage[b][gate * u + j]
  Pieces pc;
#pragma unroll
  for (int k = 0; k < kPiecesPerLane; ++k) {
    const int piece = threadIdx.x % 32 + 32 * k;
    const int gate = piece / (u / 4), j = 4 * (piece % (u / 4));
    pc.col[k] = piece < u && u0 + j < H ? gate * H + u0 + j : -1;
    pc.dst[k] = gate * u + j;
  }
  auto fetch = [&](int item) {
    const int t = item / groups, b0 = (item % groups) * sp.group;
    stage_rows(pc, u, min(sp.group, Bl - b0), bb0 + b0, rows,
               stage + (item & 1) * G * rows, [&](int, int row) {
                 return p.gx + (static_cast<size_t>(t) * B + row) * 4 * H;
               });
  };
  fetch(0);
  cp_async_commit();

  for (int item = 0; item < items; ++item) {
    const int t = item / groups, b0 = (item % groups) * sp.group;
    if (item % groups == 0 && t > 0)
      grid_sync(p.ctr, gridDim.x * gridDim.y * static_cast<unsigned>(t));  // ys[t-1] done
    else
      __syncthreads();  // the previous group's reads of red and its stage are done
    phase(item, 0);
    const T* h = t == 0 ? p.h0 : p.ys + static_cast<size_t>(t - 1) * B * H;
    product<kMT, kNT>(h + static_cast<size_t>(bb0) * H, Bl, b0, A, row_src, red, xs);
    phase(item, 1);
    cp_async_wait_all();  // this item's stage, issued before the barrier
    __syncthreads();
    phase(item, 2);

    const T* gx_s = stage + (item & 1) * G * rows;
    const int nb = min(sp.group, Bl - b0);
    for (int i = threadIdx.x; i < nb * u; i += kThreads) {
      const int b = i / u, j = i % u, unit = u0 + j;
      if (unit >= H) continue;
      float gv[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        gv[gate] = to_f32(gx_s[b * rows + gate * u + j]) +
                   reduced<T>(red, sp, rows, gate * u + j, b);
      const size_t row = static_cast<size_t>(t) * B + bb0 + b0 + b;
      if (kStoreGates) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          p.gs[row * 4 * H + gate * H + unit] = from_f32<T>(gv[gate]);
      }
      float& c = c_s[(b0 + b) * u + j];
      const float c_new = act_sig(gv[1], p.hard) * c +
                          act_sig(gv[0], p.hard) * act_tanh(gv[2], p.hard);
      const float h_new = act_sig(gv[3], p.hard) * act_tanh(c_new, p.hard);
      c = c_new;
      p.ys[row * H + unit] = from_f32<T>(h_new);
      p.cs[row * H + unit] = from_f32<T>(c_new);
    }
    if (item + 1 < items) {  // the next item's stage, under the barrier's wait
      fetch(item + 1);
      cp_async_commit();
    }
    phase(item, 3);
  }
}

template <typename T, bool kStoreGates, int kNT>
auto pick_mt(int mt) {
  return mt == 1 ? lstm_fwd_kernel<T, kStoreGates, 1, kNT>
       : mt == 2 ? lstm_fwd_kernel<T, kStoreGates, 2, kNT>
       : mt == 3 ? lstm_fwd_kernel<T, kStoreGates, 3, kNT>
                 : lstm_fwd_kernel<T, kStoreGates, 4, kNT>;
}

template <typename T, bool kStoreGates, int kTB>
auto pick_tr(int tr) {
  return tr == 4 ? lstm_fwd_kernel<T, kStoreGates, 4, kTB>
       : tr == 6 ? lstm_fwd_kernel<T, kStoreGates, 6, kTB>
                 : lstm_fwd_kernel<T, kStoreGates, 8, kTB>;
}

// The kernel for a block of `rows` rows, batch slices of `bslice` rows and
// groups of G: bf16 by its tiles, fp32 by a thread's tile.
template <typename T, bool kStoreGates>
auto pick(int rows, int bslice, int G) {
  if constexpr (sizeof(T) == 4) {
    return fp32_tile_batch(rows, G) == 4 ? pick_tr<T, kStoreGates, 4>(fp32_tile_rows(rows))
                                         : pick_tr<T, kStoreGates, 8>(fp32_tile_rows(rows));
  } else {
    int mt, nt;
    pick_tiles(rows, bslice, &mt, &nt);
    return nt == 2 ? pick_mt<T, kStoreGates, 2>(mt) : pick_mt<T, kStoreGates, 4>(mt);
  }
}

template <typename T, bool kStoreGates>
int run(const FwdArgs<T>& a, int blocks, int bsplit, size_t smem, cudaStream_t stream) {
  const int rows = 4 * a.units;
  int err = check_plan(a.H, a.B, blocks, bsplit, a.units, rows, a.res_rows, a.H, rows,
                       sizeof(T), a.chunk, a.group, smem);
  if (err) return err;
  auto kernel = pick<T, kStoreGates>(rows, batch_slice(a.B, bsplit), a.group);
  if ((err = prepare(kernel, static_cast<long>(blocks) * bsplit, smem))) return err;
  void* params[] = {const_cast<FwdArgs<T>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(blocks, bsplit), dim3(kThreads),
                                                      params, smem, stream));
}

template <typename T>
int dispatch(const void* gx, const void* w, const void* h0, const void* c0, void* ys, void* cs,
             void* gs, void* ctr, int steps, int B, int H, int hard, int blocks, int bsplit,
             int units, int res_rows, int chunk, int group, size_t smem, cudaStream_t stream) {
  const FwdArgs<T> a{static_cast<const T*>(gx), static_cast<const T*>(w),
                     static_cast<const T*>(h0), static_cast<const T*>(c0), static_cast<T*>(ys),
                     static_cast<T*>(cs), static_cast<T*>(gs), static_cast<unsigned*>(ctr),
                     steps, B, H, hard, units, res_rows, chunk, group};
  return gs ? run<T, true>(a, blocks, bsplit, smem, stream)
            : run<T, false>(a, blocks, bsplit, smem, stream);
}

// The step floor: the same grid doing nothing but T - 1 step barriers, for
// timing what the barrier alone costs a layer (chip_smoke.py's lstm
// summary). Not on any path of the model.
__global__ void __launch_bounds__(kThreads, 1) barrier_loop_kernel(unsigned* ctr, int steps) {
  for (int t = 1; t < steps; ++t)
    grid_sync(ctr, gridDim.x * gridDim.y * static_cast<unsigned>(t));
}

}  // namespace

LSTM_PHASE_READ

extern "C" {

// Runs barrier_loop_kernel over blocks x bsplit blocks with `smem` bytes each, one
// cooperative launch; ctr: one zeroed uint32.
int lstm_barrier_loop(void* ctr, int T, int blocks, int bsplit, size_t smem, void* stream) {
  auto kernel = barrier_loop_kernel;
  int err = prepare(kernel, static_cast<long>(blocks) * bsplit, smem);
  if (err) return err;
  unsigned* c = static_cast<unsigned*>(ctr);
  void* params[] = {&c, &T};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks, bsplit), dim3(kThreads), params, smem,
      static_cast<cudaStream_t>(stream)));
}

// Shared memory of a block holding res_rows of `rows` rows of length K,
// with stage_elems per-step inputs per batch row of a group of `group`
// (esize 4 or 2), `carry` floats and fp32's chunk stages of `chunk` floats
// (0 in bf16): the number the host's plan must give (lstm_plan).
size_t lstm_recurrence_smem_bytes(int rows, int res_rows, int K, int stage_elems, int esize,
                                  int carry, int chunk, int group) {
  return smem_bytes(rows, res_rows, K, stage_elems, esize, carry, chunk, group);
}

// Runs a layer's T steps in one cooperative launch of blocks x bsplit
// blocks, each of `units` hidden units and one of bsplit batch slices, the
// first res_rows of its 4 units rows of w_hh resident, fp32 staging the
// contraction in chunks of `chunk` floats (0 in bf16) for groups of
// `group` batch rows (64 in bf16), with `smem` bytes of shared memory (all
// from the host's plan, checked here). h0, c0 are
// only read; ctr: one zeroed uint32. gs: [T, B, 4H] for K3a, or null for
// K1. Returns 0, a CUDA error, kNotCoResident (-1: the grid cannot all be
// resident) or kBadPlan (-2).
int lstm_recurrence_fwd(const void* gx, const void* w_hh, const void* h0, const void* c0,
                        void* ys, void* cs, void* gs, void* ctr, int T, int B, int H,
                        int hard, int dtype, int blocks, int bsplit, int units, int res_rows,
                        int chunk, int group, size_t smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(gx, w_hh, h0, c0, ys, cs, gs, ctr, T, B, H, hard, blocks, bsplit,
                           units, res_rows, chunk, group, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(gx, w_hh, h0, c0, ys, cs, gs, ctr, T, B, H, hard, blocks,
                                   bsplit, units, res_rows, chunk, group, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* caiman_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
