// LSTM backward recurrence for Hopper (sm_90a): the counterpart of the Pallas
// TPU kernel caiman_asr_tpu/ops/pallas_lstm.py::_bwd_kernel (K3b).
//
// One layer, reverse time: for t = T-1 .. 0
//   dh      = dy[t] + dgates[t+1] @ w_hh      (dgates[T] = 0; fp32 accumulation)
//   dc      = dc_{t+1} + dcs[t] + dh * o * tnh'(c_t)
//   dgates[t] = [dc*g*i', dc*c_{t-1}*f', dc*i*g', dh*tnh(c_t)*o']  (compute dtype)
//   dc_t    = dc * f
// and finally dh0 = dgates[0] @ w_hh, dc0 = dc_0. Gate order i, f, g, o; the
// activations are recomputed from the stored pre-activations gates[t] (soft
// sigmoid/tanh, or the hard clip windows of pallas_lstm.py:215-223). dh and
// dc are carried in fp32; dgates is written in the compute dtype, and that
// rounded value is what the next step's product reads (the Pallas kernel
// rounds dgates to the weight dtype before its dot, which is the same dtype).
//
// Design (lstm_persist.cuh, the mirror of the forward): one cooperative
// launch per layer, dh0 included. Block x owns hidden units
// [x u, x u + u) and copies their rows of w_hh^T ([H, 4H], so a unit's
// contraction over the 4H gate columns is contiguous) into shared memory
// once. Reverse step t: the block prefetches gates[t], cs[t], c_prev[t],
// dy[t] and dcs[t] for its units with cp.async (a batch group ahead),
// contracts dgates[t+1] (all 4H columns of every batch row, written by the
// whole grid the step before) against its resident rows, runs the gate
// backward, and writes dgates[t] for its 4u columns; dc is carried in
// fp32 in shared memory. As in the forward, the plan may split the batch
// over the grid's y (at base-85M's B=16, two slices of 8). One grid-wide
// barrier a step; after t = 0 one more product gives dh0. The exchange, a
// slice's rows of B x 4H a step, is 4x the forward's: it bounds the step
// at large batches.

#include "lstm_persist.cuh"

namespace {

using namespace lstmp;

template <typename T>
struct BwdArgs {
  const T* gates;   // [T, B, 4H] pre-activations
  const T* c_prev;  // [T, B, H]
  const T* cs;      // [T, B, H]
  const T* dys;     // [T, B, H]
  const T* dcs;     // [T, B, H]
  const T* w_t;     // [H, 4H] = w_hh^T
  T* dg;            // [T, B, 4H]
  float* dh0;       // [B, H]
  float* dc0;       // [B, H] fp32, written at the end
  unsigned* ctr;    // step barrier, zero on entry
  int steps, B, H, hard, units, res_rows, chunk, group;
};

template <typename T, int kMT, int kNT>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(const BwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int u = p.units, H = p.H, H4 = 4 * p.H, B = p.B;
  const int u0 = blockIdx.x * u;
  const int bslice = batch_slice(B, gridDim.y), bb0 = blockIdx.y * bslice;
  const int Bl = min(bslice, B - bb0);  // this block's batch rows [bb0, bb0 + Bl)
  const int ld = resident_ld(H4, sizeof(T)), G = p.group;
  T* w_s = reinterpret_cast<T*>(smem);
  T* stage = reinterpret_cast<T*>(smem + static_cast<size_t>(p.res_rows) * ld * sizeof(T));
  float* red = reinterpret_cast<float*>(stage + 2 * G * 8 * u);  // stage: [2][G][8u]
  const XStage xs{red, p.chunk, G};  // the scratch: partial sums, and fp32's chunk stages
  float* dc_s = red + scratch_bytes(u, p.res_rows, sizeof(T), p.chunk, G) / 4;  // [Bl][u]
  for (int i = threadIdx.x; i < Bl * u; i += kThreads) dc_s[i] = 0.0f;

  auto row_src = [&](int r) -> const T* {
    return u0 + r < H ? p.w_t + static_cast<size_t>(u0 + r) * H4 : nullptr;
  };
  load_resident(w_s, p.res_rows, ld, H4, row_src);
  const Rows A{w_s, u, p.res_rows, ld, H4};
  const Split sp = split_of<T, kNT>(Bl, u, G);
  const int groups = (Bl + sp.group - 1) / sp.group;
  const int steps_items = p.steps * groups;

  // step s's inputs of a batch group for the block's units, in pieces of 4
  // units: stage[b][gate * u + j] the pre-activations (array 0), then cs,
  // c_prev, dy and dcs (arrays 1 to 4) at 4u, 5u, 6u and 7u
  Pieces pc;
#pragma unroll
  for (int k = 0; k < kPiecesPerLane; ++k) {
    const int piece = threadIdx.x % 32 + 32 * k;
    const int which = piece / (u / 4), j = 4 * (piece % (u / 4));
    pc.col[k] = piece < 2 * u && u0 + j < H ? (which < 4 ? which * H : 0) + u0 + j : -1;
    pc.dst[k] = (which < 4 ? 0 : which - 3) << 20 | (which * u + j);
  }
  const T* states[5] = {p.gates, p.cs, p.c_prev, p.dys, p.dcs};
  auto fetch = [&](int item) {
    const int t = p.steps - 1 - item / groups, b0 = (item % groups) * sp.group;
    stage_rows(pc, 2 * u, min(sp.group, Bl - b0), bb0 + b0, 8 * u,
               stage + (item & 1) * G * 8 * u, [&](int arr, int row) {
                 const size_t r = static_cast<size_t>(t) * B + row;
                 return arr == 0 ? p.gates + r * H4 : states[arr] + r * H;
               });
  };
  if (steps_items > 0) {
    fetch(0);
    cp_async_commit();
  }

  // reverse steps, then one pass more for dh0
  for (int item = 0; item < steps_items + groups; ++item) {
    const int s = item / groups, b0 = (item % groups) * sp.group;
    const int t = p.steps - 1 - s;  // -1 on the dh0 pass
    if (item % groups == 0 && s > 0)
      grid_sync(p.ctr, gridDim.x * gridDim.y * static_cast<unsigned>(s));  // dgates[t+1] done
    else
      __syncthreads();
    phase(item, 0);
    if (s > 0)
      product<kMT, kNT>(p.dg + (static_cast<size_t>(t + 1) * B + bb0) * H4, Bl, b0, A, row_src,
                        red, xs);
    phase(item, 1);
    cp_async_wait_all();  // this item's stage, issued before the barrier
    __syncthreads();
    phase(item, 2);

    const T* st = stage + (item & 1) * G * 8 * u;
    const int nb = min(sp.group, Bl - b0);
    for (int i = threadIdx.x; i < nb * u; i += kThreads) {
      const int b = i / u, j = i % u, unit = u0 + j;
      if (unit >= H) continue;
      const size_t idx = static_cast<size_t>(bb0 + b0 + b) * H + unit;
      const float dh_next = s > 0 ? reduced<T>(red, sp, u, j, b) : 0.0f;
      float& dc_carry = dc_s[(b0 + b) * u + j];
      if (t < 0) {
        p.dh0[idx] = dh_next;
        p.dc0[idx] = dc_carry;
        continue;
      }
      const T* sb = st + b * 8 * u;
      const float gi = to_f32(sb[0 * u + j]), gf = to_f32(sb[1 * u + j]);
      const float gg = to_f32(sb[2 * u + j]), go = to_f32(sb[3 * u + j]);
      const float ct = to_f32(sb[4 * u + j]), cp = to_f32(sb[5 * u + j]);
      const float dy = to_f32(sb[6 * u + j]), dcs = to_f32(sb[7 * u + j]);
      const GateGrads a = gate_grads(gi, gf, gg, go, ct, p.hard);
      const float dh = dy + dh_next;
      const float dc = dc_carry + dcs + dh * a.o * a.dtanh_c;
      T* dr = p.dg + (static_cast<size_t>(t) * B + bb0 + b0 + b) * H4;
      dr[0 * H + unit] = from_f32<T>(dc * a.g * a.di);
      dr[1 * H + unit] = from_f32<T>(dc * cp * a.df);
      dr[2 * H + unit] = from_f32<T>(dc * a.i * a.dg);
      dr[3 * H + unit] = from_f32<T>(dh * a.tanh_c * a.dout);
      dc_carry = dc * a.f;
    }
    if (item + 1 < steps_items) {  // the next item's stage, under the barrier's wait
      fetch(item + 1);
      cp_async_commit();
    }
    phase(item, 3);
  }
}

template <typename T, int kTB>
auto pick_tr(int tr) {
  return tr == 4 ? lstm_bwd_kernel<T, 4, kTB>
       : tr == 6 ? lstm_bwd_kernel<T, 6, kTB>
                 : lstm_bwd_kernel<T, 8, kTB>;
}

// The kernel for a block of `units` rows, batch slices of `bslice` rows and
// groups of G: bf16 by its tiles (the backward's rows are units, so one or
// two tiles at the model's widths), fp32 by a thread's tile.
template <typename T>
auto pick(int units, int bslice, int G) {
  if constexpr (sizeof(T) == 4) {
    return fp32_tile_batch(units, G) == 4 ? pick_tr<T, 4>(fp32_tile_rows(units))
                                          : pick_tr<T, 8>(fp32_tile_rows(units));
  } else {
    int mt, nt;
    pick_tiles(units, bslice, &mt, &nt);
    if (mt == 1) return nt == 2 ? lstm_bwd_kernel<T, 1, 2> : lstm_bwd_kernel<T, 1, 4>;
    return nt == 2 ? lstm_bwd_kernel<T, 2, 2> : lstm_bwd_kernel<T, 2, 4>;
  }
}

template <typename T>
int run(const BwdArgs<T>& a, int blocks, int bsplit, size_t smem, cudaStream_t stream) {
  int err = check_plan(a.H, a.B, blocks, bsplit, a.units, a.units, a.res_rows, 4 * a.H,
                       8 * a.units, sizeof(T), a.chunk, a.group, smem);
  if (err) return err;
  auto kernel = pick<T>(a.units, batch_slice(a.B, bsplit), a.group);
  if ((err = prepare(kernel, static_cast<long>(blocks) * bsplit, smem))) return err;
  void* params[] = {const_cast<BwdArgs<T>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(blocks, bsplit), dim3(kThreads),
                                                      params, smem, stream));
}

template <typename T>
int dispatch(const void* gates, const void* c_prev, const void* cs, const void* dys,
             const void* dcs, const void* w_t, void* dgates, void* dh0, void* dc0, void* ctr,
             int steps, int B, int H, int hard, int blocks, int bsplit, int units,
             int res_rows, int chunk, int group, size_t smem, cudaStream_t stream) {
  const BwdArgs<T> a{static_cast<const T*>(gates), static_cast<const T*>(c_prev),
                     static_cast<const T*>(cs), static_cast<const T*>(dys),
                     static_cast<const T*>(dcs), static_cast<const T*>(w_t),
                     static_cast<T*>(dgates), static_cast<float*>(dh0),
                     static_cast<float*>(dc0), static_cast<unsigned*>(ctr),
                     steps, B, H, hard, units, res_rows, chunk, group};
  return run<T>(a, blocks, bsplit, smem, stream);
}

}  // namespace

LSTM_PHASE_READ

extern "C" {

// Runs a layer's T reverse steps and dh0 in one cooperative launch (the
// plan's blocks x bsplit grid, units, resident rows of w_hh^T, fp32's
// chunk (0 in bf16) and group (64 in bf16) and shared memory, checked
// here). All [T, B, *] inputs are contiguous in the
// compute dtype; w_t is w_hh^T [H, 4H]. dh0, dc0: [B, H] fp32, written;
// ctr: one zeroed uint32. Returns 0, a CUDA error, kNotCoResident (-1) or
// kBadPlan (-2).
int lstm_recurrence_bwd(const void* gates, const void* c_prev, const void* cs,
                        const void* dys, const void* dcs, const void* w_t, void* dgates,
                        void* dh0, void* dc0, void* ctr, int T, int B, int H, int hard,
                        int dtype, int blocks, int bsplit, int units, int res_rows, int chunk,
                        int group, size_t smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(gates, c_prev, cs, dys, dcs, w_t, dgates, dh0, dc0, ctr, T, B, H,
                           hard, blocks, bsplit, units, res_rows, chunk, group, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(gates, c_prev, cs, dys, dcs, w_t, dgates, dh0, dc0, ctr, T,
                                   B, H, hard, blocks, bsplit, units, res_rows, chunk, group,
                                   smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
