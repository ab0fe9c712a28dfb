// Wavefront multi-layer LSTM backward for Hopper (sm_90a): the counterpart of
// the Pallas TPU kernel caiman_asr_tpu/ops/pallas_wavefront.py::_bwd_kernel
// (K8-bwd), the mirrored reverse wavefront.
//
// Layer l takes step t at reverse superstep r = (T-1-t) + (G-1-l):
//   dh = dys[l,t] + dgates[l,t+1] @ w_hh^l + m[l,t] * (dgates[l+1,t] @ w_ih^{l+1})
//   dc = dc + dcs[l,t] + dh * o * tnh'(c_t)
//   dgates[l,t] = [dc*g*i', dc*c_{t-1}*f', dc*i*g', dh*tnh(c_t)*o']  (compute dtype)
//   dc = dc * f
// where a step outside [0, T), or a layer past G-1, contributes nothing, and
// m is the dropout mask entering layer l+1 (1 without masks). Both handoffs
// were written a superstep earlier into the dgates output, already rounded
// to the compute dtype, which is the value the Pallas kernel feeds its
// products. Layer l's last step (t = 0) is followed, one superstep later, by
// its dh0 = dgates[l,0] @ w_hh^l (the own term only,
// pallas_wavefront.py:339-345); dc0 is the fp32 carry then. The activations
// are recomputed from the stored pre-activations (soft, or the hard clip
// windows of pallas_wavefront.py:306-315).
//
// What bounds it: a reverse superstep reads every layer's w_hh and the inner
// layers' w_ih once, (2G-1)*4H*H values, against 2*B*4H*H*(2G-1) FLOPs: at
// B=16 the bytes. Design (lstm_wavefront.cuh, the mirror of the forward):
// one cooperative launch for all T + G reverse supersteps, dh0's included.
// A block owns u units of a layer; its rows are their rows of w_hh^T
// (columns of w_hh [4H, H], gathered by the block itself once a call) and,
// below the top layer, of the layer above's w_ih^T, one row of 8H: the own
// product over dgates[l,t+1] and the
// from-above one over dgates[l+1,t] are two segments of one chunked walk,
// summed apart so that the mask applies to the latter's [B, H] output (the
// top layer, type A, has only the first). The first rows stay resident in
// shared memory, the rest stream through the ring; dc stays in the block's
// shared memory for the whole call.

#include "lstm_wavefront.cuh"

namespace {

using namespace wfp;

template <typename T>
struct BwdArgs {
  const T* gs;      // [G, T, B, 4H] pre-activations
  const T* cs;      // [G, T, B, H]
  const T* c_prev;  // [G, T, B, H]
  const T* dys;     // [G, T, B, H]
  const T* dcs;     // [G, T, B, H]
  const T* masks;   // [G-1, T, B, H] or null
  const T* w_hh;    // [G, 4H, H]
  const T* w_ih;    // [G-1, 4H, H] (layer l+1's at l)
  T* dgates;        // [G, T, B, 4H]
  float* dh0;       // [G, B, H]
  float* dc0;       // [G, B, H]
  T* packed[2];     // each type's streamed rows, per block in chunk order (scratch)
  unsigned* ctr;    // superstep barrier, zero on entry
  int steps, B, H, G, hard;
  Type ty[2];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) wavefront_bwd_kernel(const BwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, H4 = 4 * H, B = p.B, T_steps = p.steps, G = p.G;
  const int nbA = p.ty[0].blocks;
  const int bx = blockIdx.x;
  const int l = bx < nbA ? G - 1 : (bx - nbA) / p.ty[1].blocks;  // type A: the top layer
  const int type = l == G - 1 ? 0 : 1;
  const Type ty = p.ty[type];
  const int u = ty.units, u0 = (bx < nbA ? bx : (bx - nbA) % ty.blocks) * u;
  const Shape sh = shape_of(type, u, H, true);
  const Layout L = layout(ty, sh.rows, sh.K, sh.nseg, sh.naux, B, sizeof(T));
  // this block's streamed rows: its index among its type's blocks
  T* const pk = p.packed[type] + (bx - (type ? nbA : 0)) * (L.nch * L.astage / sizeof(T));
  // the weights first, while little else is live: block row r is unit
  // u0 + r, segment 0 its row of w_hh^T, 1 of w_ih^T above, a column of
  // w_hh / w_ih gathered kPe values at a time
  const T* w_own = p.w_hh + static_cast<size_t>(l) * H4 * H;
  const T* w_above = p.w_ih + static_cast<size_t>(l < G - 1 ? l : 0) * H4 * H;
  load_weights<T, true>(smem, pk, L, ty, [w_own, w_above, u, u0, H](int r, int seg,
                                                                       int k) -> uint4 {
    const int unit = u0 + r;
    if (r >= u || unit >= H) return make_uint4(0u, 0u, 0u, 0u);
    const T* w = (seg == 0 ? w_own : w_above) + unit;
    uint32_t word[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 2) {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(w);
        word[j] = e[static_cast<size_t>(k + 2 * j) * H] |
                  static_cast<uint32_t>(e[static_cast<size_t>(k + 2 * j + 1) * H]) << 16;
      } else {
        word[j] = __float_as_uint(w[static_cast<size_t>(k + j) * H]);
      }
    }
    return make_uint4(word[0], word[1], word[2], word[3]);
  });
  Product<T> pr;
  pr.init(smem, pk, L, ty, B);
  float* own = reinterpret_cast<float*>(smem + pr.L.own);      // [bp][rs], two segments
  float* carry = reinterpret_cast<float*>(smem + pr.L.carry);  // dc [B][u]
  for (int i = threadIdx.x; i < B * u; i += kThreads) carry[i] = 0.0f;
  pr.prefetch();

  const size_t bh = static_cast<size_t>(B) * H;
  const size_t bh4 = 4 * bh;
  const bool above = sh.nseg == 2;
  float acc[kAcc];
  for (int r = 0; r < T_steps + G; ++r) {
    if (r > 0) lstmp::grid_sync(p.ctr, gridDim.x * static_cast<unsigned>(r));
    const int tr = r - (G - 1 - l);       // the layer's reverse step
    if (tr < 0 || tr > T_steps) continue;  // outside its window (tr == T: the dh0 step)
    const int t = T_steps - 1 - tr;        // -1 on the dh0 step
    const T* x_own =
        t + 1 < T_steps ? p.dgates + (static_cast<size_t>(l) * T_steps + t + 1) * bh4 : nullptr;
    const T* x_above = above && t >= 0
                           ? p.dgates + (static_cast<size_t>(l + 1) * T_steps + t) * bh4
                           : nullptr;
    pr.run(acc, [&](int b, int seg, int k) -> const T* {
      const T* x = seg == 0 ? x_own : x_above;
      return x ? x + static_cast<size_t>(b) * H4 + k : nullptr;
    }, [&](float* a) {  // the own segment's sums, added over the warps' parts
      pr.flush(a);
      __syncthreads();
      for (int i = threadIdx.x; i < B * u; i += kThreads) {
        const int b = i / u, j = i - b * u;
        own[b * pr.L.rs + j] = pr.sum(j, b);
      }
    }, [&] {  // gs's 4 gates, cs, c_prev, dys, dcs and the mask of step t, for the units
      if (t < 0) return;
      const T* state[5] = {p.cs, p.c_prev, p.dys, p.dcs, above ? p.masks : nullptr};
      pr.stage_aux(sh.naux, min(u, H - u0), [&](int b, int q) -> const T* {
        const size_t rowi = (static_cast<size_t>(l) * T_steps + t) * B + b;
        return q < 4 ? p.gs + rowi * H4 + q * H + u0
                     : state[q - 4] ? state[q - 4] + rowi * H + u0 : nullptr;
      });
    });
    __syncthreads();  // the own sums read before the last segment's land
    pr.flush(acc);
    __syncthreads();

    // one thread per (batch row, unit)
    for (int i = threadIdx.x; i < B * u; i += kThreads) {
      const int b = i / u, j = i - b * u, unit = u0 + j;
      if (unit >= H) continue;
      const size_t idx = static_cast<size_t>(b) * H + unit;
      const float own_sum = above ? own[b * pr.L.rs + j] : pr.sum(j, b);
      if (t < 0) {  // the layer's dh0 step
        p.dh0[l * bh + idx] = own_sum;
        p.dc0[l * bh + idx] = carry[i];
        continue;
      }
      auto in = [&](int q) { return lstmp::to_f32(pr.aux(b, q, sh.naux)[j]); };
      float dh_mat = own_sum;
      if (above)  // masks[l, t] scales the from-above term (l < G-1)
        dh_mat += pr.sum(j, b) * (p.masks ? in(8) : 1.0f);
      const lstmp::GateGrads a = lstmp::gate_grads(in(0), in(1), in(2), in(3), in(4), p.hard);
      const float dh = in(6) + dh_mat;
      const float d = carry[i] + in(7) + dh * a.o * a.dtanh_c;
      T* dr = p.dgates + (static_cast<size_t>(l) * T_steps + t) * bh4 + b * static_cast<size_t>(H4);
      dr[0 * H + unit] = lstmp::from_f32<T>(d * a.g * a.di);
      dr[1 * H + unit] = lstmp::from_f32<T>(d * in(5) * a.df);
      dr[2 * H + unit] = lstmp::from_f32<T>(d * a.i * a.dg);
      dr[3 * H + unit] = lstmp::from_f32<T>(dh * a.tanh_c * a.dout);
      carry[i] = d * a.f;
    }
  }
  pr.drain();  // the ring's copies past the last superstep
}

template <typename T>
int run(const BwdArgs<T>& a, size_t smem, cudaStream_t stream) {
  int err = check_plan(a.ty, a.G, a.H, a.B, sizeof(T), true, smem);
  if (!err) err = check_packed(a.ty, a.packed, a.G, a.H, a.B, true);
  if (err) return err;
  auto kernel = wavefront_bwd_kernel<T>;
  const long blocks = grid_of(a.ty, a.G);
  if ((err = lstmp::prepare(kernel, blocks, smem))) return err;
  void* params[] = {const_cast<BwdArgs<T>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(blocks), dim3(kThreads), params,
                                                      smem, stream));
}

template <typename T>
int dispatch(const void* gs, const void* cs, const void* c_prev, const void* dys,
             const void* dcs, const void* masks, const void* w_hh, const void* w_ih,
             void* dgates, void* dh0, void* dc0, void* packed_a, void* packed_b,
             void* ctr, int steps, int B, int H, int G, int hard, const int* plan, size_t smem,
             cudaStream_t stream) {
  BwdArgs<T> a{static_cast<const T*>(gs), static_cast<const T*>(cs),
               static_cast<const T*>(c_prev), static_cast<const T*>(dys),
               static_cast<const T*>(dcs), static_cast<const T*>(masks),
               static_cast<const T*>(w_hh), static_cast<const T*>(w_ih),
               static_cast<T*>(dgates), static_cast<float*>(dh0), static_cast<float*>(dc0),
               {static_cast<T*>(packed_a), static_cast<T*>(packed_b)},
               static_cast<unsigned*>(ctr), steps, B, H, G, hard, {}};
  for (int type = 0; type < 2; ++type) {
    const int* v = plan + type * kTypeInts;
    a.ty[type] = Type{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  }
  return run<T>(a, smem, stream);
}

}  // namespace

extern "C" {

// Runs all T + G reverse supersteps, dh0's included, in one cooperative
// launch, on the plan (16 ints as for lstm_wavefront_fwd; type A is the top
// layer) and `smem` bytes a block, checked here. All [G, T, B, *] inputs
// are contiguous in the compute dtype; masks may be null (no dropout);
// w_hh [G, 4H, H] / w_ih [G-1, 4H, H] as the wrapper takes them; packed_a /
// packed_b scratch for each type's packed streamed rows, which the kernel
// writes (packed_elems).
// dh0 and dc0: [G, B, H] fp32, written; ctr: one zeroed uint32. Returns 0,
// a CUDA error, kNotCoResident (-1) or kBadPlan (-2).
int lstm_wavefront_bwd(const void* gs, const void* cs, const void* c_prev, const void* dys,
                       const void* dcs, const void* masks, const void* w_hh,
                       const void* w_ih, void* dgates, void* dh0, void* dc0,
                       void* packed_a, void* packed_b, void* ctr, int T, int B,
                       int H, int G, int hard, int dtype, const int* plan, size_t smem,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, dgates, dh0, dc0,
                           packed_a, packed_b, ctr, T, B, H, G, hard, plan, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, dgates,
                                   dh0, dc0, packed_a, packed_b, ctr, T, B, H, G, hard, plan,
                                   smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
