// Wavefront multi-layer LSTM forward for Hopper (sm_90a): the counterpart of
// the Pallas TPU kernel caiman_asr_tpu/ops/pallas_wavefront.py::_fwd_kernel
// (K8-fwd); with the kStoreGates flag it also writes the full
// pre-activations gs in the compute dtype for the backward
// (pallas_wavefront.py:146-147).
//
// G stacked layers, time-major, run as a (layer, time) wavefront: at
// superstep s layer l takes step t = s - l, for s in [0, T + G - 1).
//   layer 0:   gates = gx0[t] + h^0_{t-1} @ w0^T                 (w0 [4H, H])
//   layer l>0: gates = [x ; h^l_{t-1}] @ w_cat[l-1]^T + bias[l-1] (w_cat [4H, 2H])
//              x = ys[l-1, t] * mask[l-1, t], rounded to the compute dtype
//   c = sig(f) * c + sig(i) * tnh(g);  h = sig(o) * tnh(c)
// Gate order i, f, g, o; soft or hard (clip(0.5 + z/8, 0, 1) / clip(z, -1,
// 1)) activations; products accumulate in fp32 and the fp32 bias adds to the
// sum. c is carried in fp32; h enters a product in the compute dtype, which
// is exactly its stored output, so h^l_{t-1} is read from ys[l, t-1] (h0[l]
// at t = 0) and the handoff from ys[l-1, t]; with masks, the layer below
// also writes the masked handoff x into a two-slot ring xm [G-1, 2, B, H]
// (slot t % 2), which the layer above reads a superstep later. Outputs ys,
// cs [G, T, B, H] (gs [G, T, B, 4H]).
//
// What bounds it: a superstep reads every layer's weights once, 4H*H +
// (G-1)*4H*2H values (92 MB in bf16 at G=6, H=1024), against
// 2*B*4H*(H + (G-1)*2H) FLOPs: at B=16 the bytes. Design
// (lstm_wavefront.cuh): one cooperative launch for all T + G - 1
// supersteps, one grid barrier between them; layer 0 on the plan's type-A
// blocks, each inner layer on type-B blocks (about twice as many, the
// rows being twice as long); each block keeps the first rows of its 4u
// rows resident in shared memory and streams the rest once a superstep
// through a TMA ring that runs ahead across the barrier (from its own
// packed image of them, which it writes before the first superstep), so a superstep
// costs about its streamed bytes over the memory's rate plus the gate
// math and the barrier; c stays in the block's shared memory from the
// first step to the last, and with it the inner layers' bias and each
// step's gate inputs.

#include "lstm_wavefront.cuh"

namespace {

using namespace wfp;

template <typename T>
struct FwdArgs {
  const T* gx;        // [T, B, 4H]
  const float* bias;  // [max(G-1, 1), 4H]
  const T* w0;        // [4H, H]
  const T* w_cats;    // [G-1, 4H, 2H]
  const T* masks;     // [G-1, T, B, H] or null
  const T* h0;        // [G, B, H]
  const T* c0;        // [G, B, H]
  T* ys;              // [G, T, B, H]
  T* cs;              // [G, T, B, H]
  T* gs;              // [G, T, B, 4H] (kStoreGates only)
  T* xm;              // [G-1, 2, B, H] masked handoff (masks only)
  T* packed[2];       // each type's streamed rows, per block in chunk order (scratch)
  unsigned* ctr;      // superstep barrier, zero on entry
  int steps, B, H, G, hard;
  Type ty[2];
};

template <typename T, bool kStoreGates>
__global__ void __launch_bounds__(kThreads, 1) wavefront_fwd_kernel(const FwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, B = p.B, T_steps = p.steps;
  const int nb0 = p.ty[0].blocks;
  const int bx = blockIdx.x;
  const int l = bx < nb0 ? 0 : 1 + (bx - nb0) / p.ty[1].blocks;
  const int type = l == 0 ? 0 : 1;
  const Type ty = p.ty[type];
  const int u = ty.units, u0 = (bx < nb0 ? bx : (bx - nb0) % ty.blocks) * u;
  const Shape sh = shape_of(type, u, H, false);
  const int K = sh.K;
  const Layout L = layout(ty, sh.rows, K, 1, sh.naux, B, sizeof(T));
  // this block's streamed rows: its index among its type's blocks
  T* const pk = p.packed[type] + (bx - (type ? nb0 : 0)) * (L.nch * L.astage / sizeof(T));
  // the weights first, while little else is live: block row r is gate
  // r / u of unit u0 + r % u, a row of w0 / w_cat[l-1]
  const T* wl = l == 0 ? p.w0 : p.w_cats + static_cast<size_t>(l - 1) * 4 * H * K;
  load_weights<T, false>(smem, pk, L, ty, [wl, u, u0, H, K](int r, int, int k) -> uint4 {
    const int unit = u0 + r % u;
    if (r >= 4 * u || unit >= H) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(wl + static_cast<size_t>((r / u) * H + unit) * K + k);
  });
  Product<T> pr;
  pr.init(smem, pk, L, ty, B);
  float* carry = reinterpret_cast<float*>(smem + pr.L.carry);  // [B][u]
  float* bias = reinterpret_cast<float*>(smem + L.bias);  // [4][u], an inner layer's
  for (int i = threadIdx.x; i < B * u; i += kThreads) {
    const int b = i / u, unit = u0 + i % u;
    carry[i] = unit < H ? lstmp::to_f32(p.c0[(static_cast<size_t>(l) * B + b) * H + unit]) : 0.0f;
  }
  for (int i = threadIdx.x; l > 0 && i < 4 * u; i += kThreads) {
    const int q = i / u, unit = u0 + i % u;
    bias[i] = unit < H ? p.bias[static_cast<size_t>(l - 1) * 4 * H + q * H + unit] : 0.0f;
  }
  pr.prefetch();

  const size_t bh = static_cast<size_t>(B) * H;
  const size_t layer = static_cast<size_t>(T_steps) * bh;  // one layer of a [G, T, B, H] stream
  float acc[kAcc];
  for (int s = 0; s < T_steps + p.G - 1; ++s) {
    if (s > 0) lstmp::grid_sync(p.ctr, gridDim.x * static_cast<unsigned>(s));
    const int t = s - l;
    if (t < 0 || t >= T_steps) continue;  // outside the layer's window: only the barriers
    const T* h = t == 0 ? p.h0 + l * bh : p.ys + l * layer + (t - 1) * bh;
    const T* xb = l == 0 ? nullptr
                  : p.masks ? p.xm + (static_cast<size_t>(l - 1) * 2 + (t & 1)) * bh
                            : p.ys + (l - 1) * layer + t * bh;
    const bool handoff = p.masks && l + 1 < p.G;  // this layer writes the masked handoff
    pr.run(acc, [&](int b, int, int k) -> const T* {
      const size_t r = static_cast<size_t>(b) * H;
      return l == 0 ? h + r + k : k < H ? xb + r + k : h + r + k - H;
    }, [](float*) {}, [&] {  // layer 0's gx[t], an inner layer's mask, for its units
      pr.stage_aux(sh.naux, min(u, H - u0), [&](int b, int q) -> const T* {
        const size_t rowi = static_cast<size_t>(t) * B + b;
        if (q + 1 < sh.naux) return p.gx + rowi * 4 * H + q * H + u0;  // layer 0's gates
        return handoff ? p.masks + l * layer + rowi * H + u0 : nullptr;
      });
    });
    pr.flush(acc);
    __syncthreads();

    // gate math: one thread per (batch row, unit)
    for (int i = threadIdx.x; i < B * u; i += kThreads) {
      const int b = i / u, j = i - b * u, unit = u0 + j;
      if (unit >= H) continue;
      const size_t rowi = static_cast<size_t>(t) * B + b;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre[q] = pr.sum(q * u + j, b) +
                 (l == 0 ? lstmp::to_f32(pr.aux(b, q, sh.naux)[j]) : bias[q * u + j]);
      if (kStoreGates) {
        T* gsb = p.gs + (static_cast<size_t>(l) * T_steps * B + rowi) * 4 * H;
#pragma unroll
        for (int q = 0; q < 4; ++q) gsb[q * H + unit] = lstmp::from_f32<T>(pre[q]);
      }
      using lstmp::act_sig, lstmp::act_tanh;
      const float c_new = act_sig(pre[1], p.hard) * carry[i] +
                          act_sig(pre[0], p.hard) * act_tanh(pre[2], p.hard);
      const float h_new = act_sig(pre[3], p.hard) * act_tanh(c_new, p.hard);
      carry[i] = c_new;
      const size_t idx = static_cast<size_t>(b) * H + unit, out = l * layer + t * bh + idx;
      const T y = lstmp::from_f32<T>(h_new);
      p.ys[out] = y;
      p.cs[out] = lstmp::from_f32<T>(c_new);
      if (handoff)  // the handoff to layer l + 1, masked and rounded
        p.xm[(static_cast<size_t>(l) * 2 + (t & 1)) * bh + idx] =
            lstmp::from_f32<T>(lstmp::to_f32(y) * lstmp::to_f32(pr.aux(b, sh.naux - 1, sh.naux)[j]));
    }
  }
  pr.drain();  // the ring's copies past the last superstep
}

template <typename T, bool kStoreGates>
int run(const FwdArgs<T>& a, size_t smem, cudaStream_t stream) {
  int err = check_plan(a.ty, a.G, a.H, a.B, sizeof(T), false, smem);
  if (!err) err = check_packed(a.ty, a.packed, a.G, a.H, a.B, false);
  if (err) return err;
  auto kernel = wavefront_fwd_kernel<T, kStoreGates>;
  const long blocks = grid_of(a.ty, a.G);
  if ((err = lstmp::prepare(kernel, blocks, smem))) return err;
  void* params[] = {const_cast<FwdArgs<T>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(blocks), dim3(kThreads), params,
                                                      smem, stream));
}

template <typename T>
int dispatch(const void* gx, const void* bias, const void* w0, const void* w_cats,
             const void* masks, const void* h0, const void* c0, void* ys, void* cs, void* gs,
             void* xm, void* packed_a, void* packed_b, void* ctr, int steps,
             int B, int H, int G, int hard, const int* plan, size_t smem, cudaStream_t stream) {
  FwdArgs<T> a{static_cast<const T*>(gx), static_cast<const float*>(bias),
               static_cast<const T*>(w0), static_cast<const T*>(w_cats),
               static_cast<const T*>(masks), static_cast<const T*>(h0),
               static_cast<const T*>(c0), static_cast<T*>(ys), static_cast<T*>(cs),
               static_cast<T*>(gs), static_cast<T*>(xm),
               {static_cast<T*>(packed_a), static_cast<T*>(packed_b)},
               static_cast<unsigned*>(ctr), steps, B, H, G, hard, {}};
  for (int type = 0; type < 2; ++type) {
    const int* v = plan + type * kTypeInts;
    a.ty[type] = Type{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  }
  if (masks && G > 1 && !xm) return kBadPlan;
  return gs ? run<T, true>(a, smem, stream) : run<T, false>(a, smem, stream);
}

}  // namespace

extern "C" {

// Runs all T + G - 1 supersteps in one cooperative launch. plan: 16 ints,
// type A's then type B's (blocks, units, resident rows, chunk, X stages, mma tiles a
// warp, k parts of the warps, k parts of an fp32 tile's threads), and
// `smem` bytes a block (from wavefront_plan, checked here). masks may be
// null (no dropout; else xm [G-1, 2, B, H] is the handoff's scratch); gs
// null runs K8-fwd, else K8-fwd storing the gates. packed_a / packed_b:
// scratch for each type's packed streamed rows, which the kernel writes
// (wavefront_kernel.py packed_elems; null where the type streams none).
// The inputs are only read;
// ctr: one zeroed uint32. Returns 0, a CUDA error, kNotCoResident (-1: the
// grid cannot all be resident) or kBadPlan (-2).
int lstm_wavefront_fwd(const void* gx0, const void* bias, const void* w0, const void* w_cats,
                       const void* masks, const void* h0, const void* c0, void* ys, void* cs,
                       void* gs, void* xm, void* packed_a, void* packed_b,
                       void* ctr, int T, int B, int H, int G, int hard, int dtype,
                       const int* plan, size_t smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(gx0, bias, w0, w_cats, masks, h0, c0, ys, cs, gs, xm, packed_a,
                           packed_b, ctr, T, B, H, G, hard, plan, smem, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(gx0, bias, w0, w_cats, masks, h0, c0, ys, cs, gs, xm,
                                   packed_a, packed_b, ctr, T, B, H, G, hard, plan, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The layout's bytes of one type (0: A, 1: B) for the plan's numbers, as the
// kernels compute it (wavefront_plan's arithmetic, checked on the card).
size_t lstm_wavefront_smem_bytes(const int* type_plan, int type, int H, int B, int esize,
                                 int backward) {
  const Type ty{type_plan[0], type_plan[1], type_plan[2], type_plan[3],
                type_plan[4], type_plan[5], type_plan[6], type_plan[7]};
  const Shape sh = shape_of(type, ty.units, H, backward != 0);
  return layout(ty, sh.rows, sh.K, sh.nseg, sh.naux, B, esize).total;
}

}  // extern "C"
