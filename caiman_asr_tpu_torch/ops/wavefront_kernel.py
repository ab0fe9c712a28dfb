"""Wavefront multi-layer LSTM kernels: the hand-written Hopper kernels, their
plain PyTorch versions and their launch counts.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_wavefront.py``:

- K8-fwd ``_fwd_kernel``: G stacked layers run as a (layer, time) wavefront,
  layer ``l`` taking step ``t = s - l`` at superstep ``s`` (``lstm_wavefront``,
  and ``lstm_wavefront_sg``, which also stores the pre-activations, the
  forward of a call that needs gradients; one CUDA source,
  ``csrc/lstm_wavefront.cu``, under a compile-time flag);
- K8-bwd ``_bwd_kernel``: the mirrored reverse wavefront
  (``lstm_wavefront_bwd``, ``csrc/lstm_wavefront_bwd.cu``).

Layouts are the port's torch ones: ``w0_hh`` [4H, H]; ``w_cats`` [G-1, 4H,
2H], row r of layer l being ``[w_ih^l[r] ; w_hh^l[r]]``; every stream
[G, T, B, *] (layer-major, no shifted superstep layout).

What bounds them on an H100: one superstep reads every layer's recurrent
weights once, ``4H·H + (G-1)·4H·2H`` values (92 MB in bf16 at G=6, H=1024,
more than the 50 MB L2), against ``2·B·4H·(H + (G-1)·2H)`` FLOPs, so at
B=16 a superstep is bound by the bytes. The simple designs launch once per
superstep with the G layers' blocks side by side in one grid.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from caiman_asr_tpu_torch.ops.cuda_build import (
    DTYPE_CODE, MAX_SMEM_BYTES, I, P, check, check_operands, counted, load, stream_of,
)
from caiman_asr_tpu_torch.ops.lstm import cell_activation, gate_activations, gate_math


@functools.cache
def _fwd_lib():
    return load("lstm_wavefront", {
        "lstm_wavefront_fwd": ([P] * 9 + [I] * 6 + [P], I),
        "lstm_wavefront_fwd_sg": ([P] * 10 + [I] * 6 + [P], I),
        "lstm_wavefront_fwd_smem_bytes": ([I, I, I], ctypes.c_size_t),
    })


@functools.cache
def _bwd_lib():
    return load("lstm_wavefront_bwd", {
        "lstm_wavefront_bwd": ([P] * 11 + [I] * 6 + [P], I),
        "lstm_wavefront_bwd_smem_bytes": ([I], ctypes.c_size_t),
    })


# ------------------------------------------------------------ plain versions
def lstm_wavefront_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks=None,
                         hard: bool = False, store_gates: bool = False):
    """K8-fwd's contract in plain PyTorch, superstep by superstep
    (``pallas_wavefront.py:114-148``).

    gates_x0: [T, B, 4H] layer 0's input projection plus bias, already in the
    compute dtype; biases: [max(G-1, 1), 4H] fp32, the inner layers'
    ``b_ih + b_hh``; w0_hh: [4H, H]; w_cats: [G-1, 4H, 2H]; h0, c0: [G, B, H];
    masks: None or [G-1, T, B, H], the dropout scale entering layers 1..G-1;
    all but the biases in the compute dtype. At superstep s layer l takes
    step t = s - l:

    - layer 0: ``gates_x0[t] + h^0_{t-1} @ w0_hh^T``;
    - layer l > 0: ``[x ; h^l_{t-1}] @ w_cats[l-1]^T + biases[l-1]``, x being
      layer l-1's step-t output times ``masks[l-1, t]``, rounded to the
      compute dtype.

    Products of compute-dtype values accumulate in fp32, the bias adds to
    the fp32 sum; h and c are carried in fp32 (h enters a product in the
    compute dtype, which is its stored output). Returns (ys, cs) or, with
    ``store_gates``, (ys, cs, gs), each [G, T, B, H] ([G, T, B, 4H] for gs)
    in the compute dtype.
    """
    T, B, H4 = gates_x0.shape
    H = H4 // 4
    G = h0.shape[0]
    dtype = gates_x0.dtype
    ws = [w0_hh.float().t()] + [w_cats[l].float().t() for l in range(G - 1)]
    c = [c0[l].float() for l in range(G)]
    ys = gates_x0.new_empty((G, T, B, H))
    cs = torch.empty_like(ys)
    gs = gates_x0.new_empty((G, T, B, H4)) if store_gates else None
    for s in range(T + G - 1):
        for l in range(G):
            t = s - l
            if not 0 <= t < T:
                continue
            h_prev = (h0[l] if t == 0 else ys[l, t - 1]).float()
            if l == 0:
                gates = gates_x0[t].float() + h_prev @ ws[0]
            else:
                x = ys[l - 1, t]
                if masks is not None:
                    x = (x.float() * masks[l - 1, t].float()).to(dtype)
                gates = torch.cat([x.float(), h_prev], dim=-1) @ ws[l] + biases[l - 1]
            h, c[l] = gate_math(gates, c[l], hard)
            ys[l, t] = h.to(dtype)
            cs[l, t] = c[l].to(dtype)
            if store_gates:
                gs[l, t] = gates.to(dtype)
    return (ys, cs, gs) if store_gates else (ys, cs)


def lstm_wavefront_sg_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks=None,
                            hard: bool = False):
    """:func:`lstm_wavefront_plain` storing the gates: (ys, cs, gs)."""
    return lstm_wavefront_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, True)


def lstm_wavefront_bwd_plain(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard: bool = False):
    """K8-bwd's contract in plain PyTorch, reverse superstep by reverse
    superstep (``pallas_wavefront.py:262-352``).

    gs: [G, T, B, 4H] pre-activations; cs, c_prev: [G, T, B, H] the cell
    states after and before each step; dys, dcs: [G, T, B, H] cotangents of
    ys and cs; masks: None or [G-1, T, B, H] (``masks[l]`` enters layer l+1);
    w_hh: [G, 4H, H]; w_ih: [G-1, 4H, H] the inner layers' input weights
    (``w_ih[l]`` is layer l+1's); all in the compute dtype. Layer l takes
    step t at reverse superstep ``(T-1-t) + (G-1-l)``, with

        dh^l_t = dys^l_t + dgates^l_{t+1} @ w_hh^l
                 + masks[l, t] * (dgates^{l+1}_t @ w_ih^{l+1})

    (a step outside [0, T) or a layer past G-1 contributes nothing; without
    masks the two products are one fp32 sum, the stacked [8H, H] product),
    then the gate backward of ``lstm_recurrence_bwd_plain`` with dc carried
    in fp32. dgates is rounded to the compute dtype, and that rounded value
    feeds both products. Returns (dgates [G, T, B, 4H] in the compute dtype,
    dh0 = dgates^l_0 @ w_hh^l and dc0, each [G, B, H] fp32).
    """
    G, T, B, H4 = gs.shape
    H = H4 // 4
    dtype = gs.dtype
    w_own = [w_hh[l].float() for l in range(G)]
    w_stack = [torch.cat([w_hh[l], w_ih[l]]).float() for l in range(G - 1)]
    dgates = gs.new_empty(gs.shape)
    dc = [gs.new_zeros((B, H), dtype=torch.float32) for _ in range(G)]
    zero = gs.new_zeros((B, H4))
    for r in range(T + G - 1):
        for l in range(G):
            t = T - 1 - (r - (G - 1 - l))
            if not 0 <= t < T:
                continue
            own = dgates[l, t + 1] if t + 1 < T else zero
            if l == G - 1:
                dh_mat = own.float() @ w_own[l]
            elif masks is None:
                dh_mat = torch.cat([own, dgates[l + 1, t]], dim=-1).float() @ w_stack[l]
            else:
                above = dgates[l + 1, t].float() @ w_ih[l].float()
                dh_mat = own.float() @ w_own[l] + above * masks[l, t].float()
            (i_a, f_a, g_a, o_a), (di_a, df_a, dg_a, do_a) = gate_activations(
                gs[l, t].float(), hard)
            tanh_c, dtanh_c = cell_activation(cs[l, t].float(), hard)
            dh = dys[l, t].float() + dh_mat
            d = dc[l] + dcs[l, t].float() + dh * o_a * dtanh_c
            dgates[l, t] = torch.cat([d * g_a * di_a, d * c_prev[l, t].float() * df_a,
                                      d * i_a * dg_a, dh * tanh_c * do_a], dim=-1).to(dtype)
            dc[l] = d * f_a
    dh0 = torch.stack([(dgates[l, 0] if T else zero).float() @ w_own[l] for l in range(G)])
    return dgates, dh0, torch.stack(dc)


# ------------------------------------------------------------------ kernels
def _check_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, what):
    T, B, H4 = gates_x0.shape
    H = H4 // 4
    G = h0.shape[0] if h0.dim() == 3 else 0
    dtype = gates_x0.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    if G < 1:
        raise ValueError(f"{what}: h0 must be [G, B, H] with G >= 1, got {tuple(h0.shape)}")
    ops = {"gates_x0": (gates_x0, (T, B, H4), dtype),
           "biases": (biases, (max(G - 1, 1), H4), torch.float32),
           "w0_hh": (w0_hh, (H4, H), dtype), "w_cats": (w_cats, (G - 1, H4, 2 * H), dtype),
           "h0": (h0, (G, B, H), dtype), "c0": (c0, (G, B, H), dtype)}
    if masks is not None:
        ops["masks"] = (masks, (G - 1, T, B, H), dtype)
    check_operands(gates_x0, ops, what)
    vectors = [w0_hh, h0] + ([w_cats] if G > 1 else []) + ([masks] if masks is not None else [])
    if any(t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"{what}: w0_hh, w_cats, h0 and masks must be 16-byte aligned")
    if _fwd_lib().lstm_wavefront_fwd_smem_bytes(H, G, DTYPE_CODE[dtype]) > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: H={H} needs more shared memory than a block has")
    return T, B, H, G


def _launch_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, store_gates):
    what = "lstm_wavefront_fwd_sg" if store_gates else "lstm_wavefront_fwd"
    T, B, H, G = _check_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, what)
    dtype = gates_x0.dtype
    ys = torch.empty((G, T, B, H), dtype=dtype, device=gates_x0.device)
    cs = torch.empty_like(ys)
    gs = torch.empty((G, T, B, 4 * H), dtype=dtype, device=gates_x0.device) if store_gates else None
    if T == 0:
        return ys, cs, gs, 0
    # [G, B, H] fp32, updated in place: a copy, never c0 itself
    c_state = torch.empty((G, B, H), dtype=torch.float32, device=c0.device)
    c_state.copy_(c0)
    lib = _fwd_lib()
    common = (gates_x0.data_ptr(), biases.data_ptr(), w0_hh.data_ptr(), w_cats.data_ptr(),
              0 if masks is None else masks.data_ptr(), h0.data_ptr(), c_state.data_ptr(),
              ys.data_ptr(), cs.data_ptr())
    tail = (T, B, H, G, int(hard), DTYPE_CODE[dtype], stream_of(gates_x0))
    if store_gates:
        check(lib.lstm_wavefront_fwd_sg(*common, gs.data_ptr(), *tail), what)
    else:
        check(lib.lstm_wavefront_fwd(*common, *tail), what)
    return ys, cs, gs, T + G - 1


@counted
def lstm_wavefront(gates_x0, biases, w0_hh, w_cats, h0, c0, masks: Optional[torch.Tensor] = None,
                   hard: bool = False):
    """K8-fwd: the G-layer wavefront forward; same contract as
    :func:`lstm_wavefront_plain` without stored gates, returning (ys, cs).

    CPU tensors take the plain version. CUDA tensors launch the kernel once
    per superstep, T + G - 1 launches, counted in ``lstm_wavefront.launches``;
    anything the kernel does not take raises.
    """
    if gates_x0.device.type == "cpu":
        return lstm_wavefront_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, False)
    if gates_x0.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x0.device}")
    ys, cs, _, n = _launch_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, False)
    lstm_wavefront.launches += n
    return ys, cs


@counted
def lstm_wavefront_sg(gates_x0, biases, w0_hh, w_cats, h0, c0,
                      masks: Optional[torch.Tensor] = None, hard: bool = False):
    """K8-fwd storing the pre-activations: returns (ys, cs, gs), the contract
    of :func:`lstm_wavefront_plain` with ``store_gates``. T + G - 1 launches,
    counted in ``lstm_wavefront_sg.launches``."""
    if gates_x0.device.type == "cpu":
        return lstm_wavefront_sg_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard)
    if gates_x0.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x0.device}")
    ys, cs, gs, n = _launch_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, True)
    lstm_wavefront_sg.launches += n
    return ys, cs, gs


@counted
def lstm_wavefront_bwd(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard: bool = False):
    """K8-bwd: the reverse wavefront; same contract as
    :func:`lstm_wavefront_bwd_plain`. T + G launches (one per reverse
    superstep, the last one for layer 0's dh0), counted in
    ``lstm_wavefront_bwd.launches``."""
    if gs.device.type == "cpu":
        return lstm_wavefront_bwd_plain(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard)
    if gs.device.type != "cuda":
        raise ValueError(f"unsupported device {gs.device}")
    what = "lstm_wavefront_bwd"
    G, T, B, H4 = gs.shape
    H = H4 // 4
    dtype = gs.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    state = ((G, T, B, H), dtype)
    ops = {"gs": (gs, (G, T, B, H4), dtype), "cs": (cs, *state), "c_prev": (c_prev, *state),
           "dys": (dys, *state), "dcs": (dcs, *state), "w_hh": (w_hh, (G, H4, H), dtype),
           "w_ih": (w_ih, (G - 1, H4, H), dtype)}
    if masks is not None:
        ops["masks"] = (masks, (G - 1, T, B, H), dtype)
    check_operands(gs, ops, what)
    lib = _bwd_lib()
    if lib.lstm_wavefront_bwd_smem_bytes(DTYPE_CODE[dtype]) > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: the block needs more shared memory than a block has")
    dgates = torch.empty_like(gs)
    dh0 = torch.zeros((G, B, H), dtype=torch.float32, device=gs.device)
    dc = torch.zeros((G, B, H), dtype=torch.float32, device=gs.device)  # carry, in place
    if T == 0:
        return dgates, dh0, dc
    # [H, 4H] per layer: a unit's contraction is contiguous
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    w_ih_t = w_ih.transpose(1, 2).contiguous()
    check(lib.lstm_wavefront_bwd(
        gs.data_ptr(), cs.data_ptr(), c_prev.data_ptr(), dys.data_ptr(), dcs.data_ptr(),
        0 if masks is None else masks.data_ptr(), w_hh_t.data_ptr(), w_ih_t.data_ptr(),
        dgates.data_ptr(), dh0.data_ptr(), dc.data_ptr(),
        T, B, H, G, int(hard), DTYPE_CODE[dtype], stream_of(gs)), what)
    lstm_wavefront_bwd.launches += T + G
    return dgates, dh0, dc
