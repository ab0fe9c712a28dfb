"""LSTM recurrence kernels: the hand-written Hopper kernels, their plain
PyTorch versions, their launch counts and the autograd Function around them.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_lstm.py``:

- K1 ``_kernel``: the forward recurrence (``lstm_recurrence``);
- K3a ``_kernel_sg``: K1 that also stores the pre-activations, the forward
  of a step that needs gradients (``lstm_recurrence_sg``); one CUDA source
  with K1, ``csrc/lstm_recurrence.cu``, under a compile-time flag;
- K3b ``_bwd_kernel``: the reverse dh/dc recurrence
  (``lstm_recurrence_bwd``, ``csrc/lstm_recurrence_bwd.cu``).

``LSTMRecurrence`` is the ``jax.custom_vjp`` of ``pallas_lstm.py:326-473``:
its forward runs K3a (or K1 when ``store_gates`` is off, the backward then
recomputing the gates with one matmul), its backward K3b, and
``dW_hh = dgates^T h_prev`` is one ``torch.matmul`` outside the kernel, as
the JAX package leaves it to XLA.

What bounds them on an H100: per step the work is ``2*B*H*4H`` FLOPs against
``w_hh`` (8 MB in bf16 at H=1024) — at B=16 about 34 MFLOP per step, far too
little to fill the card, so the least time for a layer is set by reading
``w_hh`` once and streaming the per-step tensors, or by the FLOPs at the
card's peak, whichever is larger (``chip_smoke.py`` computes both). The
steps are sequential, so the real limit is per-step latency: the simple
designs launch once per step and re-read ``w_hh`` from L2/HBM every step.
The Pallas kernels keep ``w_hh`` resident in VMEM; the Hopper answer is a
persistent cooperative kernel with ``w_hh`` split across the SMs' shared
memory and a grid-wide sync per step, left for a later change.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from caiman_asr_tpu_torch.ops.cuda_build import (
    DTYPE_CODE, MAX_SMEM_BYTES, I, P, check, check_operands, counted, load, stream_of,
)
from caiman_asr_tpu_torch.ops.lstm import cell_activation, gate_activations, gate_math

Pair = Tuple[torch.Tensor, torch.Tensor]


@functools.cache
def _fwd_lib():
    return load("lstm_recurrence", {
        "lstm_recurrence_fwd": ([P] * 6 + [I] * 5 + [P], I),
        "lstm_recurrence_fwd_sg": ([P] * 7 + [I] * 5 + [P], I),
        "lstm_recurrence_fwd_smem_bytes": ([I, I], ctypes.c_size_t),
    })


@functools.cache
def _bwd_lib():
    return load("lstm_recurrence_bwd", {
        "lstm_recurrence_bwd": ([P] * 9 + [I] * 5 + [P], I),
        "lstm_recurrence_bwd_smem_bytes": ([I], ctypes.c_size_t),
    })


# ------------------------------------------------------------ plain versions
def _recurrence_plain(gates_x, w_hh, h0, c0, hard, store_gates):
    dtype = gates_x.dtype
    w_t = w_hh.float().t()
    h = h0.float()
    c = c0.float()
    ys, cs, gs = [], [], []
    for t in range(gates_x.shape[0]):
        gates = gates_x[t].float() + h.to(w_hh.dtype).float() @ w_t
        if store_gates:
            gs.append(gates.to(dtype))
        h, c = gate_math(gates, c, hard)
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    if not ys:
        empty = gates_x.new_empty((0,) + tuple(h0.shape))
        return (empty, empty.clone()) + ((gates_x.new_empty(gates_x.shape),) if store_gates else ())
    out = (torch.stack(ys), torch.stack(cs))
    return out + ((torch.stack(gs),) if store_gates else ())


def lstm_recurrence_plain(gates_x, w_hh, h0, c0, hard: bool) -> Pair:
    """K1's contract in plain PyTorch.

    gates_x: [T, B, 4H] pre-activations (x-projection + bias) in the compute
    dtype; w_hh: [4H, H] in the compute dtype; h0, c0: [B, H]. h and c are
    carried in fp32, h is cast to the weight dtype for the product, which
    accumulates in fp32 (the bf16 products are exact in fp32). Returns
    (ys, cs), each [T, B, H] in the compute dtype.
    """
    return _recurrence_plain(gates_x, w_hh, h0, c0, hard, False)


def lstm_recurrence_sg_plain(gates_x, w_hh, h0, c0, hard: bool):
    """K3a's contract: K1's, also returning gs [T, B, 4H], the full
    pre-activations ``gates_x + h_{t-1} @ w_hh^T`` in the compute dtype."""
    return _recurrence_plain(gates_x, w_hh, h0, c0, hard, True)


def lstm_recurrence_bwd_plain(gates, c_prev, cs, dys, dcs, w_hh, hard: bool):
    """K3b's contract in plain PyTorch (``pallas_lstm.py:182-256``).

    gates: [T, B, 4H] pre-activations; c_prev, cs: [T, B, H] the cell states
    before and after each step; dys, dcs: [T, B, H] cotangents of ys and cs;
    all in the compute dtype; w_hh: [4H, H]. dh and dc are carried in fp32;
    dgates is rounded to the compute dtype, and that rounded value (cast to
    the weight dtype) feeds the next step's ``dgates @ w_hh``, accumulated in
    fp32. Returns (dgates [T, B, 4H] in the compute dtype, dh0, dc0 [B, H]
    fp32).
    """
    T, B, H4 = gates.shape
    H = H4 // 4
    dtype = gates.dtype
    w = w_hh.float()
    dh_next = gates.new_zeros((B, H), dtype=torch.float32)
    dc = torch.zeros_like(dh_next)
    out = [None] * T
    for t in reversed(range(T)):
        (i_a, f_a, g_a, o_a), (di_a, df_a, dg_a, do_a) = gate_activations(
            gates[t].float(), hard)
        tanh_c, dtanh_c = cell_activation(cs[t].float(), hard)
        dh = dys[t].float() + dh_next
        dc = dc + dcs[t].float() + dh * o_a * dtanh_c
        dg = torch.cat([dc * g_a * di_a, dc * c_prev[t].float() * df_a,
                        dc * i_a * dg_a, dh * tanh_c * do_a], dim=-1).to(dtype)
        out[t] = dg
        dh_next = dg.to(w_hh.dtype).float() @ w
        dc = dc * f_a
    dgates = torch.stack(out) if T else gates.new_empty(gates.shape)
    return dgates, dh_next, dc


# ------------------------------------------------------------------ kernels
def _check_fwd(gates_x, w_hh, h0, c0, what):
    T, B, H4 = gates_x.shape
    H = H4 // 4
    dtype = gates_x.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    check_operands(gates_x, {"gates_x": (gates_x, (T, B, H4), dtype),
                             "w_hh": (w_hh, (H4, H), dtype), "h0": (h0, (B, H), dtype),
                             "c0": (c0, (B, H), dtype)}, what)
    if w_hh.data_ptr() % 16:
        raise ValueError("w_hh must be 16-byte aligned")
    if _fwd_lib().lstm_recurrence_fwd_smem_bytes(H, DTYPE_CODE[dtype]) > MAX_SMEM_BYTES:
        raise ValueError(f"H={H} needs more shared memory than a block has")
    return T, B, H


def _launch_fwd(gates_x, w_hh, h0, c0, hard, store_gates):
    what = "lstm_recurrence_fwd_sg" if store_gates else "lstm_recurrence_fwd"
    T, B, H = _check_fwd(gates_x, w_hh, h0, c0, what)
    dtype = gates_x.dtype
    ys = torch.empty((T, B, H), dtype=dtype, device=gates_x.device)
    cs = torch.empty_like(ys)
    gs = torch.empty_like(gates_x) if store_gates else None
    if T == 0:
        return ys, cs, gs
    h_buf = torch.empty((2, B, H), dtype=torch.float32, device=gates_x.device)
    c_buf = torch.empty_like(h_buf)
    h_buf[0].copy_(h0)
    c_buf[0].copy_(c0)
    lib = _fwd_lib()
    common = (gates_x.data_ptr(), w_hh.data_ptr(), h_buf.data_ptr(), c_buf.data_ptr(),
              ys.data_ptr(), cs.data_ptr())
    tail = (T, B, H, int(hard), DTYPE_CODE[dtype], stream_of(gates_x))
    if store_gates:
        check(lib.lstm_recurrence_fwd_sg(*common, gs.data_ptr(), *tail), what)
    else:
        check(lib.lstm_recurrence_fwd(*common, *tail), what)
    return ys, cs, gs


@counted
def lstm_recurrence(gates_x, w_hh, h0, c0, hard: bool = False) -> Pair:
    """K1: one layer's forward recurrence; same contract as
    :func:`lstm_recurrence_plain`.

    CPU tensors take the plain version. CUDA tensors launch the kernel, once
    per time step, and add one to ``lstm_recurrence.launches`` per launch;
    anything the kernel does not take raises.
    """
    if gates_x.device.type == "cpu":
        return lstm_recurrence_plain(gates_x, w_hh, h0, c0, hard)
    if gates_x.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x.device}")
    ys, cs, _ = _launch_fwd(gates_x, w_hh, h0, c0, hard, False)
    lstm_recurrence.launches += gates_x.shape[0]  # one launch per time step
    return ys, cs


@counted
def lstm_recurrence_sg(gates_x, w_hh, h0, c0, hard: bool = False):
    """K3a: K1 that also returns the pre-activations gs; same contract as
    :func:`lstm_recurrence_sg_plain`. One launch per step, counted in
    ``lstm_recurrence_sg.launches``."""
    if gates_x.device.type == "cpu":
        return lstm_recurrence_sg_plain(gates_x, w_hh, h0, c0, hard)
    if gates_x.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x.device}")
    out = _launch_fwd(gates_x, w_hh, h0, c0, hard, True)
    lstm_recurrence_sg.launches += gates_x.shape[0]
    return out


@counted
def lstm_recurrence_bwd(gates, c_prev, cs, dys, dcs, w_hh, hard: bool = False):
    """K3b: the reverse recurrence; same contract as
    :func:`lstm_recurrence_bwd_plain`. T+1 launches (one per reverse step,
    one for dh0), counted in ``lstm_recurrence_bwd.launches``."""
    if gates.device.type == "cpu":
        return lstm_recurrence_bwd_plain(gates, c_prev, cs, dys, dcs, w_hh, hard)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    what = "lstm_recurrence_bwd"
    T, B, H4 = gates.shape
    H = H4 // 4
    dtype = gates.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    state = ((T, B, H), dtype)
    check_operands(gates, {"gates": (gates, (T, B, H4), dtype), "c_prev": (c_prev, *state),
                           "cs": (cs, *state), "dys": (dys, *state), "dcs": (dcs, *state),
                           "w_hh": (w_hh, (H4, H), dtype)}, what)
    lib = _bwd_lib()
    if lib.lstm_recurrence_bwd_smem_bytes(DTYPE_CODE[dtype]) > MAX_SMEM_BYTES:
        raise ValueError("the backward block needs more shared memory than a block has")
    w_t = w_hh.t().contiguous()  # [H, 4H]: a unit's contraction is contiguous
    dgates = torch.empty_like(gates)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=gates.device)
    dc_buf = torch.zeros((2, B, H), dtype=torch.float32, device=gates.device)
    check(lib.lstm_recurrence_bwd(
        gates.data_ptr(), c_prev.data_ptr(), cs.data_ptr(), dys.data_ptr(), dcs.data_ptr(),
        w_t.data_ptr(), dgates.data_ptr(), dh0.data_ptr(), dc_buf.data_ptr(),
        T, B, H, int(hard), DTYPE_CODE[dtype], stream_of(gates)), what)
    lstm_recurrence_bwd.launches += T + 1
    return dgates, dh0, dc_buf[T % 2]


# ----------------------------------------------------------------- autograd
class LSTMRecurrence(torch.autograd.Function):
    """Differentiable recurrence (inputs gates_x, w_hh, h0, c0 as for
    :func:`lstm_recurrence`; returns (ys, cs)).

    With ``store_gates`` (the default, as in the JAX package) the forward
    runs K3a and saves its pre-activations; without, it runs K1 and the
    backward recomputes the gates with one matmul (``pallas_lstm.py:384-391``).
    The backward runs K3b and forms ``dW_hh`` with one matmul.
    """

    @staticmethod
    def forward(ctx, gates_x, w_hh, h0, c0, hard: bool, store_gates: bool):
        ctx.hard, ctx.store_gates = hard, store_gates
        if store_gates:
            ys, cs, gs = lstm_recurrence_sg(gates_x, w_hh, h0, c0, hard)
            ctx.save_for_backward(gs, w_hh, h0, c0, ys, cs)
        else:
            ys, cs = lstm_recurrence(gates_x, w_hh, h0, c0, hard)
            ctx.save_for_backward(gates_x, w_hh, h0, c0, ys, cs)
        return ys, cs

    @staticmethod
    def backward(ctx, dys, dcs):
        g, w_hh, h0, c0, ys, cs = ctx.saved_tensors
        T, B, H = ys.shape
        h_prev = torch.cat([h0[None].to(ys.dtype), ys[:-1]])
        c_prev = torch.cat([c0[None].to(cs.dtype), cs[:-1]])
        if ctx.store_gates:
            gates = g
        else:
            rec = h_prev.reshape(T * B, H).to(w_hh.dtype).float() @ w_hh.float().t()
            gates = (g.float() + rec.reshape(T, B, 4 * H)).to(g.dtype)
        dgates, dh0, dc0 = lstm_recurrence_bwd(
            gates, c_prev, cs, dys.contiguous(), dcs.contiguous(), w_hh, ctx.hard)
        dw = torch.matmul(dgates.reshape(T * B, 4 * H).t().to(w_hh.dtype),
                          h_prev.reshape(T * B, H).to(w_hh.dtype))
        return dgates, dw, dh0.to(h0.dtype), dc0.to(c0.dtype), None, None


def recurrence(gates_x, w_hh, h0, c0, hard: bool = False, store_gates: bool = True) -> Pair:
    """One layer's recurrence: through ``LSTMRecurrence`` when a gradient is
    wanted, else K1 alone (the undifferentiated call never pays for storing
    the gates, ``pallas_lstm.py:341-344``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gates_x, w_hh, h0, c0)):
        return LSTMRecurrence.apply(gates_x, w_hh, h0, c0, hard, store_gates)
    return lstm_recurrence(gates_x, w_hh, h0, c0, hard)
