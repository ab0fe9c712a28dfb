"""Wavefront multi-layer LSTM, mirroring the public function and custom VJP
of ``caiman_asr_tpu/ops/pallas_wavefront.py``.

``run_lstm_stack_wavefront`` runs G stacked same-width layers as one
(layer, time) wavefront: layer 0's input projection is one matmul outside,
and the G recurrences, with the inner layers' input projections and the
inter-layer dropout, run in K8-fwd (``ops/wavefront_kernel.py``). Under a
gradient it goes through ``WavefrontLSTM``, whose backward runs K8-bwd and
forms the weight gradients with matmuls over the emitted dgates, as the JAX
package leaves them to XLA. CUDA tensors launch the kernels, CPU tensors
take their plain versions.

Like its JAX counterpart, this is an entry point of its own: the encoder
keeps the per-layer ``ops/lstm.run_lstm``. ``python -m
caiman_asr_tpu_torch.bench_wavefront`` times the two against each other.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from caiman_asr_tpu_torch.ops import wavefront_kernel as wk
from caiman_asr_tpu_torch.ops.lstm import Params, dot_f32

Pair = Tuple[torch.Tensor, torch.Tensor]


class WavefrontLSTM(torch.autograd.Function):
    """Differentiable wavefront (``pallas_wavefront.py:452-596``).

    Inputs as for :func:`wavefront_kernel.lstm_wavefront_plain`: gates_x0
    [T, B, 4H], biases [max(G-1, 1), 4H] fp32, w0_hh [4H, H], w_cats
    [G-1, 4H, 2H], h0, c0 [G, B, H], masks None or [G-1, T, B, H] (constants:
    no gradient), then ``hard`` and ``store_gates``. Returns (ys, cs), each
    [G, T, B, H].

    With ``store_gates`` the forward runs K8-fwd storing its pre-activations;
    without, K8-fwd alone, and the backward recomputes the gates with one
    matmul per layer (``pallas_wavefront.py:520-534``). The backward runs
    K8-bwd, then ``dW = dgates^T [x ; h_prev]`` per layer and the inner
    biases' gradients as sums over dgates.
    """

    @staticmethod
    def forward(ctx, gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard: bool,
                store_gates: bool):
        ctx.hard, ctx.store_gates = hard, store_gates
        if store_gates:
            ys, cs, g = wk.lstm_wavefront_sg(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard)
        else:
            ys, cs = wk.lstm_wavefront(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard)
            g = gates_x0
        ctx.save_for_backward(g, biases, w0_hh, w_cats, h0, c0, masks, ys, cs)
        return ys, cs

    @staticmethod
    def backward(ctx, dys, dcs):
        g, biases, w0_hh, w_cats, h0, c0, masks, ys, cs = ctx.saved_tensors
        G, T, B, H = ys.shape
        dtype = ys.dtype
        h_prev = torch.cat([h0[:, None].to(dtype), ys[:, :-1]], dim=1)
        c_prev = torch.cat([c0[:, None].to(dtype), cs[:, :-1]], dim=1)
        # the inner layers' inputs: the masked outputs of the layers below
        xs = ys[:-1] if masks is None else (ys[:-1].float() * masks.float()).to(dtype)
        xin = [torch.cat([xs[l - 1], h_prev[l]], dim=-1).reshape(T * B, 2 * H)
               for l in range(1, G)]
        if ctx.store_gates:
            gs = g
        else:  # recompute the pre-activations with one matmul per layer
            rec = [(g.float() + (h_prev[0].reshape(T * B, H).float() @ w0_hh.float().t())
                    .reshape(T, B, 4 * H)).to(dtype)]
            rec += [((xin[l - 1].float() @ w_cats[l - 1].float().t()).reshape(T, B, 4 * H)
                     + biases[l - 1]).to(dtype) for l in range(1, G)]
            gs = torch.stack(rec)
        w_hh = torch.cat([w0_hh[None], w_cats[:, :, H:]])
        w_ih = w_cats[:, :, :H].contiguous()
        dgates, dh0, dc0 = wk.lstm_wavefront_bwd(
            gs, cs, c_prev.contiguous(), dys.contiguous(), dcs.contiguous(), masks, w_hh, w_ih,
            ctx.hard)
        flat = dgates.reshape(G, T * B, 4 * H)
        d_w0 = torch.matmul(flat[0].t(), h_prev[0].reshape(T * B, H))
        d_wcats = torch.stack([torch.matmul(flat[l].t(), xin[l - 1]) for l in range(1, G)]
                              ) if G > 1 else torch.zeros_like(w_cats)
        d_biases = (flat[1:].float().sum(dim=1) if G > 1 else torch.zeros_like(biases))
        return (dgates[0], d_biases, d_w0, d_wcats, dh0.to(h0.dtype), dc0.to(c0.dtype), None,
                None, None)


def stack_operands(layer_params: Sequence[Params], x: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor):
    """``WavefrontLSTM``'s operands from per-layer parameters
    (``pallas_wavefront.py:631-648``): (gates_x0, biases, w0_hh, w_cats, h0,
    c0), all in x's dtype but the fp32 biases.

    Layer 0's input projection plus its fp32 bias is one matmul, rounded to
    the compute dtype, outside the kernel, so autograd carries its gradient
    into x, ``w_ih^0`` and layer 0's biases (in bf16 the product is rounded
    before the bias add, as ``ops/lstm.dot_f32`` says). The inner layers'
    ``[w_ih, w_hh]`` are concatenated along the contraction; G = 1 gets a
    zero bias row as a placeholder.
    """
    T, B, _ = x.shape
    G = len(layer_params)
    H = layer_params[0]["w_hh"].shape[1]
    dtype = x.dtype
    for l, p in enumerate(layer_params[1:], start=1):
        if p["w_ih"].shape[1] != H:
            raise ValueError(f"layer {l} has input width {p['w_ih'].shape[1]}; the wavefront "
                             f"needs every layer past the first to take H={H}")
    p0 = layer_params[0]
    bias0 = (p0["b_ih"] + p0["b_hh"]).float()
    gates_x0 = (dot_f32(x.reshape(T * B, -1), p0["w_ih"].t()).reshape(T, B, -1)
                + bias0).to(dtype)
    inner = layer_params[1:]
    if inner:
        w_cats = torch.stack([torch.cat([p["w_ih"].to(dtype), p["w_hh"].to(dtype)], dim=1)
                              for p in inner])
        biases = torch.stack([(p["b_ih"] + p["b_hh"]).float() for p in inner])
    else:
        w_cats = x.new_empty((0, 4 * H, 2 * H))
        biases = torch.zeros((1, 4 * H), dtype=torch.float32, device=x.device)
    return (gates_x0, biases, p0["w_hh"].to(dtype).contiguous(), w_cats, h0.to(dtype),
            c0.to(dtype))


def dropout_masks(G: int, T: int, B: int, H: int, rate: float, dtype,
                  generator: torch.Generator, device) -> Optional[torch.Tensor]:
    """The inter-layer dropout scale fields entering layers 1..G-1, [G-1, T,
    B, H] in ``dtype``: each drawn in layer order with ``ops/lstm._dropout``'s
    keep rule (``rand < 1 - rate``), valued ``1/(1-rate)`` where kept. None
    at rate 0, which draws nothing."""
    if rate <= 0.0:
        return None
    fields = [torch.rand((T, B, H), generator=generator, device=device) < 1.0 - rate
              for _ in range(G - 1)]
    keep = torch.stack(fields) if fields else torch.zeros((0, T, B, H), dtype=torch.bool,
                                                           device=device)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(dtype)


def run_lstm_stack_wavefront(
    layer_params: Sequence[Params],
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    *,
    hard: bool = False,
    t_blk: int = 4,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    store_gates: bool = True,
) -> Pair:
    """Run G stacked same-width LSTM layers as one wavefront
    (``pallas_wavefront.py:600-665``).

    layer_params: per-layer dicts (``w_ih`` [4H, I], ``w_hh`` [4H, H],
    ``b_ih``, ``b_hh``); layers 1..G-1 must have I == H, or this raises.
    x: [T, B, I0]; h0, c0: [G, B, H]. ``dropout`` is the inter-layer dropout
    entering layers 1..G-1, its masks drawn from ``generator`` (see
    :func:`dropout_masks`; the JAX package's keys give other bits); without a
    generator a positive rate raises. ``t_blk`` is the TPU kernel's block of
    supersteps: checked, and ignored on the card, where each superstep is a
    launch of its own; it never changes the result. ``store_gates`` keeps the
    pre-activations for the backward instead of recomputing them; a call
    that needs no gradient never stores them.

    Returns (all_ys, all_cs), each [G, T, B, H] in x's dtype: raw, before
    dropout, as ``run_lstm``'s all_h / all_c.
    """
    if not isinstance(t_blk, int) or isinstance(t_blk, bool) or t_blk < 1:
        raise ValueError(f"t_blk must be a positive int, got {t_blk!r}")
    if dropout > 0.0 and generator is None:
        raise ValueError("dropout requires a generator")
    T, B, _ = x.shape
    G = len(layer_params)
    H = layer_params[0]["w_hh"].shape[1]
    ops = stack_operands(layer_params, x, h0, c0)
    masks = dropout_masks(G, T, B, H, dropout, x.dtype, generator, x.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return WavefrontLSTM.apply(*ops, masks, hard, store_gates)
    return wk.lstm_wavefront(*ops, masks, hard)
