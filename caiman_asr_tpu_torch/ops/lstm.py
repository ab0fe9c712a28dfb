"""Time-major multi-layer LSTM, mirroring ``caiman_asr_tpu/ops/lstm.py``.

A layer's parameters are a dict ``{"w_ih" [4H, I], "w_hh" [4H, H],
"b_ih" [4H], "b_hh" [4H]}`` with gate order i, f, g, o, plus an optional
``"bn"`` dict (``scale``, ``bias``, ``mean``, ``var``) for batch-norm on
the layer's output; a stack is ``{"layer_0": {...}, ...}`` — the JAX
package's parameter tree with tensors for leaves.

``run_lstm_layer`` computes the input projection for all time steps as one
matmul, rounds it to the compute dtype, and hands the sequential part to
``ops/lstm_kernel.recurrence``: the Hopper kernels for CUDA tensors (K1, or
under a gradient K3a forward and K3b backward), their plain versions for CPU
tensors. h and c are carried in fp32.

``quantize=True`` (a config's ``quantize: true``, evaluation only: ``run_lstm``
ignores it under ``train``) emulates the FPGA's arithmetic at the
reference's quantization points as the JAX package does
(``caiman_asr_tpu/ops/lstm.py:122-252, :393-445``): weights brain-float then
block-floating-point along the contraction axis, activations the same along
the feature axis (blocks of 8, the whole axis where 8 does not divide it),
the sum ``((xU + hV) + b_ih) + b_hh`` in fp32 with each bias brain-float
rounded, and the gates, cell and hidden state brain-float after each step.
It runs as a plain scan in fp32 whatever the input dtype, and so launches
no K1, as the JAX package's gate bypasses its Pallas kernel
(``caiman_asr_tpu/ops/lstm.py:215``). Its products must be true fp32: with
TF32 matmuls enabled it raises. ``run_lstm`` with ``train=True`` adds
the training-time dropouts and normalises with batch statistics; under
``batch_norm_group`` (the train step over several processes) those are the
statistics of the global batch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

Params = Dict[str, Any]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# the process group over which training batch-norm takes its statistics
# (None: this process's batch alone)
_BN_GROUP: List[Any] = [None]


@contextlib.contextmanager
def batch_norm_group(group):
    """Within, training batch-norm normalises with the statistics of the
    global batch: every rank of ``group`` contributes its rows."""
    prev, _BN_GROUP[0] = _BN_GROUP[0], group
    try:
        yield
    finally:
        _BN_GROUP[0] = prev


def _global_moments(yf: torch.Tensor, axes: tuple, group):
    """(mean, biased variance, count) of yf [..., H] over ``axes`` and every
    rank of ``group``: one all-reduce of the sum, the sum of squares and the
    count (in float64), through ``AllReduceSum`` so that the backward
    all-reduces their gradients."""
    from caiman_asr_tpu_torch.parallel.mesh import AllReduceSum

    y64 = yf.double()
    H = y64.shape[-1]
    local = torch.cat([y64.sum(axes), torch.square(y64).sum(axes),
                       y64.new_tensor([float(math.prod(yf.shape[:-1]))])])
    tot = AllReduceSum.apply(local, group)
    n = tot[2 * H]
    mu = tot[:H] / n
    var = tot[H:2 * H] / n - torch.square(mu)
    return mu.float(), var.float(), float(n.detach())


def hard_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """FPGA-parity hard sigmoid: clip(0.5 + z/8, 0, 1)."""
    return torch.clamp(0.5 + z * 0.125, 0.0, 1.0)


def hard_tanh(z: torch.Tensor) -> torch.Tensor:
    """FPGA-parity hard tanh: clip(z, -1, 1)."""
    return torch.clamp(z, -1.0, 1.0)


def gate_math(
    gates: torch.Tensor, c: torch.Tensor, hard: bool, quantize: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LSTM gate computation. gates: [..., 4H] fp32; c: [..., H] fp32.
    Returns (h_new, c_new) in fp32.

    quantize=True emulates the FPGA's brainfloat arithmetic at the
    reference's exact points (legacy.py:259-293: gates bf16 after the sum,
    each gate bf16 after its activation, cell and hidden bf16)."""
    H = c.shape[-1]
    sig = hard_sigmoid if hard else torch.sigmoid
    tnh = hard_tanh if hard else torch.tanh
    if quantize:
        from caiman_asr_tpu_torch.ops.quantize import brain_float_quantize as bf16q
        from caiman_asr_tpu_torch.ops.quantize import xla_tanh

        if not hard:  # the activations as XLA computes them
            sig = lambda z: 1.0 / (1.0 + torch.exp(-z))  # noqa: E731
            tnh = xla_tanh
        gates = bf16q(gates)
        i, f, g, o = (gates[..., k * H:(k + 1) * H] for k in range(4))
        i, f, g, o = bf16q(sig(i)), bf16q(sig(f)), bf16q(tnh(g)), bf16q(sig(o))
        # XLA fuses f * c + i * g into fma(f, c, i * g): one rounding
        c_new = bf16q((f.double() * c.double() + (i * g)).float())
        h_new = bf16q(o * tnh(c_new))
        return h_new, c_new
    i, f, g, o = (gates[..., k * H:(k + 1) * H] for k in range(4))
    c_new = sig(f) * c + sig(i) * tnh(g)
    h_new = sig(o) * tnh(c_new)
    return h_new, c_new


def gate_activations(gates: torch.Tensor, hard: bool):
    """Activated gates and their derivatives from fp32 pre-activations
    [..., 4H]: ((i, f, g, o), (i', f', g', o')). Hard derivatives are the
    clip windows of ``pallas_lstm.py:215-223``."""
    H = gates.shape[-1] // 4
    gi, gf, gg, go = (gates[..., k * H:(k + 1) * H] for k in range(4))
    if hard:
        window = lambda z, lim, slope: torch.where((z > -lim) & (z < lim), slope, 0.0)
        acts = (hard_sigmoid(gi), hard_sigmoid(gf), hard_tanh(gg), hard_sigmoid(go))
        return acts, (window(gi, 4.0, 0.125), window(gf, 4.0, 0.125),
                      window(gg, 1.0, 1.0), window(go, 4.0, 0.125))
    i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
    return (i, f, g, o), (i * (1.0 - i), f * (1.0 - f), 1.0 - g * g, o * (1.0 - o))


def cell_activation(c: torch.Tensor, hard: bool):
    """(tnh(c), tnh'(c)) for the fp32 cell state."""
    if hard:
        return hard_tanh(c), torch.where((c > -1.0) & (c < 1.0), 1.0, 0.0)
    t = torch.tanh(c)
    return t, 1.0 - t * t


def dot_f32(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """``x @ w_t`` in the dtype of x, returned in fp32. Both accumulate in
    fp32; in bf16 the product is rounded to bf16 once before the caller adds
    its fp32 bias (the JAX package rounds after the bias add)."""
    return torch.matmul(x, w_t.to(x.dtype)).float()


def _bfp_weights(w_t: torch.Tensor) -> torch.Tensor:
    """FPGA weight quantization of a transposed weight [in, 4H]: brainfloat
    then block-floating-point with a shared exponent per 8 consecutive
    elements of the contraction axis (reference legacy.py:251-252 +
    quantize.py BfpQuantizer(dim=0, 8))."""
    from caiman_asr_tpu_torch.ops.quantize import bfp_quantize, brain_float_quantize

    return bfp_quantize(brain_float_quantize(w_t), man_bits=8, axis=0, block=8)


def _bfp_acts(x: torch.Tensor) -> torch.Tensor:
    """FPGA activation quantization along the feature axis (reference
    legacy.py:264-265 + BfpQuantizer(dim=1, 8))."""
    from caiman_asr_tpu_torch.ops.quantize import bfp_quantize, brain_float_quantize

    return bfp_quantize(brain_float_quantize(x), man_bits=8, axis=-1, block=8)


_QUANTIZED_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _quantize_layer(p: Params, dtype) -> tuple:
    """(w_ih_t, w_hh_t, b_ih, b_hh) of one layer as the quantized path uses
    them: the weights cast to the compute dtype first, as the JAX package
    does, then quantized in fp32; each bias brain-float rounded."""
    from caiman_asr_tpu_torch.ops.quantize import brain_float_quantize

    return (_bfp_weights(p["w_ih"].to(dtype).float().t()),
            _bfp_weights(p["w_hh"].to(dtype).float().t()),
            brain_float_quantize(p["b_ih"].float()), brain_float_quantize(p["b_hh"].float()))


def _quantized_weights(p: Params, dtype) -> tuple:
    """One layer's quantized weights for ``dtype``, quantized once and kept
    on its ``w_ih`` (``._quantized``) beside the versions of the four
    tensors they came from. Weights written in place since (a checkpoint
    applied after ``eval()``) are requantized here into the same tensors,
    so a CUDA graph that read them reads the new values; under a capture
    the copy is read as it is, and a stale one raises. The decoders'
    first step runs eagerly, before any replay, and so refreshes it."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the quantized LSTM needs true fp32 products: TF32 matmuls are enabled "
            "(torch.backends.cuda.matmul.allow_tf32 / set_float32_matmul_precision)")
    w = p["w_ih"]
    versions = tuple(p[k]._version for k in _QUANTIZED_KEYS)
    kept = getattr(w, "_quantized", None)
    got = None if kept is None else kept.get(dtype)
    if got is not None and got[0] == versions and got[1][0].device == w.device:
        return got[1]
    if w.is_cuda and torch.cuda.is_current_stream_capturing():
        if got is not None:
            raise RuntimeError("the LSTM weights changed after they were quantized: run the "
                               "model eagerly once before capturing a graph")
        return _quantize_layer(p, dtype)  # a tree never run eagerly: quantized in the graph
    # plain tensors without a gradient, whatever the caller's mode: constants
    # to autograd, and refreshable in place in or out of inference mode
    with torch.inference_mode(False), torch.no_grad():
        fresh = _quantize_layer(p, dtype)
        if got is not None and got[1][0].device == w.device:
            for old, new in zip(got[1], fresh):
                old.copy_(new)
            fresh = got[1]
    if kept is None:
        kept = w._quantized = {}
    kept[dtype] = (versions, fresh)
    return fresh


def _run_quantized_layer(params: Params, x: torch.Tensor, h0: torch.Tensor,
                         c0: torch.Tensor, hard: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized scan (``caiman_asr_tpu/ops/lstm.py:224-252``); returns
    fp32 (ys, cs) [T, B, H]."""
    T, B, _ = x.shape
    w_ih_t, w_hh_t, bi, bh = _quantized_weights(params, x.dtype)
    gates_x = (_bfp_acts(x.float()).reshape(T * B, -1) @ w_ih_t).reshape(T, B, -1)
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(T):
        # the reference sums ((xU + hV) + bih) + bhh in that order
        # (legacy.py:272-275), so that the bf16 rounding matches
        gates = gates_x[t] + _bfp_acts(h) @ w_hh_t + bi + bh
        h, c = gate_math(gates, c, hard, True)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


def run_lstm_layer(
    params: Params,
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    *,
    hard: bool = False,
    quantize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one LSTM layer over x [T, B, I] from (h0, c0) [B, H].

    Returns (ys, cs): every hidden and cell state, each [T, B, H] in x.dtype
    (in fp32 with ``quantize``, as in the JAX package). Differentiable: under
    a gradient the recurrence goes through ``lstm_kernel.LSTMRecurrence``.
    """
    if quantize:
        return _run_quantized_layer(params, x, h0, c0, hard)
    # imported here: lstm_kernel imports gate_math from this module
    from caiman_asr_tpu_torch.ops import lstm_kernel

    T, B, _ = x.shape
    dtype = x.dtype
    bias = (params["b_ih"] + params["b_hh"]).float()
    gates_x = (
        dot_f32(x.reshape(T * B, -1), params["w_ih"].t()).reshape(T, B, -1) + bias
    ).to(dtype)
    return lstm_kernel.recurrence(
        gates_x, params["w_hh"].to(dtype).contiguous(), h0.to(dtype), c0.to(dtype),
        hard,
    )


def batch_norm_apply(bn: Params, y: torch.Tensor, train: bool = False,
                     updates: Optional[List] = None) -> torch.Tensor:
    """Batch-norm over the feature axis of y [..., H], computed in fp32
    (``caiman_asr_tpu/ops/lstm.py:281-306``).

    Eval: the running stats, a per-feature affine. ``train``: the batch's
    statistics over every (time, batch) position, padded frames included,
    the biased variance normalising (under ``batch_norm_group``, those of
    the global batch); with ``updates``, the pair
    (batch mean, unbiased batch variance), detached, is appended for the
    train step to fold into the running stats (``BN_MOMENTUM``)."""
    yf = y.float()
    if train:
        axes = tuple(range(y.ndim - 1))
        if _BN_GROUP[0] is not None:
            mu, var, n = _global_moments(yf, axes, _BN_GROUP[0])
        else:
            mu = yf.mean(axes)
            var = torch.square(yf - mu).mean(axes)
            n = math.prod(y.shape[:-1])
        if updates is not None:
            updates.append((mu.detach(), (var * (n / max(n - 1, 1))).detach()))
    else:
        mu, var = bn["mean"], bn["var"]
    out = (yf - mu) * torch.rsqrt(var + BN_EPS) * bn["scale"] + bn["bias"]
    return out.to(y.dtype)


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate, scale by 1/(1 - rate)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def run_lstm(
    params: Params,
    x: torch.Tensor,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    hard: bool = False,
    quantize: bool = False,
    train: bool = False,
    dropout: float = 0.0,
    rw_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    bn_updates: Optional[List] = None,
):
    """Run a multi-layer LSTM stack.

    Returns ``(output [T, B, H], (h_n, c_n) [L, B, H], (all_h, all_c)
    [L, T, B, H])``. Batch-norm applies to the layer output only; the
    recurrent state stays raw, and the initial state is detached.

    With ``train`` (``caiman_asr_tpu/ops/lstm.py:309-389``): ``dropout`` is
    applied between layers and to the output, ``rw_dropout`` is DropConnect
    on ``w_hh`` (a fresh mask per layer per call), all drawn from
    ``generator``. The masks are not the JAX package's bits: the same seed
    gives other numbers. A batch-norm layer normalises with the batch's
    statistics in training and appends them to ``bn_updates`` when given
    (:func:`batch_norm_apply`).
    """
    num_layers = len(params)
    T, B, _ = x.shape
    H = params["layer_0"]["w_hh"].shape[1]
    use_dropout = train and dropout > 0.0
    use_rw = train and rw_dropout > 0.0
    if (use_dropout or use_rw) and generator is None:
        raise ValueError("dropout requires a generator")
    all_h, all_c = [], []
    out = x
    for i in range(num_layers):
        if i > 0 and use_dropout:
            out = _dropout(out, dropout, generator)
        if state is None:
            h0 = x.new_zeros((B, H))
            c0 = x.new_zeros((B, H))
        else:
            h0, c0 = state[0][i].detach(), state[1][i].detach()
        layer = params[f"layer_{i}"]
        if use_rw:
            layer = dict(layer, w_hh=_dropout(layer["w_hh"], rw_dropout, generator))
        ys, cs = run_lstm_layer(layer, out, h0, c0, hard=hard,
                                quantize=quantize and not train)
        all_h.append(ys)
        all_c.append(cs)
        out = ys
        if "bn" in layer:
            out = batch_norm_apply(layer["bn"], out, train, bn_updates)
    if use_dropout:
        out = _dropout(out, dropout, generator)
    h_n = torch.stack([h[-1] for h in all_h])
    c_n = torch.stack([c[-1] for c in all_c])
    return out, (h_n, c_n), (torch.stack(all_h), torch.stack(all_c))


def lstm_step(
    params: Params,
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hard: bool = False,
    quantize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame through the whole stack: x [B, I], h and c [L, B, H].
    Returns (y [B, H], h_new, c_new [L, B, H]). With ``quantize``, the
    quantized step (``caiman_asr_tpu/ops/lstm.py:393-445``): the scan's
    arithmetic one frame at a time, its output cast back to x's dtype."""
    hs, cs = [], []
    out = x
    for i in range(h.shape[0]):
        p = params[f"layer_{i}"]
        dtype = out.dtype
        if quantize:
            w_ih_t, w_hh_t, bi, bh = _quantized_weights(p, dtype)
            gates = _bfp_acts(out.float()) @ w_ih_t + _bfp_acts(h[i].float()) @ w_hh_t + bi + bh
        else:
            gates = (
                dot_f32(out, p["w_ih"].t())
                + dot_f32(h[i].to(dtype), p["w_hh"].t())
                + (p["b_ih"] + p["b_hh"]).float()
            )
        h_new, c_new = gate_math(gates, c[i].float(), hard, quantize)
        out = h_new.to(dtype)
        hs.append(out)
        cs.append(c_new.to(dtype))
        if "bn" in p:
            out = batch_norm_apply(p["bn"], out)
    return out, torch.stack(hs), torch.stack(cs)
