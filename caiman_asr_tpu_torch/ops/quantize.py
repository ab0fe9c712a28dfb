"""FPGA-numerics emulation quantizers (the port of
``caiman_asr_tpu/ops/quantize.py``; reference:
lib/src/rnnt_ext/custom_lstm/quantize.py:9-70, built on qtorch).

Fake quantisation in plain PyTorch, the JAX package's arithmetic step for
step:
- ``brain_float_quantize``: round to a custom FP(exp, man) format (the
  reference's BrainFloatQuantizer; exp=8, man=7 = bfloat16);
- ``bfp_quantize``: block floating point — a shared exponent per block along
  one axis, mantissas rounded to ``man`` bits (BfpQuantizer).

Both are straight-through-estimator friendly (wrap with ``ste(x,
quantizer)``). The arithmetic is the JAX package's as XLA computes it:

- ``_frexp`` is the JAX formula, not ``torch.frexp``: the exponent is
  ``floor(log2|x|) + 1`` with a fix-up only where the mantissa reaches 1,
  so where ``log2`` rounds up just below a power of two the mantissa lands
  in [0.25, 0.5) and the scale is one bit coarse, as in JAX. ``jnp.log2``
  is ``log(x) / log(2)``, which XLA computes as its fp32 ``log`` (the
  Cephes polynomial, Eigen's ``plog``) times the fp32 reciprocal of
  ``log(2)``; that rounds differently from ``torch.log2`` at some powers
  of two (``2^-30``, ``2^13``, ...) and so moves the floor there.
  :func:`_log` evaluates that polynomial in the same fp32 steps;
- ``lax.exp2`` is ``exp(x * fp32(ln 2))``, which for integer x is not a
  power of two outside about [-12, 12] (``2^13`` comes out as 8192.0005):
  :func:`_exp2` gathers those values from a table (the fp32 product, its
  exponential rounded once to fp32), so the scales, and the grids they
  set, are JAX's and the same on every device;
- XLA flushes subnormal inputs and results to zero, and so do these.

``torch.round`` rounds half to even, as ``jnp.round`` does. Every product
here is elementwise: nothing depends on TF32.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)  # the smallest normal fp32
_EXP2_SPAN = 320  # table entries for integer exponents in [-span, span]


def _exp2_values() -> np.ndarray:
    n = np.arange(-_EXP2_SPAN, _EXP2_SPAN + 1, dtype=np.float32)
    t = n * np.float32(math.log(2.0))  # the fp32 product, as lax.exp2 forms it
    with np.errstate(over="ignore"):
        v = np.exp(t.astype(np.float64)).astype(np.float32)
    v[v < _TINY] = 0.0  # a subnormal result flushed
    return v


_EXP2 = _exp2_values()
_EXP2_BY_DEVICE: dict = {}


def prepare(device) -> None:
    """Put the exp2 table on ``device`` ahead of use: its upload cannot run
    inside a CUDA graph's capture (a quantized model does this when built)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _EXP2_BY_DEVICE:
        _EXP2_BY_DEVICE[device] = torch.from_numpy(_EXP2).to(device)


def _exp2(n: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of integer-valued ``n`` (any integer or float dtype)."""
    if n.device not in _EXP2_BY_DEVICE:
        if n.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"quantize.prepare({n.device}) must run before a graph capture")
        prepare(n.device)
    table = _EXP2_BY_DEVICE[n.device]
    idx = torch.clamp(n.to(torch.int64) + _EXP2_SPAN, 0, 2 * _EXP2_SPAN)
    return table[idx]


# Cephes' logf, as Eigen's plog evaluates it (three interleaved Horner
# chains over x, x^3): p0 .. p8, then q1, q2 with ln 2 = q2 + q1
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524
_INV_LN2_F32 = float(np.float32(1.0) / np.float32(math.log(2.0)))


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 natural log of positive normal ``x``, each step one fp32
    operation (no fused multiply-add)."""
    m, e = torch.frexp(x)  # m in [0.5, 1)
    e = e.float()
    small = m < _SQRTHF
    e = torch.where(small, e - 1.0, e)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = p[0] * m + p[1]
    y1 = p[3] * m + p[4]
    y2 = p[6] * m + p[7]
    y = y * m + p[2]
    y1 = y1 * m + p[5]
    y2 = y2 * m + p[8]
    y = y * m3 + y1
    y = y * m3 + y2
    y = y * m3
    y = _LOG_Q1 * e + y
    r = m - m2 * 0.5
    r = r + y
    return e * _LOG_Q2 + r


# XLA's fp32 tanh: Eigen's rational approximation, clamped, with fused
# multiply-adds in its two Horner chains
_TANH_CLAMP = 7.99881172180175781
_TANH_A = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_B = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)
_TANH_A, _TANH_B = (tuple(float(np.float32(v)) for v in c) for c in (_TANH_A, _TANH_B))


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once (the product of two fp32 values is
    exact in fp64)."""
    return (a.double() * b.double() + c).float()


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` of fp32 ``x`` as XLA computes it."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = torch.full_like(x2, _TANH_A[0])
    for a in _TANH_A[1:]:
        p = _fma(p, x2, a)
    p = p * xc
    q = torch.full_like(x2, _TANH_B[0])
    for b in _TANH_B[1:]:
        q = _fma(q, x2, b)
    return torch.where(x.abs() < 0.0004, x, p / q)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to zero of their sign (XLA's denormals-are-zero)."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def brain_float_quantize(x: torch.Tensor, exp_bits: int = 8, man_bits: int = 7) -> torch.Tensor:
    """Round-to-nearest-even into FP(exp_bits, man_bits) with IEEE-style
    exponent range; values beyond the format saturate."""
    x = _flush(torch.as_tensor(x).float())
    bias = (1 << (exp_bits - 1)) - 1
    max_exp = bias
    min_exp = 1 - bias  # smallest normal exponent

    _, expo = _frexp(x)
    # frexp returns mant in [0.5, 1); convert to [1, 2) convention
    expo_c = torch.clamp(expo - 1, min_exp, max_exp)
    scale = _exp2(man_bits - expo_c)
    q = _flush(torch.round(x * scale) / scale)
    # saturate to the max representable magnitude
    max_val = (2.0 - 2.0 ** (-man_bits)) * 2.0**max_exp
    q = torch.clamp(q, -max_val, max_val)
    return torch.where(x == 0.0, 0.0, q)


def bfp_quantize(x: torch.Tensor, man_bits: int = 8, axis: int = -1, block: int = 0
                 ) -> torch.Tensor:
    """Block floating point: shared exponent = exponent of the block max;
    mantissas rounded to man_bits. With ``block`` dividing the axis, one
    exponent per ``block`` consecutive elements; else one for the whole
    axis."""
    x = _flush(torch.as_tensor(x).float())
    moved = torch.movedim(x, axis, -1)
    if block and x.shape[axis] % block == 0:
        shp = moved.shape
        blocked = moved.reshape(shp[:-1] + (shp[-1] // block, block))
        q = _bfp_last_axis(blocked, man_bits).reshape(shp)
    else:
        q = _bfp_last_axis(moved, man_bits)
    return torch.movedim(q, -1, axis)


def _bfp_last_axis(x: torch.Tensor, man_bits: int) -> torch.Tensor:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    _, e = _frexp(absmax)
    scale = _exp2((man_bits - 1) - e)
    scale = torch.where(absmax == 0.0, 1.0, scale)
    return _flush(torch.clamp(
        torch.round(x * scale), -(2.0 ** (man_bits - 1)), 2.0 ** (man_bits - 1) - 1
    ) / scale)


def _frexp(x: torch.Tensor):
    """Portable frexp: mantissa in [0.5, 1) (or one bit below, see the
    module's docstring), integer exponent."""
    ax = _flush(x).abs()
    pos = ax > 0
    log2 = _log(torch.where(pos, ax, 1.0)) * _INV_LN2_F32
    e = torch.where(pos, torch.floor(log2) + 1, 0.0).to(torch.int32)
    m = _flush(torch.where(pos, ax / _exp2(e), 0.0))
    # guard numerical edge: m must be < 1
    fix = m >= 1.0
    e = e + fix.to(torch.int32)
    m = torch.where(fix, m / 2.0, m)
    return m, e


def ste(x: torch.Tensor, quantizer) -> torch.Tensor:
    """Straight-through estimator: quantized forward, identity backward."""
    return x + (quantizer(x) - x).detach()


brainfloat16 = partial(brain_float_quantize, exp_bits=8, man_bits=7)
