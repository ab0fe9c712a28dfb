"""Fused joint + log-sum-exp for the transducer loss: the hand-written Hopper
kernels, their plain PyTorch versions, their launch counts, the store policy
and the autograd Function around them.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_joint.py``,
every one that its forward and its backward can reach:

- K2 ``_fwd_kernel``: per row ``sum_k exp(h . w_k + b_k)`` (``joint_fwd``);
- K5-store ``_fwd_kernel_store``: the same, also writing ``u = exp(z)`` to a
  bf16 ``[N, K]`` slab (``joint_fwd_store``);
- K7-store8 ``_fwd_kernel_store8``: the same, the slab as scaled int8 with
  one fp32 scale per row and vocab tile (``joint_fwd_store8``); one CUDA
  source with K2 and K5-store, ``csrc/joint_fwd.cu``, under a compile-time
  mode;
- K5-A ``_bwd_dh_kernel_u``: ``smear = -cs * (u @ W^T)`` (``joint_bwd_dh``);
- K5-B ``_bwd_dw_kernel_u``: ``dz = -cs * u + onehot(label) cl``,
  ``dW = h^T dz``, ``db = sum dz`` (``joint_bwd_dw``);
- K7-A8 ``_bwd_dh_kernel_u8`` and K7-B8 ``_bwd_dw_kernel_u8``: the same two
  passes over the int8 slab (``joint_bwd_dh_u8``, ``joint_bwd_dw_u8``); all
  four in ``csrc/joint_bwd.cu``;
- K5-fused-u ``_bwd_fused_kernel_u`` and K7-fused-u8
  ``_bwd_fused_kernel_u8``: both passes behind one call, over the bf16 and
  the int8 slab (``joint_bwd_fused_u``, ``joint_bwd_fused_u8``);
- K6-fused ``_bwd_fused_kernel``: both passes with no slab, ``u`` derived
  again from h, w, b (``joint_bwd_fused``); the three in
  ``csrc/joint_bwd_fused.cu``;
- K6-derive-a ``_derive_a_kernel``: for a chunk of rows, ``u`` derived again,
  written as a bf16 tile, and pass A from the fp32 ``u``
  (``joint_derive_a``; the rechunked backward walks the rows with it and
  K5-B);
- K4-A ``_bwd_dh_kernel`` and K4-B ``_bwd_dw_kernel``: the per-pass
  recompute over a range of vocab columns, each deriving the softmax
  ``p = exp(z - denom)`` itself (``joint_bwd_dh_recompute``,
  ``joint_bwd_dw_recompute``); the three in ``csrc/joint_bwd_recompute.cu``.
  The passes are templates over the source of u, shared by the three
  backward sources (``csrc/joint_bwd.cuh``), the derivation likewise
  (``csrc/joint_derive.cuh``).

``fused_joint_lse`` keeps the contract and the layouts of
``pallas_joint.py:630-638``. As there, there is no max subtraction: a logit
above ~88 makes the denominator inf, the loss non-finite, and the train
step skips the batch. Under a gradient the store policy (ported with its
constants and its ``CAIMAN_JOINT_*`` knobs, ``pallas_joint.py:552-720`` and
``:1061-1071``, so that the same shape takes the same route) picks the
forward, and the backward follows ``_vjp_bwd`` (``:1230-1343``) branch for
branch. The eight routes, and the knob that leads to each where the default
policy ("auto") does not:

==================  =============  ==========================  ======================
plan                forward        backward                    reached by
==================  =============  ==========================  ======================
bf16 slab           K5-store       K5-A + K5-B                 default
bf16 slab           K5-store       K5-fused-u                  ``FUSED_BWD=1``
int8 slab           K7-store8      K7-fused-u8                 default
int8 slab           K7-store8      K7-A8 + K7-B8               ``FUSED_BWD=0``
nothing stored      K2             K6-fused                    default
nothing stored      K2             K6-derive-a + K5-B per      ``FUSED_BWD=0``
                                   row chunk (rechunked)
nothing stored      K2             K4-A + K4-B                 ``FUSED_BWD=0``,
                                                               ``RECHUNK_MB=0``
bf16 slab over      K5-store over  the bf16 slab's backward    ``ZSTORE_PARTIAL=1``
``[0, ks)`` (the    ``[0, ks)``,   over ``[0, ks)``, K4-A +    when the whole slab
hybrid split)       K2 over        K4-B over ``[ks, K)``       is past the budget
                    ``[ks, K)``
==================  =============  ==========================  ======================

(``CAIMAN_JOINT_ZSTORE_DTYPE`` = ``bf16`` / ``i8`` / ``off`` and
``CAIMAN_JOINT_ZSTORE_MB`` choose the plan whatever the shape.) Without a
gradient (validation) the forward runs K2 and stores nothing.

What bounds the kernels on an H100: each is one to three GEMMs of
``2 N Hj K`` operations with an elementwise prologue or epilogue, and the
slab moves ``N K`` to ``2 N K`` bytes, so all are operation-bound
(``chip_smoke.py`` computes both bounds). bf16 inputs (the train step's
compute dtype) run the products on the tensor cores: pass A and pass B,
under every backward, as ``wgmma`` fed by TMA or ``cp.async``
(``csrc/joint_bwd.cuh``'s ``passa`` and ``passb`` on
``csrc/joint_sm90.cuh``; :func:`pass_a_plan` and :func:`pass_b_plan` say how
they stage a call's operands), and the forward and the derivation as one
``wgmma`` product over Hj (``csrc/joint_prod_sm90.cuh``): the forward in
clusters of 8 blocks that share 128 rows, the int8 slab's row maxima met
through distributed shared memory so the product is done once
(:func:`fwd_plan`), the derivation on a persistent grid
(:func:`derive_plan`). fp32 inputs run them on the CUDA cores, so that fp32
stays fp32 (``csrc/joint_tile.cuh``). All accumulate in fp32.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch

from caiman_asr_tpu_torch.ops.cuda_build import (
    DTYPE_CODE, I, P, check, check_operands, counted, load, stream_of,
)

# ------------------------------------------------------------- store policy
# The JAX package's knobs, read from the same environment variables with the
# same defaults (pallas_joint.py:599-720). The budgets were sized for a 16 GB
# TPU; they are kept so that a shape takes the same route in both packages.
_ZSTORE_MB_ENV = os.environ.get("CAIMAN_JOINT_ZSTORE_MB")
Z_STORE_LIMIT_BYTES = int(_ZSTORE_MB_ENV) << 20 if _ZSTORE_MB_ENV is not None else None
_ZSTORE_DTYPE = os.environ.get("CAIMAN_JOINT_ZSTORE_DTYPE", "auto")  # auto | bf16 | i8 | off
Z_STORE_PARTIAL = os.environ.get("CAIMAN_JOINT_ZSTORE_PARTIAL", "0") == "1"
RECHUNK_LIMIT_BYTES = int(os.environ.get("CAIMAN_JOINT_RECHUNK_MB", 512)) << 20
_FUSED_ENV = os.environ.get("CAIMAN_JOINT_FUSED_BWD", "auto")
FUSED_BWD = _FUSED_ENV if _FUSED_ENV == "auto" else _FUSED_ENV == "1"  # "auto" | True | False
_FUSED_VMEM_LIMIT = int(os.environ.get("CAIMAN_JOINT_FUSED_VMEM_MB", 118)) << 20

# The fp32 u workspace of the no-slab backward (``joint_bwd_fused``): a fixed
# size that does not grow with N.
FUSED_WS_BYTES = 1 << 30
_WS_ROW_ALIGN = 128  # the kernels' row tile


def _tiles(Hj: int) -> Tuple[int, int, int, int, int, int]:
    """The JAX package's tile sizes (TP_fwd, KT_fwd, TP_a, KT_a, TP_b, KT_b),
    ``pallas_joint.py:552-574``. Here they set the padding arithmetic of the
    store policy and KT_fwd, the width of an int8 scale tile."""
    tp_fwd = int(os.environ.get("CAIMAN_JOINT_TP_FWD", 0))
    if Hj >= 1024:
        return tp_fwd or 1024, 2048, 512, 1024, 1024, 1024
    return tp_fwd or 1024, 1024, 512, 1024, 512, 3072


def _zstore_limit(Kp: int, itemsize: int = 2) -> int:
    """The HBM budget for the slab (``pallas_joint.py:612-620``)."""
    if Z_STORE_LIMIT_BYTES is not None:
        return Z_STORE_LIMIT_BYTES
    if itemsize == 1:
        return (12288 << 20) if Kp <= 9216 else (7168 << 20)
    return (12288 << 20) if Kp <= 9216 else (5120 << 20)


def _store_cols(Np: int, Kp: int, kt: int, itemsize: int = 2) -> int:
    """Vocab columns (a multiple of kt, at most Kp) whose slab fits the
    budget at ``itemsize`` bytes (``pallas_joint.py:684-693``)."""
    cols = (_zstore_limit(Kp, itemsize) // max(Np * itemsize, 1)) // kt * kt
    cols = min(Kp, max(int(cols), 0))
    if cols < Kp and not Z_STORE_PARTIAL:
        return 0
    return cols


def _store_plan(Np: int, Kp: int, kt: int):
    """-> (cols, "bf16" | "i8" | None) (``pallas_joint.py:705-719``)."""
    if _ZSTORE_DTYPE == "off":
        return 0, None
    if _ZSTORE_DTYPE in ("auto", "bf16"):
        cols = _store_cols(Np, Kp, kt, 2)
        if cols > 0:
            return cols, "bf16"
        if _ZSTORE_DTYPE == "bf16":
            return 0, None
    cols = _store_cols(Np, Kp, kt, 1)
    if cols == Kp:  # the int8 slab is all or nothing
        return cols, "i8"
    return 0, None


def _use_fused(stored: bool, i8: bool = False) -> bool:
    """Whether the one-call fused backward handles the chunk
    (``pallas_joint.py:671-680``): by default when there is no slab or the
    slab is int8."""
    if FUSED_BWD == "auto":
        return (not stored) or i8
    return bool(FUSED_BWD)


def _fused_bwd_fits(Hj: int, Kp: int, tp: int, kt: int) -> bool:
    """The TPU kernel's condition for its fused backward: the full-width fp32
    dW accumulator plus the streamed blocks fit its VMEM budget
    (``pallas_joint.py:1061-1071``). Kept so that the routes agree; the
    Hopper kernels have no such limit."""
    need = (Hj * Kp * 4 + Kp * 4 + tp * Hj * 4
            + 2 * (tp * Hj * 2 + Hj * kt * 2 + tp * kt * 2
                   + tp * Hj * 4 + Hj * kt * 4 + kt * 4))
    return need <= _FUSED_VMEM_LIMIT - (2 << 20)


def _pad(n: int, tile: int) -> int:
    return -(-n // tile) * tile


# The branches of the backward, named by their kernels. A plan's route is one
# of these for the columns the slab holds (all of them when nothing is
# stored), plus K4 over the rest when the slab is partial (the hybrid split).
R_K5, R_K5_FUSED = "K5-A + K5-B", "K5-fused-u"
R_K7_FUSED, R_K7 = "K7-fused-u8", "K7-A8 + K7-B8"
R_K6_FUSED, R_RECHUNK, R_K4 = "K6-fused", "K6-derive-a + K5-B", "K4-A + K4-B"


def _backward_route(Hj: int, K: int, Kp: int, cols: int, dtype: Optional[str]) -> str:
    """The branch of ``_vjp_bwd`` (``pallas_joint.py:1230-1343``) a forward
    that stored ``cols`` columns as ``dtype`` leads to, for those columns
    (for all of them when nothing is stored)."""
    _, kt_f, tp_a, kt_a, _, _ = _tiles(Hj)
    if dtype is None:
        if _use_fused(stored=False) and _fused_bwd_fits(Hj, _pad(K, kt_a), tp_a, kt_a):
            return R_K6_FUSED
        return R_RECHUNK if RECHUNK_LIMIT_BYTES > 0 else R_K4
    width = Kp if cols >= K else cols  # of the slab as the JAX package pads it
    if dtype == "i8":
        tp_u8 = int(os.environ.get("CAIMAN_JOINT_U8_TP", tp_a))
        fused = _use_fused(stored=True, i8=True) and _fused_bwd_fits(Hj, width, tp_u8, kt_f)
        return R_K7_FUSED if fused else R_K7
    fused = _use_fused(stored=True) and _fused_bwd_fits(Hj, width, tp_a, kt_a)
    return R_K5_FUSED if fused else R_K5


def store_plan(N: int, Hj: int, K: int) -> dict:
    """The route of an [N, Hj] x [Hj, K] joint under a gradient: the padded
    sizes the JAX package decides from, the slab it stores (``cols`` columns
    as ``dtype``; ``ks = min(cols, K)`` of the K classes), the bytes of the
    slab the port stores (unpadded; the int8 slab with its scales), the
    width ``kt`` of an int8 scale tile, the backward's ``route`` over the
    stored columns and ``backward``, the whole backward named by its
    kernels."""
    tp, kt = _tiles(Hj)[:2]
    Np, Kp = _pad(N, tp), _pad(K, kt)
    cols, dtype = _store_plan(Np, Kp, kt)
    ks = min(cols, K)
    nbytes = {"bf16": N * ks * 2, "i8": N * K + (Kp // kt) * N * 4, None: 0}[dtype]
    route = _backward_route(Hj, K, Kp, cols, dtype)
    backward = route if ks in (0, K) else (
        f"{route} over [0, {ks}) and {R_K4} over [{ks}, {K}) (the hybrid split)")
    return {"Np": Np, "Kp": Kp, "kt": kt, "cols": cols, "dtype": dtype, "ks": ks,
            "slab_bytes": nbytes, "route": route, "backward": backward}


def rechunk_rows(N: int, Hj: int, K: int) -> int:
    """Rows per chunk of the rechunked backward: as few chunks as keep one
    chunk's bf16 ``[Nc, K]`` tile within ``RECHUNK_LIMIT_BYTES``, from the
    padded sizes as ``pallas_joint.py:1362-1368`` (so that the knob means
    what it means there)."""
    _, _, tp_a, kt_a, tp_b, _ = _tiles(Hj)
    tpm = max(tp_a, tp_b)
    Np, Kp = _pad(N, tpm), _pad(K, kt_a)
    n_chunks = max(1, -(-(Np * Kp * 2) // RECHUNK_LIMIT_BYTES))
    return _pad(-(-Np // n_chunks), tpm)


# ------------------------------------------------------------ plain versions
_PLAIN_ROWS = 16384  # the plain versions walk the rows in chunks: no fp32 [N, K] array


def _exp_logits(h, wt, b):
    return torch.exp(h.float() @ wt.float().t() + b.float())


def _row_chunks(N: int):
    return [(r, min(N, r + _PLAIN_ROWS)) for r in range(0, N, _PLAIN_ROWS)]


def joint_fwd_plain(h, wt, b):
    """K2's contract in plain PyTorch. h: [N, Hj] and wt: [K, Hj] in the
    compute dtype (the products accumulate in fp32, exact for bf16 inputs);
    b: [K] fp32. Returns (sums [N] fp32, None)."""
    sums = [_exp_logits(h[lo:hi], wt, b).sum(1) for lo, hi in _row_chunks(h.shape[0])]
    return (torch.cat(sums) if sums else h.new_zeros((0,), dtype=torch.float32)), None


def joint_fwd_store_plain(h, wt, b):
    """K5-store's contract: (sums [N] fp32, u [N, K] bf16)."""
    N, K = h.shape[0], wt.shape[0]
    sums = torch.empty((N,), dtype=torch.float32, device=h.device)
    u = torch.empty((N, K), dtype=torch.bfloat16, device=h.device)
    for lo, hi in _row_chunks(N):
        e = _exp_logits(h[lo:hi], wt, b)
        sums[lo:hi] = e.sum(1)
        u[lo:hi] = e.to(torch.bfloat16)
    return sums, u


def joint_fwd_store8_plain(h, wt, b, kt: int):
    """K7-store8's contract: (sums [N] fp32, q [N, K] int8, s [ceil(K/kt), N]
    fp32). Per row and kt-wide vocab tile, m = max u, s = m / 127 and
    q = round_half_even(u * (127 / m)), 0 where m == 0; the sums use the
    unquantised u (``pallas_joint.py:131-137``)."""
    N, K = h.shape[0], wt.shape[0]
    n_kt = -(-K // kt)
    sums = torch.empty((N,), dtype=torch.float32, device=h.device)
    q = torch.empty((N, K), dtype=torch.int8, device=h.device)
    s = torch.empty((n_kt, N), dtype=torch.float32, device=h.device)
    for lo, hi in _row_chunks(N):
        u = _exp_logits(h[lo:hi], wt, b)
        sums[lo:hi] = u.sum(1)
        # a ragged last tile: u >= 0, so zero columns never raise a maximum
        tiles = torch.nn.functional.pad(u, (0, n_kt * kt - K)).reshape(hi - lo, n_kt, kt)
        m = tiles.amax(2)
        inv = torch.where(m > 0, 127.0 / m, torch.zeros_like(m))
        q[lo:hi] = torch.round(tiles * inv[:, :, None]).reshape(hi - lo, -1)[:, :K].to(torch.int8)
        s[:, lo:hi] = (m * (1.0 / 127.0)).t()
    return sums, q, s


def joint_bwd_dh_plain(u, w, cs):
    """K5-A's contract. u: [N, K] bf16; w: [Hj, K] in the compute dtype;
    cs: [N] fp32. Returns smear = -cs * (u @ w^T) [N, Hj] fp32."""
    return -cs[:, None] * (u.float() @ w.float().t())


def _dz(u, cs, cl, labels):
    """dz = -cs * u + onehot(labels) cl; a label outside u's columns (shifted
    to a column range that does not hold it) meets none."""
    dz = -cs[:, None] * u
    lab = labels.long()
    rows = torch.nonzero((lab >= 0) & (lab < dz.shape[1]))[:, 0]
    dz.index_put_((rows, lab[rows]), cl.float()[rows], accumulate=True)
    return dz


def joint_bwd_dw_plain(h, u, cs, cl, labels, out=None):
    """K5-B's contract. h: [N, Hj] in the compute dtype; u: [N, K] bf16; cs,
    cl: [N] fp32; labels: [N]. With dz = -cs * u + onehot(labels) cl,
    returns (dw = h^T round_to_h_dtype(dz) [Hj, K], db = sum_rows dz [K]),
    both fp32; with ``out=(dw, db)`` adds them to those in place (a caller
    walking the rows in chunks). The blank column's terms are the
    caller's."""
    dz = _dz(u.float(), cs, cl, labels)
    dw, db = h.float().t() @ dz.to(h.dtype).float(), dz.sum(0)
    if out is None:
        return dw, db
    out[0].add_(dw)
    out[1].add_(db)
    return out


def _passes_plain(cs, u_of, a=None, b=None):
    """Pass A and / or pass B over row chunks; ``u_of(lo, hi)`` gives the
    chunk's fp32 u. ``a = (w, round_a)`` asks for pass A, u rounded to
    ``round_a`` for the product; ``b = (h, cl, labels, K)`` for pass B. Returns
    (smear, dw, db), None for a pass left out."""
    N = cs.shape[0]
    new = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=cs.device)
    smear = dw = db = None
    if a is not None:
        w32, round_a = a[0].float(), a[1]
        smear = new(N, w32.shape[0])
    if b is not None:
        h, cl, labels, K = b
        dw, db = new(h.shape[1], K), new(K)
    for lo, hi in _row_chunks(N):
        u = u_of(lo, hi)
        if a is not None:
            smear[lo:hi] = -cs[lo:hi, None] * (u.to(round_a).float() @ w32.t())
        if b is not None:
            dz = _dz(u, cs[lo:hi], cl[lo:hi], labels[lo:hi])
            db += dz.sum(0)
            dw += h[lo:hi].float().t() @ dz.to(h.dtype).float()
    return smear, dw, db


def joint_bwd_fused_u_plain(h, u, w, cs, cl, labels):
    """K5-fused-u's contract: K5-A and K5-B behind one call. Returns
    (smear [N, Hj], dw [Hj, K], db [K]), fp32
    (``pallas_joint.py:258-311``). The blank column's terms are the
    caller's."""
    return _passes_plain(cs, lambda lo, hi: u[lo:hi].float(), (w, torch.bfloat16),
                         (h, cl, labels, w.shape[1]))


def _dequantised(q, s, kt: int):
    K = q.shape[1]

    def u_of(lo, hi):
        scale = s[:, lo:hi].t().repeat_interleave(kt, dim=1)[:, :K]
        return q[lo:hi].float() * scale

    return u_of


def joint_bwd_fused_u8_plain(h, q, s, w, cs, cl, labels, kt: int):
    """K7-fused-u8's contract. h: [N, Hj] and w: [Hj, K] in the compute
    dtype; q: [N, K] int8 and s: [ceil(K/kt), N] fp32 as K7-store8 writes
    them; cs, cl: [N] fp32; labels: [N]. With uf = q * s:
    smear = -cs * (bf16(uf) @ w^T), dz = -cs * uf + onehot(labels) cl,
    dw = h^T round_to_h_dtype(dz), db = sum_rows dz
    (``pallas_joint.py:314-366``). Returns (smear [N, Hj], dw [Hj, K],
    db [K]), fp32. The blank column's terms are the caller's."""
    return _passes_plain(cs, _dequantised(q, s, kt), (w, torch.bfloat16),
                         (h, cl, labels, w.shape[1]))


def joint_bwd_dh_u8_plain(q, s, w, cs, kt: int):
    """K7-A8's contract: the smear of :func:`joint_bwd_fused_u8_plain` alone,
    the dequantised u rounded to bf16 whatever the weight dtype
    (``pallas_joint.py:388-405``)."""
    return _passes_plain(cs, _dequantised(q, s, kt), a=(w, torch.bfloat16))[0]


def joint_bwd_dw_u8_plain(h, q, s, cs, cl, labels, kt: int):
    """K7-B8's contract: (dw, db) of :func:`joint_bwd_fused_u8_plain` alone
    (``pallas_joint.py:459-499``)."""
    return _passes_plain(cs, _dequantised(q, s, kt), b=(h, cl, labels, q.shape[1]))[1:]


def joint_bwd_fused_plain(h, w, b, cs, cl, labels):
    """K6-fused's contract: no slab. With u = exp(h w + b) in fp32:
    smear = -cs * (round_to_w_dtype(u) @ w^T), dz from the fp32 u, then
    dw = h^T round_to_h_dtype(dz), db = sum_rows dz
    (``pallas_joint.py:190-255``). Returns (smear, dw, db), fp32. The blank
    column's terms are the caller's."""
    wt = w.t()
    return _passes_plain(cs, lambda lo, hi: _exp_logits(h[lo:hi], wt, b), (w, w.dtype),
                         (h, cl, labels, w.shape[1]))


def joint_derive_a_plain(h, w, b, cs):
    """K6-derive-a's contract, for a chunk of rows. With u = exp(h w + b) in
    fp32: (u as bf16 [N, K], smear = -cs * (round_to_w_dtype(u) @ w^T)
    [N, Hj] fp32), the rounding for the smear taken from the fp32 u, not
    from the bf16 tile (``pallas_joint.py:165-187``)."""
    u16 = torch.empty((h.shape[0], w.shape[1]), dtype=torch.bfloat16, device=h.device)
    wt = w.t()

    def u_of(lo, hi):
        u = _exp_logits(h[lo:hi], wt, b)
        u16[lo:hi] = u.to(torch.bfloat16)
        return u

    return u16, _passes_plain(cs, u_of, a=(w, w.dtype))[0]


def _column_range(w, b, lo: int, hi: Optional[int]):
    """(w[:, lo:hi] contiguous, b[lo:hi]) of a column range within [0, K]."""
    hi = w.shape[1] if hi is None else hi
    if not 0 <= lo <= hi <= w.shape[1]:
        raise ValueError(f"column range [{lo}, {hi}) outside [0, {w.shape[1]})")
    return w[:, lo:hi].contiguous(), b[lo:hi]


def _softmax_of(h, wc, bc, denom):
    return lambda lo, hi: torch.exp(h[lo:hi].float() @ wc.float() + bc.float()
                                    - denom[lo:hi, None])


def joint_bwd_dh_recompute_plain(h, w, b, denom, c, lo: int = 0, hi: Optional[int] = None):
    """K4-A's contract, over the vocab columns [lo, hi) of w: [Hj, K] and b:
    [K]. denom: [N] fp32, the row's log-sum-exp over all K; c: [N] fp32, the
    unscaled cb + cl. With p = exp(h w + b - denom) in fp32:
    smear = -c * (round_to_w_dtype(p) @ w^T) [N, Hj] fp32, this range's part
    (``pallas_joint.py:144-162``)."""
    wc, bc = _column_range(w, b, lo, hi)
    return _passes_plain(c, _softmax_of(h, wc, bc, denom), a=(wc, w.dtype))[0]


def joint_bwd_dw_recompute_plain(h, w, b, denom, c, cl, labels, lo: int = 0,
                                 hi: Optional[int] = None):
    """K4-B's contract, over the vocab columns [lo, hi). As K4-A, with cl:
    [N] fp32 and labels: [N] relative to ``lo`` (one outside [0, hi - lo)
    meets no column): dz = -c * p + onehot(labels) cl,
    (dw = h^T round_to_h_dtype(dz) [Hj, hi - lo], db = sum_rows dz [hi - lo]),
    fp32 (``pallas_joint.py:502-545``). The blank column's terms are the
    caller's."""
    wc, bc = _column_range(w, b, lo, hi)
    return _passes_plain(c, _softmax_of(h, wc, bc, denom), b=(h, cl, labels, wc.shape[1]))[1:]


# ------------------------------------------------------------------ kernels
@functools.cache
def _fwd_lib():
    return load("joint_fwd", {"joint_fwd": ([P] * 5 + [I] * 4 + [P], I),
                              "joint_fwd_store8": ([P] * 6 + [I] * 5 + [P], I),
                              "joint_fwd_plan": ([P] * 2 + [I] * 4 + [P], I)})


@functools.cache
def _bwd_lib():
    return load("joint_bwd", {
        "joint_bwd_dh": ([P] * 4 + [I] * 4 + [P], I),
        "joint_bwd_dw": ([P] * 7 + [I] * 5 + [P], I),
        "joint_bwd_dh_u8": ([P] * 5 + [I] * 5 + [P], I),
        "joint_bwd_dw_u8": ([P] * 8 + [I] * 5 + [P], I),
        "joint_bwd_dw_plan": ([P] * 2 + [I] * 4 + [P], I),
        "joint_bwd_dh_plan": ([P] * 2 + [I] * 4 + [P], I),
    })


@functools.cache
def _fused_lib():
    return load("joint_bwd_fused", {
        "joint_bwd_fused_u": ([P] * 9 + [I] * 4 + [P], I),
        "joint_bwd_fused_u8": ([P] * 10 + [I] * 5 + [P], I),
        "joint_bwd_fused": ([P] * 8 + [I] + [P] * 3 + [I] * 4 + [P], I),
    })


@functools.cache
def _recompute_lib():
    return load("joint_bwd_recompute", {
        "joint_derive_a": ([P] * 7 + [I] + [P] + [I] * 4 + [P], I),
        "joint_bwd_dh_recompute": ([P] * 7 + [I] + [P] + [I] * 4 + [P], I),
        "joint_bwd_dw_recompute": ([P] * 8 + [I] + [P] * 2 + [I] * 4 + [P], I),
        "joint_derive": ([P] * 6 + [I] * 4 + [P], I),
        "joint_derive_plan": ([P] * 2 + [I] * 3 + [P], I),
    })


def _dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODE[t.dtype]


# The scale tiles the forward kernels take: multiples of 128 that divide
# 2,048, the vocabulary a cluster of the bf16 forward walks per round (the
# plain version takes any width).
FWD_SCALE_TILES = (128, 256, 512, 1024, 2048)


def _fwd_scale_tile(kt: int, what: str) -> None:
    if kt not in FWD_SCALE_TILES:
        raise ValueError(f"{what}: the scale tile must be one of {FWD_SCALE_TILES}, got {kt}")


def _launch_fwd(h, wt, b, store: Optional[str], kt: int = 0):
    what = {None: "joint_fwd", "bf16": "joint_fwd_store", "i8": "joint_fwd_store8"}[store]
    N, Hj = h.shape
    K = wt.shape[0]
    code = _dtype_code(h, what)
    check_operands(h, {"h": (h, (N, Hj), h.dtype), "wt": (wt, (K, Hj), h.dtype),
                       "b": (b, (K,), torch.float32)}, what)
    sums = torch.empty((N,), dtype=torch.float32, device=h.device)
    if store == "i8":
        _fwd_scale_tile(kt, what)
        q = torch.empty((N, K), dtype=torch.int8, device=h.device)
        s = torch.empty((-(-K // kt), N), dtype=torch.float32, device=h.device)
        check(_fwd_lib().joint_fwd_store8(
            h.data_ptr(), wt.data_ptr(), b.data_ptr(), sums.data_ptr(), q.data_ptr(),
            s.data_ptr(), N, Hj, K, kt, code, stream_of(h)), what)
        return sums, q, s
    u = torch.empty((N, K), dtype=torch.bfloat16, device=h.device) if store else None
    check(_fwd_lib().joint_fwd(
        h.data_ptr(), wt.data_ptr(), b.data_ptr(), sums.data_ptr(),
        u.data_ptr() if store else None, N, Hj, K, code, stream_of(h)), what)
    return sums, u


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


@counted
def joint_fwd(h, wt, b):
    """K2: (sums, None); same contract as :func:`joint_fwd_plain`. One
    launch, counted in ``joint_fwd.launches``."""
    if not _on_cuda(h):
        return joint_fwd_plain(h, wt, b)
    out = _launch_fwd(h, wt, b, None)
    joint_fwd.launches += 1
    return out


@counted
def joint_fwd_store(h, wt, b):
    """K5-store: (sums, u); same contract as :func:`joint_fwd_store_plain`.
    One launch, counted in ``joint_fwd_store.launches``."""
    if not _on_cuda(h):
        return joint_fwd_store_plain(h, wt, b)
    out = _launch_fwd(h, wt, b, "bf16")
    joint_fwd_store.launches += 1
    return out


@counted
def joint_fwd_store8(h, wt, b, kt: int):
    """K7-store8: (sums, q, s); same contract as
    :func:`joint_fwd_store8_plain`. One launch, counted in
    ``joint_fwd_store8.launches``."""
    if not _on_cuda(h):
        return joint_fwd_store8_plain(h, wt, b, kt)
    out = _launch_fwd(h, wt, b, "i8", kt)
    joint_fwd_store8.launches += 1
    return out


@counted
def joint_bwd_dh(u, w, cs):
    """K5-A: the dh smear; same contract as :func:`joint_bwd_dh_plain`. One
    launch, counted in ``joint_bwd_dh.launches``."""
    if not _on_cuda(u):
        return joint_bwd_dh_plain(u, w, cs)
    what = "joint_bwd_dh"
    N, K = u.shape
    Hj = w.shape[0]
    code = _dtype_code(w, what)
    check_operands(u, {"u": (u, (N, K), torch.bfloat16), "w": (w, (Hj, K), w.dtype),
                       "cs": (cs, (N,), torch.float32)}, what)
    smear = torch.empty((N, Hj), dtype=torch.float32, device=u.device)
    check(_bwd_lib().joint_bwd_dh(u.data_ptr(), w.data_ptr(), cs.data_ptr(),
                                  smear.data_ptr(), N, Hj, K, code, stream_of(u)), what)
    joint_bwd_dh.launches += 1
    return smear


@counted
def joint_bwd_dw(h, u, cs, cl, labels, out=None):
    """K5-B: (dw, db); same contract as :func:`joint_bwd_dw_plain`. One
    launch, counted in ``joint_bwd_dw.launches``."""
    if not _on_cuda(h):
        return joint_bwd_dw_plain(h, u, cs, cl, labels, out)
    what = "joint_bwd_dw"
    N, Hj = h.shape
    K = u.shape[1]
    code = _dtype_code(h, what)
    check_operands(h, {**_row_operands(h, cs, cl, labels), "u": (u, (N, K), torch.bfloat16)},
                   what)
    if out is None:
        dw = torch.empty((Hj, K), dtype=torch.float32, device=h.device)
        db = torch.empty((K,), dtype=torch.float32, device=h.device)
    else:
        dw, db = out
        check_operands(h, {"dw": (dw, (Hj, K), torch.float32),
                           "db": (db, (K,), torch.float32)}, what)
    check(_bwd_lib().joint_bwd_dw(
        h.data_ptr(), u.data_ptr(), cs.data_ptr(), cl.data_ptr(), labels.data_ptr(),
        dw.data_ptr(), db.data_ptr(), N, Hj, K, int(out is not None), code, stream_of(h)), what)
    joint_bwd_dw.launches += 1
    return dw, db


# the staging codes of joint_sm90.cuh's ``Staging``
_STAGING = {0: "TMA", 8: "cp.async, 8 bytes", 4: "cp.async, 4 bytes", 2: "element copies",
            1: "element copies"}


def pass_b_plan(h, u) -> dict:
    """How the bf16 pass B kernel (every backward's pass B with bf16 h)
    stages ``h`` [N, Hj] and ``u`` [N, K] (the bf16 slab, the int8 slab or
    an fp32 workspace) and tiles the output, as the C side decides it from
    their addresses and widths: TMA where a base and its row stride are
    16-byte aligned, else ``cp.async``, else element copies. CUDA tensors."""
    N, Hj = h.shape
    K = u.shape[1]
    out = (I * 6)()
    check(_bwd_lib().joint_bwd_dw_plan(h.data_ptr(), u.data_ptr(), N, Hj, K,
                                       u.element_size(), out), "joint_bwd_dw_plan")
    tiles = out[2] * out[3]
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    return {"h": _STAGING[out[0]], "u": _STAGING[out[1]], "tile": "128 Hj x 128 K x 64 rows",
            "grid": (out[2], out[3]), "blocks": tiles, "waves": tiles / sms,
            "stages": out[4], "smem_bytes": out[5]}


def pass_a_plan(u, w) -> dict:
    """How the bf16 pass A kernel (every backward's pass A with bf16 w)
    stages ``u`` [N, K] (the bf16 slab, the int8 slab or an fp32 workspace)
    and ``w`` [Hj, K] and tiles the output, as the C side decides it from
    their addresses and widths (as :func:`pass_b_plan`). The grid walks the
    Hj tiles of a row tile side by side, so that they read its u together.
    CUDA tensors."""
    N, K = u.shape
    Hj = w.shape[0]
    out = (I * 6)()
    check(_bwd_lib().joint_bwd_dh_plan(u.data_ptr(), w.data_ptr(), N, Hj, K,
                                       u.element_size(), out), "joint_bwd_dh_plan")
    blocks = out[2] * out[3]
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    return {"u": _STAGING[out[0]], "w": _STAGING[out[1]], "tile": "128 rows x 256 Hj x 64 K",
            "grid": (out[2], out[3]), "blocks": blocks, "waves": blocks / sms,
            "stages": out[4], "smem_bytes": out[5]}


def fwd_plan(h, wt, kt: Optional[int] = None) -> dict:
    """How the bf16 forward kernel (K2, K5-store; K7-store8 with a scale
    tile ``kt``) stages ``h`` [N, Hj] and ``wt`` [K, Hj] and tiles the call,
    as the C side decides it from their addresses and widths (as
    :func:`pass_b_plan`): clusters of 8 blocks over 128 rows each, walking
    the vocabulary in rounds of 2,048 columns; ``clusters_resident`` is the
    occupancy calculator's count of clusters that stand at once on this
    card, ``waves`` the row tiles over it. A ``kt`` the kernel does not take
    raises ``ValueError``. CUDA tensors."""
    N, Hj = h.shape
    K = wt.shape[0]
    if kt is not None:
        _fwd_scale_tile(kt, "fwd_plan")
    out = (I * 8)()
    check(_fwd_lib().joint_fwd_plan(h.data_ptr(), wt.data_ptr(), N, Hj, K,
                                    0 if kt is None else 2, out), "joint_fwd_plan")
    row_tiles = out[3] // out[2]
    return {"h": _STAGING[out[0]], "wt": _STAGING[out[1]],
            "tile": "128 rows x 256 K x 64 Hj", "cluster": out[2], "grid": out[3],
            "rounds": out[4], "idle_share": 1 - K / (out[4] * 2048),
            "clusters_resident": out[5],
            "waves": row_tiles / out[5] if out[5] else float("inf"),
            "stages": out[6], "smem_bytes": out[7]}


def derive_plan(h, wt) -> dict:
    """How the bf16 derivation (K6-fused, K6-derive-a, K4-A, K4-B and
    :func:`joint_derive`) stages ``h`` [N, Hj] and ``wt`` [K, Hj] and tiles
    the call: [128 x 256] tiles, the vocab tiles of a row tile adjacent, on a
    persistent grid of one block per SM. CUDA tensors."""
    N, Hj = h.shape
    K = wt.shape[0]
    out = (I * 7)()
    check(_recompute_lib().joint_derive_plan(h.data_ptr(), wt.data_ptr(), N, Hj, K, out),
          "joint_derive_plan")
    tiles = out[2] * out[3]
    return {"h": _STAGING[out[0]], "wt": _STAGING[out[1]],
            "tile": "128 rows x 256 K x 64 Hj", "tiles": (out[2], out[3]),
            "blocks": out[4], "waves": tiles / out[4], "stages": out[5],
            "smem_bytes": out[6]}


def _scale_tile(kt: int, what: str) -> None:
    if kt <= 0 or kt % 8:
        raise ValueError(f"{what}: the scale tile must be a multiple of 8 wide, got {kt}")


@counted
def joint_bwd_dh_u8(q, s, w, cs, kt: int):
    """K7-A8: the dh smear from the int8 slab; same contract as
    :func:`joint_bwd_dh_u8_plain`. One launch, counted in
    ``joint_bwd_dh_u8.launches``."""
    if not _on_cuda(q):
        return joint_bwd_dh_u8_plain(q, s, w, cs, kt)
    what = "joint_bwd_dh_u8"
    N, K = q.shape
    Hj = w.shape[0]
    code = _dtype_code(w, what)
    _scale_tile(kt, what)
    check_operands(q, {"q": (q, (N, K), torch.int8), "s": (s, (-(-K // kt), N), torch.float32),
                       "w": (w, (Hj, K), w.dtype), "cs": (cs, (N,), torch.float32)}, what)
    smear = torch.empty((N, Hj), dtype=torch.float32, device=q.device)
    check(_bwd_lib().joint_bwd_dh_u8(
        q.data_ptr(), s.data_ptr(), w.data_ptr(), cs.data_ptr(), smear.data_ptr(), N, Hj, K, kt,
        code, stream_of(q)), what)
    joint_bwd_dh_u8.launches += 1
    return smear


@counted
def joint_bwd_dw_u8(h, q, s, cs, cl, labels, kt: int):
    """K7-B8: (dw, db) from the int8 slab; same contract as
    :func:`joint_bwd_dw_u8_plain`. One launch, counted in
    ``joint_bwd_dw_u8.launches``."""
    if not _on_cuda(h):
        return joint_bwd_dw_u8_plain(h, q, s, cs, cl, labels, kt)
    what = "joint_bwd_dw_u8"
    N, Hj = h.shape
    K = q.shape[1]
    code = _dtype_code(h, what)
    _scale_tile(kt, what)
    check_operands(h, {**_row_operands(h, cs, cl, labels), "q": (q, (N, K), torch.int8),
                       "s": (s, (-(-K // kt), N), torch.float32)}, what)
    _, dw, db = _fused_outputs(h, K, smear=False)
    check(_bwd_lib().joint_bwd_dw_u8(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), cs.data_ptr(), cl.data_ptr(),
        labels.data_ptr(), dw.data_ptr(), db.data_ptr(), N, Hj, K, kt, code, stream_of(h)), what)
    joint_bwd_dw_u8.launches += 1
    return dw, db


def _fused_outputs(h, K: int, smear: bool = True):
    N, Hj = h.shape
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=h.device)
    return new(N, Hj) if smear else None, new(Hj, K), new(K)


def _row_operands(h, cs, cl, labels):
    N = h.shape[0]
    return {"h": (h, tuple(h.shape), h.dtype), "cs": (cs, (N,), torch.float32),
            "cl": (cl, (N,), torch.float32), "labels": (labels, (N,), torch.int32)}


@counted
def joint_bwd_fused_u(h, u, w, cs, cl, labels):
    """K5-fused-u: (smear, dw, db); same contract as
    :func:`joint_bwd_fused_u_plain`. Two launches (pass A, pass B), counted
    in ``joint_bwd_fused_u.launches``."""
    if not _on_cuda(h):
        return joint_bwd_fused_u_plain(h, u, w, cs, cl, labels)
    what = "joint_bwd_fused_u"
    N, Hj = h.shape
    K = w.shape[1]
    code = _dtype_code(h, what)
    check_operands(h, {**_row_operands(h, cs, cl, labels), "u": (u, (N, K), torch.bfloat16),
                       "w": (w, (Hj, K), h.dtype)}, what)
    smear, dw, db = _fused_outputs(h, K)
    check(_fused_lib().joint_bwd_fused_u(
        h.data_ptr(), u.data_ptr(), w.data_ptr(), cs.data_ptr(), cl.data_ptr(),
        labels.data_ptr(), smear.data_ptr(), dw.data_ptr(), db.data_ptr(), N, Hj, K, code,
        stream_of(h)), what)
    joint_bwd_fused_u.launches += 2
    return smear, dw, db


@counted
def joint_bwd_fused_u8(h, q, s, w, cs, cl, labels, kt: int):
    """K7-fused-u8: (smear, dw, db); same contract as
    :func:`joint_bwd_fused_u8_plain`. Two launches (pass A, pass B), counted
    in ``joint_bwd_fused_u8.launches``."""
    if not _on_cuda(h):
        return joint_bwd_fused_u8_plain(h, q, s, w, cs, cl, labels, kt)
    what = "joint_bwd_fused_u8"
    N, Hj = h.shape
    K = w.shape[1]
    code = _dtype_code(h, what)
    _scale_tile(kt, what)
    check_operands(h, {**_row_operands(h, cs, cl, labels), "q": (q, (N, K), torch.int8),
                       "s": (s, (-(-K // kt), N), torch.float32),
                       "w": (w, (Hj, K), h.dtype)}, what)
    smear, dw, db = _fused_outputs(h, K)
    check(_fused_lib().joint_bwd_fused_u8(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), w.data_ptr(), cs.data_ptr(), cl.data_ptr(),
        labels.data_ptr(), smear.data_ptr(), dw.data_ptr(), db.data_ptr(), N, Hj, K, kt, code,
        stream_of(h)), what)
    joint_bwd_fused_u8.launches += 2
    return smear, dw, db


def fused_workspace_rows(N: int, K: int) -> int:
    """Rows of the fp32 u workspace ``joint_bwd_fused`` walks N rows with: as
    many row tiles as fit ``FUSED_WS_BYTES``, and no more than N needs."""
    rows = FUSED_WS_BYTES // (4 * K) // _WS_ROW_ALIGN * _WS_ROW_ALIGN
    if rows <= 0:
        raise ValueError(f"one row tile of {K} classes does not fit the fused workspace")
    return min(rows, _pad(N, _WS_ROW_ALIGN))


@counted
def joint_bwd_fused(h, w, b, cs, cl, labels):
    """K6-fused: (smear, dw, db); same contract as
    :func:`joint_bwd_fused_plain`. No [N, K] array is allocated: u lives in
    an fp32 workspace of at most ``FUSED_WS_BYTES`` that the rows are walked
    through in chunks, three launches per chunk (derive, pass A, pass B),
    counted in ``joint_bwd_fused.launches``."""
    if not _on_cuda(h):
        return joint_bwd_fused_plain(h, w, b, cs, cl, labels)
    what = "joint_bwd_fused"
    N, Hj = h.shape
    K = w.shape[1]
    code = _dtype_code(h, what)
    check_operands(h, {**_row_operands(h, cs, cl, labels), "w": (w, (Hj, K), h.dtype),
                       "b": (b, (K,), torch.float32)}, what)
    smear, dw, db = _fused_outputs(h, K)
    if N == 0:
        return smear, dw.zero_(), db.zero_()
    wt = w.t().contiguous()  # [K, Hj]: the derivation's contraction is contiguous
    rows = fused_workspace_rows(N, K)
    ws = torch.empty((rows, K), dtype=torch.float32, device=h.device)
    check(_fused_lib().joint_bwd_fused(
        h.data_ptr(), wt.data_ptr(), w.data_ptr(), b.data_ptr(), cs.data_ptr(), cl.data_ptr(),
        labels.data_ptr(), ws.data_ptr(), rows, smear.data_ptr(), dw.data_ptr(), db.data_ptr(),
        N, Hj, K, code, stream_of(h)), what)
    joint_bwd_fused.launches += 3 * -(-N // rows)
    return smear, dw, db


def joint_derive_plain(h, wt, b, shift=None, out32: bool = True, out16: bool = False):
    """The derivation the no-slab backwards run per row chunk, alone:
    v = exp(h wt^T + b - shift) [N, K], computed in fp32 (shift [N] fp32 or
    None for 0), returned as (fp32 v or None, bf16 v or None) as asked."""
    if not (out32 or out16):
        raise ValueError("joint_derive: ask for the fp32 or the bf16 output")
    N, K = h.shape[0], wt.shape[0]
    v32 = torch.empty((N, K), dtype=torch.float32, device=h.device) if out32 else None
    v16 = torch.empty((N, K), dtype=torch.bfloat16, device=h.device) if out16 else None
    for lo, hi in _row_chunks(N):
        v = h[lo:hi].float() @ wt.float().t() + b.float()
        if shift is not None:
            v = v - shift[lo:hi, None]
        v = torch.exp(v)
        if out32:
            v32[lo:hi] = v
        if out16:
            v16[lo:hi] = v.to(torch.bfloat16)
    return v32, v16


@counted
def joint_derive(h, wt, b, shift=None, out32: bool = True, out16: bool = False):
    """The derivation alone (the first launch of each chunk of K6-fused,
    K6-derive-a, K4-A and K4-B); same contract as
    :func:`joint_derive_plain`. One launch, counted in
    ``joint_derive.launches``. For tests and timing: the routes reach the
    derivation through their own entry points."""
    if not _on_cuda(h):
        return joint_derive_plain(h, wt, b, shift, out32, out16)
    what = "joint_derive"
    if not (out32 or out16):
        raise ValueError(f"{what}: ask for the fp32 or the bf16 output")
    N, Hj = h.shape
    K = wt.shape[0]
    code = _dtype_code(h, what)
    named = {"h": (h, (N, Hj), h.dtype), "wt": (wt, (K, Hj), h.dtype),
             "b": (b, (K,), torch.float32)}
    if shift is not None:
        named["shift"] = (shift, (N,), torch.float32)
    check_operands(h, named, what)
    v32 = torch.empty((N, K), dtype=torch.float32, device=h.device) if out32 else None
    v16 = torch.empty((N, K), dtype=torch.bfloat16, device=h.device) if out16 else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    check(_recompute_lib().joint_derive(
        h.data_ptr(), wt.data_ptr(), b.data_ptr(), ptr(shift), ptr(v32), ptr(v16), N, Hj, K,
        code, stream_of(h)), what)
    joint_derive.launches += 1
    return v32, v16


@counted
def joint_derive_a(h, w, b, cs):
    """K6-derive-a: (u bf16 [N, K], smear); same contract as
    :func:`joint_derive_a_plain`, for one chunk of rows. With bf16 weights
    two launches (derive into the bf16 tile, pass A over it); with fp32
    weights pass A reads the fp32 u from a workspace of at most
    ``FUSED_WS_BYTES``, two launches per workspace of rows. Counted in
    ``joint_derive_a.launches``."""
    if not _on_cuda(h):
        return joint_derive_a_plain(h, w, b, cs)
    what = "joint_derive_a"
    N, Hj = h.shape
    K = w.shape[1]
    code = _dtype_code(h, what)
    check_operands(h, {"h": (h, (N, Hj), h.dtype), "w": (w, (Hj, K), h.dtype),
                       "b": (b, (K,), torch.float32), "cs": (cs, (N,), torch.float32)}, what)
    u = torch.empty((N, K), dtype=torch.bfloat16, device=h.device)
    smear = torch.empty((N, Hj), dtype=torch.float32, device=h.device)
    if N == 0:
        return u, smear
    wt = w.t().contiguous()  # [K, Hj]: the derivation's contraction is contiguous
    rows, ws = 0, None
    if h.dtype == torch.float32:
        rows = fused_workspace_rows(N, K)
        ws = torch.empty((rows, K), dtype=torch.float32, device=h.device)
    check(_recompute_lib().joint_derive_a(
        h.data_ptr(), wt.data_ptr(), w.data_ptr(), b.data_ptr(), cs.data_ptr(), u.data_ptr(),
        ws.data_ptr() if ws is not None else None, rows, smear.data_ptr(), N, Hj, K, code,
        stream_of(h)), what)
    joint_derive_a.launches += 2 * (-(-N // rows) if rows else 1)
    return u, smear


def _recompute_operands(h, w, b, denom, c, lo: int, hi: Optional[int], what: str):
    """Checks what K4-A and K4-B share; -> (wt [Kc, Hj], w [Hj, Kc], b [Kc]
    of the column range, contiguous, and the rows of the fp32 workspace)."""
    N, Hj = h.shape
    check_operands(h, {"h": (h, (N, Hj), h.dtype), "w": (w, (Hj, w.shape[1]), h.dtype),
                       "b": (b, (w.shape[1],), torch.float32),
                       "denom": (denom, (N,), torch.float32), "c": (c, (N,), torch.float32)},
                   what)
    wc, bc = _column_range(w, b, lo, hi)
    rows = fused_workspace_rows(N, wc.shape[1]) if N and wc.shape[1] else 0
    return wc.t().contiguous(), wc, bc, rows


@counted
def joint_bwd_dh_recompute(h, w, b, denom, c, lo: int = 0, hi: Optional[int] = None):
    """K4-A: the dh smear of the vocab columns [lo, hi), the softmax derived
    again; same contract as :func:`joint_bwd_dh_recompute_plain`. No [N, K]
    array: the rows are walked through an fp32 workspace of at most
    ``FUSED_WS_BYTES``, two launches per chunk (derive, pass A), counted in
    ``joint_bwd_dh_recompute.launches``."""
    if not _on_cuda(h):
        return joint_bwd_dh_recompute_plain(h, w, b, denom, c, lo, hi)
    what = "joint_bwd_dh_recompute"
    code = _dtype_code(h, what)
    wt, wc, bc, rows = _recompute_operands(h, w, b, denom, c, lo, hi, what)
    N, Hj = h.shape
    Kc = wc.shape[1]
    smear = torch.empty((N, Hj), dtype=torch.float32, device=h.device)
    if rows == 0:
        return smear.zero_()
    ws = torch.empty((rows, Kc), dtype=torch.float32, device=h.device)
    check(_recompute_lib().joint_bwd_dh_recompute(
        h.data_ptr(), wt.data_ptr(), wc.data_ptr(), bc.data_ptr(), denom.data_ptr(),
        c.data_ptr(), ws.data_ptr(), rows, smear.data_ptr(), N, Hj, Kc, code, stream_of(h)),
        what)
    joint_bwd_dh_recompute.launches += 2 * -(-N // rows)
    return smear


@counted
def joint_bwd_dw_recompute(h, w, b, denom, c, cl, labels, lo: int = 0,
                           hi: Optional[int] = None):
    """K4-B: (dw, db) of the vocab columns [lo, hi), the softmax derived
    again; same contract as :func:`joint_bwd_dw_recompute_plain`. As K4-A:
    two launches per chunk (derive, pass B adding into dw and db in place),
    counted in ``joint_bwd_dw_recompute.launches``."""
    if not _on_cuda(h):
        return joint_bwd_dw_recompute_plain(h, w, b, denom, c, cl, labels, lo, hi)
    what = "joint_bwd_dw_recompute"
    code = _dtype_code(h, what)
    wt, wc, bc, rows = _recompute_operands(h, w, b, denom, c, lo, hi, what)
    N, Hj = h.shape
    check_operands(h, {"cl": (cl, (N,), torch.float32),
                       "labels": (labels, (N,), torch.int32)}, what)
    Kc = wc.shape[1]
    _, dw, db = _fused_outputs(h, Kc, smear=False)
    if rows == 0:
        return dw.zero_(), db.zero_()
    ws = torch.empty((rows, Kc), dtype=torch.float32, device=h.device)
    check(_recompute_lib().joint_bwd_dw_recompute(
        h.data_ptr(), wt.data_ptr(), bc.data_ptr(), denom.data_ptr(), c.data_ptr(),
        cl.data_ptr(), labels.data_ptr(), ws.data_ptr(), rows, dw.data_ptr(), db.data_ptr(),
        N, Hj, Kc, code, stream_of(h)), what)
    joint_bwd_dw_recompute.launches += 2 * -(-N // rows)
    return dw, db


def joint_bwd_rechunked(h, w, b, cs, cl, labels):
    """The rechunked backward (``pallas_joint.py:1346-1392``): the rows in
    chunks of :func:`rechunk_rows`, per chunk K6-derive-a (the chunk's bf16
    u and its smear) and K5-B adding into dw and db. Only one chunk's
    ``[Nc, K]`` bf16 tile exists at a time. Returns (smear, dw, db) with the
    bf16 slab's roundings in dw and db and the fp32 u's in the smear."""
    N, Hj = h.shape
    K = w.shape[1]
    smear, dw, db = _fused_outputs(h, K)
    dw.zero_()
    db.zero_()
    rows = rechunk_rows(N, Hj, K)
    for lo in range(0, N, rows):
        hi = min(N, lo + rows)
        u, smear[lo:hi] = joint_derive_a(h[lo:hi], w, b, cs[lo:hi])
        joint_bwd_dw(h[lo:hi], u, cs[lo:hi], cl[lo:hi], labels[lo:hi], out=(dw, db))
        del u  # the next chunk's tile takes this one's memory
    return smear, dw, db


# ----------------------------------------------------------------- autograd
class FusedJointLSE(torch.autograd.Function):
    """(lp_blank, lp_label) from h [N, Hj], w [Hj, K], b [K], labels [N];
    differentiable in h, w, b (the custom VJP of ``pallas_joint.py:630-638``).
    ``plan``: None without a gradient, else what :func:`store_plan` says: the
    slab the forward stores (``dtype``, over the first ``ks`` columns) and
    the backward's ``route`` over them."""

    @staticmethod
    def forward(ctx, h, w, b, labels, blank_idx: int, plan):
        h = h.contiguous()
        wt = w.t().contiguous()  # [K, Hj]: the forward's contraction is contiguous
        b32 = b.float().contiguous()
        K = w.shape[1]
        store, ks = (plan["dtype"], plan["ks"]) if plan else (None, 0)
        # columns [0, ks) by the storing kernel, [ks, K) by K2, the sums added
        # (pallas_joint.py:797-831); rows of wt are columns of w
        if store == "bf16":
            sums, *slab = joint_fwd_store(h, wt[:ks], b32[:ks])
        elif store == "i8":
            sums, *slab = joint_fwd_store8(h, wt, b32, plan["kt"])
        else:
            sums, slab = None, []
        if ks < K:
            rest = joint_fwd(h, wt[ks:], b32[ks:])[0]
            sums = rest if sums is None else sums + rest
        denom = torch.log(sums)
        lab = labels.long()
        # label / blank logits by O(N Hj) gathered dots outside the kernel,
        # accumulated in fp32 (pallas_joint.py:819-831)
        z_lab = (h.float() * wt[lab].float()).sum(1) + b32[lab]
        z_blank = h.float() @ w[:, blank_idx].float() + b32[blank_idx]
        if plan:
            ctx.blank_idx, ctx.b_dtype, ctx.plan = blank_idx, b.dtype, plan
            ctx.save_for_backward(h, w, b32, labels, denom, *slab)
        return z_blank - denom, z_lab - denom

    @staticmethod
    def backward(ctx, cb, cl):
        h, w, b32, labels, denom, *slab = ctx.saved_tensors
        blank, plan = ctx.blank_idx, ctx.plan
        route, ks, K = plan["route"], plan["ks"], w.shape[1]
        cb, cl = cb.float().contiguous(), cl.float().contiguous()
        w = w.contiguous()
        lab32 = labels.to(torch.int32).contiguous()
        c = cb + cl
        # the softmax row scale exp(-d) folded into one coefficient per row
        cs = c * torch.exp(-denom)
        ws = w if ks == K else w[:, :ks].contiguous()  # the stored columns' weights
        if route == R_K5:
            smear = joint_bwd_dh(slab[0], ws, cs)
            dw, db = joint_bwd_dw(h, slab[0], cs, cl, lab32)
        elif route == R_K5_FUSED:
            smear, dw, db = joint_bwd_fused_u(h, slab[0], ws, cs, cl, lab32)
        elif route == R_K7_FUSED:
            smear, dw, db = joint_bwd_fused_u8(h, *slab, w, cs, cl, lab32, plan["kt"])
        elif route == R_K7:
            smear = joint_bwd_dh_u8(*slab, w, cs, plan["kt"])
            dw, db = joint_bwd_dw_u8(h, *slab, cs, cl, lab32, plan["kt"])
        elif route == R_K6_FUSED:
            smear, dw, db = joint_bwd_fused(h, w, b32, cs, cl, lab32)
        elif route == R_RECHUNK:
            smear, dw, db = joint_bwd_rechunked(h, w, b32, cs, cl, lab32)
        elif route == R_K4:
            smear = dw = db = None
        else:
            raise ValueError(f"unknown backward route {route!r}")
        if route == R_K4 or (plan["dtype"] is not None and ks < K):
            # the columns no slab holds (all of them on the recompute route):
            # the per-pass recompute, the labels relative to its first
            # column (pallas_joint.py:1322-1342)
            rest = joint_bwd_dh_recompute(h, w, b32, denom, c, ks, K)
            smear = rest if smear is None else smear.add_(rest)
            dw2, db2 = joint_bwd_dw_recompute(h, w, b32, denom, c, cl, lab32 - ks, ks, K)
            dw, db = (dw2, db2) if dw is None else (torch.cat([dw, dw2], 1),
                                                    torch.cat([db, db2]))
        # the blank one-hot, a single column (pallas_joint.py:441-451)
        dw[:, blank] += h.float().t() @ cb.to(h.dtype).float()
        db[blank] += cb.sum()
        lab = labels.long()
        dh = (smear + cb[:, None] * w[:, blank][None, :].float()
              + cl[:, None] * w.t()[lab].float()).to(h.dtype)
        return dh, dw.to(w.dtype), db.to(ctx.b_dtype), None, None, None


def fused_joint_lse(h, w, b, labels, blank_idx: int):
    """h: [N, Hj]; w: [Hj, K]; b: [K]; labels: [N] int.

    Returns (lp_blank [N], lp_label [N]), the log-softmax scores of the
    blank and of each row's label, fp32. Under a gradient the forward stores
    what :func:`store_plan` says (the bf16 slab over all or the first
    columns, the int8 slab or nothing) and the backward takes the route that
    follows from it.
    """
    plan = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w, b)):
        plan = store_plan(h.shape[0], h.shape[1], w.shape[1])
    return FusedJointLSE.apply(h, w, b, labels, blank_idx, plan)
