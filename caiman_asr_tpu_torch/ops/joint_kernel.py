"""Fused joint + log-sum-exp for the transducer loss: the hand-written Hopper
kernels, their plain PyTorch versions, their launch counts, the store policy
and the autograd Function around them.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_joint.py``
on the routes its default policy takes for base-85M and large-196M:

- K2 ``_fwd_kernel``: per row ``sum_k exp(h . w_k + b_k)`` (``joint_fwd``);
- K5-store ``_fwd_kernel_store``: the same, also writing ``u = exp(z)`` to a
  bf16 ``[N, K]`` slab (``joint_fwd_store``);
- K7-store8 ``_fwd_kernel_store8``: the same, the slab as scaled int8 with
  one fp32 scale per row and vocab tile (``joint_fwd_store8``); one CUDA
  source with K2 and K5-store, ``csrc/joint_fwd.cu``, under a compile-time
  mode;
- K5-A ``_bwd_dh_kernel_u``: ``smear = -cs * (u @ W^T)`` (``joint_bwd_dh``);
- K5-B ``_bwd_dw_kernel_u``: ``dz = -cs * u + onehot(label) cl``,
  ``dW = h^T dz``, ``db = sum dz`` (``joint_bwd_dw``); both in
  ``csrc/joint_bwd.cu``;
- K7-fused-u8 ``_bwd_fused_kernel_u8``: both passes over the int8 slab in
  one call (``joint_bwd_fused_u8``);
- K6-fused ``_bwd_fused_kernel``: both passes with no slab, ``u`` derived
  again from h, w, b (``joint_bwd_fused``); both in
  ``csrc/joint_bwd_fused.cu``. The passes are templates shared by the three
  backward sources (``csrc/joint_bwd.cuh``).

``fused_joint_lse`` keeps the contract and the layouts of
``pallas_joint.py:630-638``. As there, there is no max subtraction: a logit
above ~88 makes the denominator inf, the loss non-finite, and the train
step skips the batch. Under a gradient the store policy (ported with its
constants and its ``CAIMAN_JOINT_*`` knobs, ``pallas_joint.py:552-720`` and
``:1061-1071``, so that the same shape takes the same route) picks the
forward, and the backward follows ``_vjp_bwd`` (``:1230-1343``) branch for
branch:

============================  =========  ==================================
plan                          forward    backward
============================  =========  ==================================
bf16 slab                     K5-store   K5-A + K5-B
int8 slab                     K7-store8  K7-fused-u8
nothing stored                K2         K6-fused
============================  =========  ==================================

The branches the knobs can also reach raise ``NotImplementedError`` naming
the kernel that is not ported yet: the fused stored-u backward (K5-fused-u,
``CAIMAN_JOINT_FUSED_BWD=1``), the two-kernel int8 backward (K7-A8, K7-B8,
``CAIMAN_JOINT_FUSED_BWD=0``), the rechunked backward (K6-derive-a, when the
fused one is off or does not fit), the per-pass recompute (K4-A, K4-B,
``CAIMAN_JOINT_RECHUNK_MB=0``) and the hybrid split
(``CAIMAN_JOINT_ZSTORE_PARTIAL=1``). Without a gradient (validation) the
forward runs K2 and stores nothing.

What bounds the kernels on an H100: each is one to three GEMMs of
``2 N Hj K`` operations with an elementwise prologue or epilogue, and the
slab moves ``N K`` to ``2 N K`` bytes, so all are operation-bound
(``chip_smoke.py`` computes both bounds). bf16 inputs (the train step's
compute dtype) run the products on the tensor cores with WMMA; fp32 inputs
run them on the CUDA cores, so that fp32 stays fp32 (``csrc/joint_tile.cuh``).
Both accumulate in fp32. The ``wgmma`` + TMA versions are a later change.

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


# backward routes: the ported ones, then the ones that raise
_PORTED = ("K5-A + K5-B", "K7-fused-u8", "K6-fused")


def _backward_route(Hj: int, K: int, Kp: int, cols: int, dtype: Optional[str]) -> str:
    """The branch of ``_vjp_bwd`` (``pallas_joint.py:1230-1343``) a forward
    that stored ``cols`` columns as ``dtype`` leads to, named by its kernels."""
    _, kt_f, tp_a, kt_a, _, _ = _tiles(Hj)
    if dtype is None:
        if _use_fused(stored=False) and _fused_bwd_fits(Hj, _pad(K, kt_a), tp_a, kt_a):
            return "K6-fused"
        if RECHUNK_LIMIT_BYTES > 0:
            return "K6-derive-a + K5-B (the rechunked backward)"
        return "K4-A + K4-B (the per-pass recompute)"
    if min(cols, K) < K:
        return "K4-A + K4-B beside the stored chunk (the hybrid split)"
    if dtype == "i8":
        tp_u8 = int(os.environ.get("CAIMAN_JOINT_U8_TP", tp_a))
        if _use_fused(stored=True, i8=True) and _fused_bwd_fits(Hj, Kp, tp_u8, kt_f):
            return "K7-fused-u8"
        return "K7-A8 + K7-B8 (the two-kernel int8 backward)"
    if _use_fused(stored=True) and _fused_bwd_fits(Hj, Kp, tp_a, kt_a):
        return "K5-fused-u (the fused stored-u backward)"
    return "K5-A + K5-B"


def store_plan(N: int, Hj: int, K: int) -> dict:
    """The route of an [N, Hj] x [Hj, K] joint under a gradient: the padded
    sizes the JAX package decides from, the slab it stores (``cols`` columns
    as ``dtype``), the bytes of the slab the port stores (unpadded; the int8
    slab with its scales), the width ``kt`` of an int8 scale tile and the
    backward's kernels."""
    tp, kt = _tiles(Hj)[:2]
    Np, Kp = _pad(N, tp), _pad(K, kt)
    cols, dtype = _store_plan(Np, Kp, kt)
    nbytes = {"bf16": N * K * 2, "i8": N * K + (Kp // kt) * N * 4, None: 0}[dtype]
    return {"Np": Np, "Kp": Kp, "kt": kt, "cols": cols, "dtype": dtype, "slab_bytes": nbytes,
            "backward": _backward_route(Hj, K, Kp, cols, dtype)}


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
    dz = -cs[:, None] * u
    rows = torch.arange(dz.shape[0], device=dz.device)
    dz.index_put_((rows, labels.long()), cl.float(), accumulate=True)
    return dz


def joint_bwd_dw_plain(h, u, cs, cl, labels):
    """K5-B's contract. h: [N, Hj] in the compute dtype; u: [N, K] bf16; cs,
    cl: [N] fp32; labels: [N]. With dz = -cs * u + onehot(labels) cl,
    returns (dw = h^T round_to_h_dtype(dz) [Hj, K], db = sum_rows dz [K]),
    both fp32. The blank column's terms are the caller's."""
    dz = _dz(u.float(), cs, cl, labels)
    return h.float().t() @ dz.to(h.dtype).float(), dz.sum(0)


def _fused_plain(h, w, cs, cl, labels, u_of, round_a):
    """Both passes over row chunks: ``u_of(lo, hi)`` gives the chunk's fp32 u,
    ``round_a`` the dtype pass A rounds it to."""
    N, Hj = h.shape
    K = w.shape[1]
    w32 = w.float()
    smear = torch.empty((N, Hj), dtype=torch.float32, device=h.device)
    dw = torch.zeros((Hj, K), dtype=torch.float32, device=h.device)
    db = torch.zeros((K,), dtype=torch.float32, device=h.device)
    for lo, hi in _row_chunks(N):
        u = u_of(lo, hi)
        smear[lo:hi] = -cs[lo:hi, None] * (u.to(round_a).float() @ w32.t())
        dz = _dz(u, cs[lo:hi], cl[lo:hi], labels[lo:hi])
        db += dz.sum(0)
        dw += h[lo:hi].float().t() @ dz.to(h.dtype).float()
    return smear, dw, db


def joint_bwd_fused_u8_plain(h, q, s, w, cs, cl, labels, kt: int):
    """K7-fused-u8's contract. h: [N, Hj] and w: [Hj, K] in the compute
    dtype; q: [N, K] int8 and s: [ceil(K/kt), N] fp32 as K7-store8 writes
    them; cs, cl: [N] fp32; labels: [N]. With uf = q * s:
    smear = -cs * (bf16(uf) @ w^T), dz = -cs * uf + onehot(labels) cl,
    dw = h^T round_to_h_dtype(dz), db = sum_rows dz
    (``pallas_joint.py:314-366``). Returns (smear [N, Hj], dw [Hj, K],
    db [K]), fp32. The blank column's terms are the caller's."""
    K = w.shape[1]

    def u_of(lo, hi):
        scale = s[:, lo:hi].t().repeat_interleave(kt, dim=1)[:, :K]
        return q[lo:hi].float() * scale

    return _fused_plain(h, w, cs, cl, labels, u_of, torch.bfloat16)


def joint_bwd_fused_plain(h, w, b, cs, cl, labels):
    """K6-fused's contract: no slab. With u = exp(h w + b) in fp32:
    smear = -cs * (round_to_w_dtype(u) @ w^T), dz from the fp32 u, then
    dw = h^T round_to_h_dtype(dz), db = sum_rows dz
    (``pallas_joint.py:190-255``). Returns (smear, dw, db), fp32. The blank
    column's terms are the caller's."""
    wt = w.t()
    return _fused_plain(h, w, cs, cl, labels, lambda lo, hi: _exp_logits(h[lo:hi], wt, b),
                        w.dtype)


# ------------------------------------------------------------------ kernels
@functools.cache
def _fwd_lib():
    return load("joint_fwd", {"joint_fwd": ([P] * 5 + [I] * 4 + [P], I),
                              "joint_fwd_store8": ([P] * 6 + [I] * 5 + [P], I)})


@functools.cache
def _bwd_lib():
    return load("joint_bwd", {
        "joint_bwd_dh": ([P] * 4 + [I] * 4 + [P], I),
        "joint_bwd_dw": ([P] * 7 + [I] * 4 + [P], I),
    })


@functools.cache
def _fused_lib():
    return load("joint_bwd_fused", {
        "joint_bwd_fused_u8": ([P] * 10 + [I] * 5 + [P], I),
        "joint_bwd_fused": ([P] * 8 + [I] + [P] * 3 + [I] * 4 + [P], I),
    })


def _dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODE[t.dtype]


def _launch_fwd(h, wt, b, store: Optional[str], kt: int = 0):
    what = {None: "joint_fwd", "bf16": "joint_fwd_store", "i8": "joint_fwd_store8"}[store]
    N, Hj = h.shape
    K = wt.shape[0]
    code = _dtype_code(h, what)
    check_operands(h, {"h": (h, (N, Hj), h.dtype), "wt": (wt, (K, Hj), h.dtype),
                       "b": (b, (K,), torch.float32)}, what)
    sums = torch.empty((N,), dtype=torch.float32, device=h.device)
    if store == "i8":
        if kt <= 0 or kt % 128:
            raise ValueError(f"{what}: the scale tile must be a multiple of 128 wide, got {kt}")
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
def joint_bwd_dw(h, u, cs, cl, labels):
    """K5-B: (dw, db); same contract as :func:`joint_bwd_dw_plain`. One
    launch, counted in ``joint_bwd_dw.launches``."""
    if not _on_cuda(h):
        return joint_bwd_dw_plain(h, u, cs, cl, labels)
    what = "joint_bwd_dw"
    N, Hj = h.shape
    K = u.shape[1]
    code = _dtype_code(h, what)
    check_operands(h, {"h": (h, (N, Hj), h.dtype), "u": (u, (N, K), torch.bfloat16),
                       "cs": (cs, (N,), torch.float32), "cl": (cl, (N,), torch.float32),
                       "labels": (labels, (N,), torch.int32)}, what)
    dw = torch.empty((Hj, K), dtype=torch.float32, device=h.device)
    db = torch.empty((K,), dtype=torch.float32, device=h.device)
    check(_bwd_lib().joint_bwd_dw(
        h.data_ptr(), u.data_ptr(), cs.data_ptr(), cl.data_ptr(), labels.data_ptr(),
        dw.data_ptr(), db.data_ptr(), N, Hj, K, code, stream_of(h)), what)
    joint_bwd_dw.launches += 1
    return dw, db


def _fused_outputs(h, K: int):
    N, Hj = h.shape
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=h.device)
    return new(N, Hj), new(Hj, K), new(K)


def _row_operands(h, cs, cl, labels):
    N = h.shape[0]
    return {"h": (h, tuple(h.shape), h.dtype), "cs": (cs, (N,), torch.float32),
            "cl": (cl, (N,), torch.float32), "labels": (labels, (N,), torch.int32)}


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
    if kt <= 0 or kt % 8:
        raise ValueError(f"{what}: the scale tile must be a multiple of 8 wide, got {kt}")
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


# ----------------------------------------------------------------- autograd
class FusedJointLSE(torch.autograd.Function):
    """(lp_blank, lp_label) from h [N, Hj], w [Hj, K], b [K], labels [N];
    differentiable in h, w, b (the custom VJP of ``pallas_joint.py:630-638``).
    ``store``: False without a gradient, else the slab the plan stores
    ("bf16", "i8" or None), which also fixes the backward: K5-A + K5-B,
    K7-fused-u8 or K6-fused."""

    @staticmethod
    def forward(ctx, h, w, b, labels, blank_idx: int, store, kt: int):
        h = h.contiguous()
        wt = w.t().contiguous()  # [K, Hj]: the forward's contraction is contiguous
        b32 = b.float().contiguous()
        if store == "bf16":
            sums, *slab = joint_fwd_store(h, wt, b32)
        elif store == "i8":
            sums, *slab = joint_fwd_store8(h, wt, b32, kt)
        else:
            sums, slab = joint_fwd(h, wt, b32)[0], []
        denom = torch.log(sums)
        lab = labels.long()
        # label / blank logits by O(N Hj) gathered dots outside the kernel,
        # accumulated in fp32 (pallas_joint.py:819-831)
        z_lab = (h.float() * wt[lab].float()).sum(1) + b32[lab]
        z_blank = h.float() @ w[:, blank_idx].float() + b32[blank_idx]
        if store is not False:
            ctx.blank_idx, ctx.b_dtype, ctx.store, ctx.kt = blank_idx, b.dtype, store, kt
            ctx.save_for_backward(h, w, b32, labels, denom, *slab)
        return z_blank - denom, z_lab - denom

    @staticmethod
    def backward(ctx, cb, cl):
        h, w, b32, labels, denom, *slab = ctx.saved_tensors
        blank = ctx.blank_idx
        cb, cl = cb.float().contiguous(), cl.float().contiguous()
        w = w.contiguous()
        lab32 = labels.to(torch.int32).contiguous()
        # the softmax row scale exp(-d) folded into one coefficient per row
        cs = (cb + cl) * torch.exp(-denom)
        if ctx.store == "bf16":
            smear = joint_bwd_dh(slab[0], w, cs)
            dw, db = joint_bwd_dw(h, slab[0], cs, cl, lab32)
        elif ctx.store == "i8":
            smear, dw, db = joint_bwd_fused_u8(h, *slab, w, cs, cl, lab32, ctx.kt)
        else:
            smear, dw, db = joint_bwd_fused(h, w, b32, cs, cl, lab32)
        # the blank one-hot, a single column (pallas_joint.py:441-451)
        dw[:, blank] += h.float().t() @ cb.to(h.dtype).float()
        db[blank] += cb.sum()
        lab = labels.long()
        dh = (smear + cb[:, None] * w[:, blank][None, :].float()
              + cl[:, None] * w.t()[lab].float()).to(h.dtype)
        return dh, dw.to(w.dtype), db.to(ctx.b_dtype), None, None, None, None


def fused_joint_lse(h, w, b, labels, blank_idx: int):
    """h: [N, Hj]; w: [Hj, K]; b: [K]; labels: [N] int.

    Returns (lp_blank [N], lp_label [N]), the log-softmax scores of the
    blank and of each row's label, fp32. Under a gradient the forward stores
    what :func:`store_plan` says (the bf16 slab, the int8 slab or nothing)
    and the backward takes the route that follows from it; a route whose
    kernel is not ported yet raises ``NotImplementedError`` before anything
    is computed.
    """
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (h, w, b))):
        return FusedJointLSE.apply(h, w, b, labels, blank_idx, False, 0)
    plan = store_plan(h.shape[0], h.shape[1], w.shape[1])
    if plan["backward"] not in _PORTED:
        raise NotImplementedError(
            f"the joint's backward route {plan['backward']} is not ported yet (the plan "
            f"for N={h.shape[0]}, Hj={h.shape[1]}, K={w.shape[1]} is {plan}); the ported "
            f"routes are {', '.join(_PORTED)}")
    return FusedJointLSE.apply(h, w, b, labels, blank_idx, plan["dtype"], plan["kt"])
