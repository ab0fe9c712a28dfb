"""Fused joint + log-sum-exp for the transducer loss: the hand-written Hopper
kernels, their plain PyTorch versions, their launch counts, the store policy
and the autograd Function around them.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_joint.py``
on the route the base-85M train step and validation take:

- K2 ``_fwd_kernel``: per row ``sum_k exp(h . w_k + b_k)`` (``joint_fwd``);
- K5-store ``_fwd_kernel_store``: the same, also writing ``u = exp(z)`` to a
  bf16 ``[N, K]`` slab (``joint_fwd_store``); one CUDA source with K2,
  ``csrc/joint_fwd.cu``, under a compile-time flag;
- K5-A ``_bwd_dh_kernel_u``: ``smear = -cs * (u @ W^T)`` (``joint_bwd_dh``);
- K5-B ``_bwd_dw_kernel_u``: ``dz = -cs * u + onehot(label) cl``,
  ``dW = h^T dz``, ``db = sum dz`` (``joint_bwd_dw``); K5-A and K5-B are in
  ``csrc/joint_bwd.cu``.

``fused_joint_lse`` keeps the contract and the layouts of
``pallas_joint.py:630-638``. As there, there is no max subtraction: a logit
above ~88 makes the denominator inf, the loss non-finite, and the train
step skips the batch. Under a gradient the forward stores the slab when the
store policy (ported with its constants, ``pallas_joint.py:552-720``) says
it fits; the routes for when it does not (K6, K7, the rechunked backward)
are not ported yet, and such a call raises. Without a gradient (validation)
the forward runs K2 and stores nothing.

What bounds the kernels on an H100: each is a GEMM of ``2 N Hj K``
operations with an elementwise prologue or epilogue, and the slab moves
``2 N K`` bytes, so all four are operation-bound (``chip_smoke.py``
computes both bounds). bf16 inputs (the train step's compute dtype) run the
products on the tensor cores with WMMA; fp32 inputs run them on the CUDA
cores, so that fp32 stays fp32 (``csrc/joint_tile.cuh``). Both accumulate
in fp32. The ``wgmma`` + TMA versions are a later change.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from caiman_asr_tpu_torch.ops.cuda_build import (
    DTYPE_CODE, I, P, check, check_operands, counted, load, stream_of,
)

# ------------------------------------------------------------- store policy
def _fwd_tiles(Hj: int) -> Tuple[int, int]:
    """The JAX package's forward tile sizes (rows, vocab columns), kept only
    for the padding arithmetic of the store policy (``pallas_joint.py:552``)."""
    return (1024, 2048) if Hj >= 1024 else (1024, 1024)


def _zstore_limit(Kp: int, itemsize: int = 2) -> int:
    """The HBM budget for the slab (``pallas_joint.py:612-620``)."""
    if itemsize == 1:
        return (12288 << 20) if Kp <= 9216 else (7168 << 20)
    return (12288 << 20) if Kp <= 9216 else (5120 << 20)


def _store_plan(Np: int, Kp: int):
    """-> (cols, "bf16" | "i8" | None): ``pallas_joint.py:684-719`` with its
    defaults (dtype policy "auto", no partial storage), where the slab is
    stored whole or not at all: Kp columns when the padded slab fits the
    budget at that item size."""
    for itemsize, dtype in ((2, "bf16"), (1, "i8")):
        if _zstore_limit(Kp, itemsize) // max(Np * itemsize, 1) >= Kp:
            return Kp, dtype
    return 0, None


def store_plan(N: int, Hj: int, K: int) -> dict:
    """The stored-slab decision for an [N, Hj] x [Hj, K] joint, with the
    padded sizes the JAX package computes it from and the bytes of the slab
    the port stores (unpadded, bf16)."""
    tp, kt = _fwd_tiles(Hj)
    Np = -(-N // tp) * tp
    Kp = -(-K // kt) * kt
    cols, dtype = _store_plan(Np, Kp)
    return {"Np": Np, "Kp": Kp, "cols": cols, "dtype": dtype,
            "slab_bytes": N * K * 2 if dtype == "bf16" else 0}


# ------------------------------------------------------------ plain versions
def _exp_logits(h, wt, b):
    return torch.exp(h.float() @ wt.float().t() + b.float())


def joint_fwd_plain(h, wt, b):
    """K2's contract in plain PyTorch. h: [N, Hj] and wt: [K, Hj] in the
    compute dtype (the products accumulate in fp32, exact for bf16 inputs);
    b: [K] fp32. Returns (sums [N] fp32, None)."""
    return _exp_logits(h, wt, b).sum(1), None


def joint_fwd_store_plain(h, wt, b):
    """K5-store's contract: (sums [N] fp32, u [N, K] bf16)."""
    u = _exp_logits(h, wt, b)
    return u.sum(1), u.to(torch.bfloat16)


def joint_bwd_dh_plain(u, w, cs):
    """K5-A's contract. u: [N, K] bf16; w: [Hj, K] in the compute dtype;
    cs: [N] fp32. Returns smear = -cs * (u @ w^T) [N, Hj] fp32."""
    return -cs[:, None] * (u.float() @ w.float().t())


def joint_bwd_dw_plain(h, u, cs, cl, labels):
    """K5-B's contract. h: [N, Hj] in the compute dtype; u: [N, K] bf16; cs,
    cl: [N] fp32; labels: [N]. With dz = -cs * u + onehot(labels) cl,
    returns (dw = h^T round_to_h_dtype(dz) [Hj, K], db = sum_rows dz [K]),
    both fp32. The blank column's terms are the caller's."""
    dz = -cs[:, None] * u.float()
    rows = torch.arange(dz.shape[0], device=dz.device)
    dz.index_put_((rows, labels.long()), cl.float(), accumulate=True)
    return h.float().t() @ dz.to(h.dtype).float(), dz.sum(0)


# ------------------------------------------------------------------ kernels
@functools.cache
def _fwd_lib():
    return load("joint_fwd", {"joint_fwd": ([P] * 5 + [I] * 4 + [P], I)})


@functools.cache
def _bwd_lib():
    return load("joint_bwd", {
        "joint_bwd_dh": ([P] * 4 + [I] * 4 + [P], I),
        "joint_bwd_dw": ([P] * 7 + [I] * 4 + [P], I),
    })


def _dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODE[t.dtype]


def _launch_fwd(h, wt, b, store_u: bool):
    what = "joint_fwd_store" if store_u else "joint_fwd"
    N, Hj = h.shape
    K = wt.shape[0]
    code = _dtype_code(h, what)
    check_operands(h, {"h": (h, (N, Hj), h.dtype), "wt": (wt, (K, Hj), h.dtype),
                       "b": (b, (K,), torch.float32)}, what)
    sums = torch.empty((N,), dtype=torch.float32, device=h.device)
    u = torch.empty((N, K), dtype=torch.bfloat16, device=h.device) if store_u else None
    check(_fwd_lib().joint_fwd(
        h.data_ptr(), wt.data_ptr(), b.data_ptr(), sums.data_ptr(),
        u.data_ptr() if store_u else None, N, Hj, K, code, stream_of(h)), what)
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
    out = _launch_fwd(h, wt, b, False)
    joint_fwd.launches += 1
    return out


@counted
def joint_fwd_store(h, wt, b):
    """K5-store: (sums, u); same contract as :func:`joint_fwd_store_plain`.
    One launch, counted in ``joint_fwd_store.launches``."""
    if not _on_cuda(h):
        return joint_fwd_store_plain(h, wt, b)
    out = _launch_fwd(h, wt, b, True)
    joint_fwd_store.launches += 1
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


# ----------------------------------------------------------------- autograd
class FusedJointLSE(torch.autograd.Function):
    """(lp_blank, lp_label) from h [N, Hj], w [Hj, K], b [K], labels [N];
    differentiable in h, w, b (the custom VJP of ``pallas_joint.py:630-638``,
    on its stored-slab, two-kernel backward route)."""

    @staticmethod
    def forward(ctx, h, w, b, labels, blank_idx: int, store: bool):
        wt = w.t().contiguous()  # [K, Hj]: the forward's contraction is contiguous
        b32 = b.float().contiguous()
        sums, u = (joint_fwd_store if store else joint_fwd)(h.contiguous(), wt, b32)
        denom = torch.log(sums)
        lab = labels.long()
        # label / blank logits by O(N Hj) gathered dots outside the kernel,
        # accumulated in fp32 (pallas_joint.py:819-831)
        z_lab = (h.float() * wt[lab].float()).sum(1) + b32[lab]
        z_blank = h.float() @ w[:, blank_idx].float() + b32[blank_idx]
        if store:
            ctx.blank_idx = blank_idx
            ctx.b_dtype = b.dtype
            ctx.save_for_backward(h, w, labels, denom, u)
        return z_blank - denom, z_lab - denom

    @staticmethod
    def backward(ctx, cb, cl):
        h, w, labels, denom, u = ctx.saved_tensors
        blank = ctx.blank_idx
        cb, cl = cb.float().contiguous(), cl.float().contiguous()
        h = h.contiguous()
        # the softmax row scale exp(-d) folded into one coefficient per row
        cs = (cb + cl) * torch.exp(-denom)
        smear = joint_bwd_dh(u, w.contiguous(), cs)
        dw, db = joint_bwd_dw(h, u, cs, cl, labels.to(torch.int32).contiguous())
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
    the bf16 slab for the backward and raises ``NotImplementedError`` when
    the store policy stores nothing (those routes are not ported yet).
    """
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (h, w, b))
    if grad:
        plan = store_plan(h.shape[0], h.shape[1], w.shape[1])
        if plan["dtype"] != "bf16":
            raise NotImplementedError(
                f"the joint's u slab does not fit the store budget ({plan}): the "
                "routes for that case (the no-slab fused backward K6, the int8 slab "
                "K7 and the rechunked backward, pallas_joint.py:1258-1281) are not "
                "ported yet")
    return FusedJointLSE.apply(h, w, b, labels, blank_idx, grad)
