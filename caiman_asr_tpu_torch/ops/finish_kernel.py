"""The fused LAMB finish's three passes: the hand-written Hopper kernels,
their plain PyTorch versions and their launch counts.

There is no Pallas kernel to replace: the JAX package's
``caiman_asr_tpu/training/fused_finish.py:96`` (``fused_lamb_ema_update``)
writes the finish as three passes over the parameter trees and leaves each
to XLA's fusion. Here each pass is one launch over a table of leaves
(``csrc/lamb_finish.cu``):

- ``lamb_finish_norms`` (pass 0) reads the gradients: each leaf's sum of
  ``nan_to_num(g)^2`` and their sum over the leaves not sharded;
- ``lamb_finish_moments`` (pass 1) clips the gradients by the global norm,
  updates the Adam moments in place and returns each leaf's ``||p||^2`` and
  ``||u||^2`` (u: the LAMB direction);
- ``lamb_finish_apply`` (pass 2) writes the new parameters (a leaf with an
  overwrite source takes that value) and their EMA in place.

What bounds them on an H100: 52 bytes a parameter in fp32 (pass 0 reads 4,
pass 1 reads 16 and writes 8, pass 2 reads 16 and writes 8) against a few
dozen operations, so the bytes. ``training/fused_finish.py`` runs the
passes; the plain versions are the per-leaf PyTorch code of
``Lamb.update`` split at the same two points.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
The kernels take fp32 parameters, EMA, moments, gradients and overwrite
sources, each contiguous; anything else raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.ops.cuda_build import I, P, check, counted, load, stream_of

Grads = Sequence[Optional[torch.Tensor]]
F, D, LL = ctypes.c_float, ctypes.c_double, ctypes.c_longlong

SIGNATURES = {
    "lamb_finish_chunk": ([], LL),
    "lamb_finish_norms": ([P, P, I, I, LL, P, P, P, P, P], I),
    "lamb_finish_moments": ([P, P, I, I, LL, P, I] + [F] * 9 + [P, P, P, P], I),
    "lamb_finish_apply": ([P, P, I, LL, P, D] + [F] * 5 + [P], I),
}
# the elements a block takes (kChunk of the kernels)
CHUNK = 4096
# the kernels' leaf tables (Leaf and Dyn of csrc/lamb_finish.cu)
LEAF = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("e", "<u8"), ("n", "<i8"),
                 ("chunk0", "<i8"), ("factor", "<f8"), ("sharded", "<i8")])
DYN = np.dtype([("g", "<u8"), ("src", "<u8")])
LAYOUTS_KEPT = 8


@dataclass(frozen=True, eq=False)
class Leaves:
    """The finish's leaves in tree order: parameters, EMA, first and
    second moments (one tensor of a shape each), each leaf's lr factor and
    whether it is this rank's shard of a whole tensor (its norms are then
    all-reduced between the passes)."""

    p: Tuple[torch.Tensor, ...]
    e: Tuple[torch.Tensor, ...]
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    factor: Tuple[float, ...]
    sharded: Tuple[bool, ...]


class Consts(NamedTuple):
    """A step's constants: the clip (None: none), Adam's betas, the bias
    corrections at the incremented count (fp32 values), eps and the weight
    decay."""

    clip_norm: Optional[float]
    beta1: float
    beta2: float
    bc1: float
    bc2: float
    eps: float
    weight_decay: float


@functools.cache
def _lib():
    lib = load("lamb_finish", SIGNATURES)
    if lib.lamb_finish_chunk() != CHUNK:
        raise RuntimeError(f"lamb_finish.cu takes {lib.lamb_finish_chunk()} elements a block, "
                           f"the host {CHUNK}")
    return lib


# ------------------------------------------------------------ plain versions
def _direction(m, v, p32, c: Consts):
    """The LAMB direction from the updated moments."""
    return (m / c.bc1) / (torch.sqrt(v / c.bc2) + c.eps) + c.weight_decay * p32


def lamb_finish_norms_plain(leaves: Leaves, grads: Grads):
    """Pass 0's contract in plain PyTorch: ([L] each leaf's sum of
    ``nan_to_num(g)^2``, 0 where g is None; their sum over the leaves not
    sharded), fp32."""
    dev = leaves.p[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    g32 = [None if g is None else torch.nan_to_num(g.float()) for g in grads]
    sq = [zero if g is None else torch.sum(g * g) for g in g32]
    rep = [s for s, sh in zip(sq, leaves.sharded) if not sh]
    return torch.stack(sq), torch.stack(rep).sum() if rep else zero


def lamb_finish_moments_plain(leaves: Leaves, grads: Grads, grad_norm: torch.Tensor,
                              c: Consts) -> torch.Tensor:
    """Pass 1's contract: the gradients (None: zeros) made finite and scaled
    by ``clip / grad_norm`` unless the norm is below the clip, the moments
    updated in place, ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2)
    g^2``; returns [L, 2] each leaf's ``||p||^2`` and ``||u||^2``."""
    clip_s = torch.ones((), dtype=torch.float32, device=grad_norm.device)
    if c.clip_norm is not None:
        clip_s = torch.where(grad_norm < c.clip_norm, clip_s, c.clip_norm / grad_norm)
    rows = []
    for p, m, v, g in zip(leaves.p, leaves.m, leaves.v, grads):
        g32 = torch.zeros_like(m) if g is None else torch.nan_to_num(g.float())
        gc = g32 * clip_s
        m.mul_(c.beta1).add_((1.0 - c.beta1) * gc)
        v.mul_(c.beta2).add_((1.0 - c.beta2) * (gc * gc))
        p32 = p.float()
        u = _direction(m, v, p32, c)
        rows.append(torch.stack([torch.sum(p32 * p32), torch.sum(u * u)]))
    return torch.stack(rows)


def lamb_finish_apply_plain(leaves: Leaves, pu: torch.Tensor, c: Consts, lr: float,
                            ema_decay: float, overwrite: Grads) -> None:
    """Pass 2's contract: from [L, 2] squared norms ``pu``, each leaf's
    trust ratio ``||p|| / ||u||`` (1 where either is 0) and ``p' = p - lr *
    factor * trust * u``, or the leaf's overwrite source where it has one;
    then ``e += (1 - decay) (p' - e)``; p and e written in place."""
    norms = torch.sqrt(pu)
    for i, (p, e, m, v) in enumerate(zip(leaves.p, leaves.e, leaves.m, leaves.v)):
        if overwrite[i] is not None:
            p_new = overwrite[i].to(p.dtype)
        else:
            pn, un = norms[i]
            trust = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
            p32 = p.float()
            u = _direction(m, v, p32, c)
            p_new = (p32 + (-lr * leaves.factor[i] * trust) * u).to(p.dtype)
        e.add_(((1.0 - ema_decay) * (p_new.float() - e.float())).to(e.dtype))
        p.copy_(p_new)


# ------------------------------------------------------------------ kernels
class _Layout(NamedTuple):
    table: torch.Tensor    # the Leaf table on the device
    tickets: torch.Tensor  # pass 0's and pass 1's L + 1 tickets, zero between launches
    chunks: int            # blocks a pass
    live: int              # leaves with elements
    n: Tuple[int, ...]     # each leaf's elements


_LAYOUTS: "collections.OrderedDict[tuple, _Layout]" = collections.OrderedDict()


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host table on the device through pinned memory, on the stream,
    with no host sync."""
    return torch.from_numpy(arr.view(np.uint8)).pin_memory().to(device, non_blocking=True)


def _check_fp32(t: torch.Tensor, ref: torch.Tensor, n: int, what: str) -> None:
    if t.device != ref.device:
        raise ValueError(f"{what} on {t.device}, expected {ref.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what} is {t.dtype}: the finish's kernels take float32")
    if t.numel() != n:
        raise ValueError(f"{what} has {t.numel()} elements, expected {n}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _layout(leaves: Leaves) -> _Layout:
    """The leaf table for these tensors, built once while their storage is
    unchanged (the key is every pointer and size), checked when built."""
    ref = leaves.p[0]
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    key = (ref.device, leaves.factor, leaves.sharded,
           tuple((p.data_ptr(), e.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
                 for p, e, m, v in zip(leaves.p, leaves.e, leaves.m, leaves.v)))
    if key in _LAYOUTS:
        _LAYOUTS.move_to_end(key)
        return _LAYOUTS[key]
    arr = np.zeros(len(leaves.p), LEAF)
    chunk0 = 0
    for i, (p, e, m, v) in enumerate(zip(leaves.p, leaves.e, leaves.m, leaves.v)):
        n = p.numel()
        for name, t in (("parameter", p), ("EMA", e), ("first moment", m),
                        ("second moment", v)):
            _check_fp32(t, ref, n, f"leaf {i}'s {name}")
        arr[i] = (p.data_ptr(), m.data_ptr(), v.data_ptr(), e.data_ptr(), n, chunk0,
                  leaves.factor[i], int(leaves.sharded[i]))
        chunk0 += -(-n // CHUNK)
    if chunk0 >= 2 ** 31:
        raise ValueError(f"{chunk0} chunks of {CHUNK} elements: more than a grid takes")
    tickets = torch.zeros(2 * (len(leaves.p) + 1), dtype=torch.int32, device=ref.device)
    _LAYOUTS[key] = lay = _Layout(_to_device(arr, ref.device), tickets, chunk0,
                                  int((arr["n"] > 0).sum()), tuple(int(x) for x in arr["n"]))
    while len(_LAYOUTS) > LAYOUTS_KEPT:
        _LAYOUTS.popitem(last=False)
    return lay


def _ptrs(ts: Grads, leaves: Leaves, lay: _Layout, what: str) -> Tuple[int, ...]:
    """Each leaf's tensor's pointer (0: none), checked."""
    if not ts:
        return (0,) * len(leaves.p)
    if len(ts) != len(leaves.p):
        raise ValueError(f"{len(ts)} {what}s for {len(leaves.p)} leaves")
    ref = leaves.p[0]
    for i, t in enumerate(ts):
        if t is not None:
            _check_fp32(t, ref, lay.n[i], f"leaf {i}'s {what}")
    return tuple(0 if t is None else t.data_ptr() for t in ts)


def _dyn(leaves: Leaves, lay: _Layout, grads: Grads = (), sources: Grads = ()) -> torch.Tensor:
    """The per-call table of each leaf's gradient and overwrite source (0:
    none), checked."""
    arr = np.zeros(len(leaves.p), DYN)
    arr["g"] = _ptrs(grads, leaves, lay, "gradient")
    arr["src"] = _ptrs(sources, leaves, lay, "overwrite source")
    return _to_device(arr, leaves.p[0].device)


def _use_plain(leaves: Leaves) -> bool:
    if not leaves.p:
        raise ValueError("the finish needs at least one leaf")
    dev = leaves.p[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _reciprocal(x: float) -> float:
    """1 / x in fp32, as PyTorch divides a tensor by a scalar on the card."""
    return float(np.float32(1.0) / np.float32(x))


@counted
def lamb_finish_norms(leaves: Leaves, grads: Grads):
    """Pass 0; same contract as :func:`lamb_finish_norms_plain`. CPU tensors
    take the plain version; CUDA tensors launch the kernel, once, counted in
    ``lamb_finish_norms.launches``."""
    if _use_plain(leaves):
        return lamb_finish_norms_plain(leaves, grads)
    lay = _layout(leaves)
    dyn = _dyn(leaves, lay, grads=grads)
    L, dev = len(leaves.p), leaves.p[0].device
    if lay.chunks == 0:
        return (torch.zeros(L, dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))
    leaf_sq = torch.empty(L, dtype=torch.float32, device=dev)
    grad_sq = torch.empty((), dtype=torch.float32, device=dev)
    part = torch.empty(lay.chunks, dtype=torch.float32, device=dev)
    err = _lib().lamb_finish_norms(
        lay.table.data_ptr(), dyn.data_ptr(), L, lay.live, lay.chunks, part.data_ptr(),
        leaf_sq.data_ptr(), grad_sq.data_ptr(), lay.tickets.data_ptr(), stream_of(leaf_sq))
    check(err, "lamb_finish_norms")
    lamb_finish_norms.launches += 1
    return leaf_sq, grad_sq


@counted
def lamb_finish_moments(leaves: Leaves, grads: Grads, grad_norm: torch.Tensor,
                        c: Consts) -> torch.Tensor:
    """Pass 1; same contract as :func:`lamb_finish_moments_plain`. One
    launch, counted in ``lamb_finish_moments.launches``."""
    if _use_plain(leaves):
        return lamb_finish_moments_plain(leaves, grads, grad_norm, c)
    lay = _layout(leaves)
    dyn = _dyn(leaves, lay, grads=grads)
    L, dev = len(leaves.p), leaves.p[0].device
    _check_fp32(grad_norm, leaves.p[0], 1, "the gradient norm")
    if lay.chunks == 0:
        return torch.zeros((L, 2), dtype=torch.float32, device=dev)
    pu = torch.empty((L, 2), dtype=torch.float32, device=dev)
    part = torch.empty((lay.chunks, 2), dtype=torch.float32, device=dev)
    clip = c.clip_norm is not None
    err = _lib().lamb_finish_moments(
        lay.table.data_ptr(), dyn.data_ptr(), L, lay.live, lay.chunks, grad_norm.data_ptr(),
        int(clip), c.clip_norm if clip else 0.0, c.beta1, 1.0 - c.beta1, c.beta2, 1.0 - c.beta2,
        _reciprocal(c.bc1), _reciprocal(c.bc2), c.eps, c.weight_decay, part.data_ptr(),
        pu.data_ptr(), lay.tickets[L + 1:].data_ptr(), stream_of(pu))
    check(err, "lamb_finish_moments")
    lamb_finish_moments.launches += 1
    return pu


@counted
def lamb_finish_apply(leaves: Leaves, pu: torch.Tensor, c: Consts, lr: float, ema_decay: float,
                      overwrite: Grads) -> None:
    """Pass 2; same contract as :func:`lamb_finish_apply_plain`. One
    launch, counted in ``lamb_finish_apply.launches``."""
    if _use_plain(leaves):
        return lamb_finish_apply_plain(leaves, pu, c, lr, ema_decay, overwrite)
    lay = _layout(leaves)
    dyn = _dyn(leaves, lay, sources=overwrite)
    _check_fp32(pu, leaves.p[0], 2 * len(leaves.p), "the squared norms")
    if lay.chunks == 0:
        return None
    err = _lib().lamb_finish_apply(
        lay.table.data_ptr(), dyn.data_ptr(), len(leaves.p), lay.chunks, pu.data_ptr(), lr,
        _reciprocal(c.bc1), _reciprocal(c.bc2), c.eps, c.weight_decay, 1.0 - ema_decay,
        stream_of(pu))
    check(err, "lamb_finish_apply")
    lamb_finish_apply.launches += 1
    return None
