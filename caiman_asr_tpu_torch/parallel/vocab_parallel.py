"""The vocab-parallel fused joint + LSE over a model group (the port of
``caiman_asr_tpu/parallel/vocab_parallel.py``).

The joint's last product ``h @ W`` [N, Hj] x [Hj, K] is split over the
vocabulary across the M ranks of a model group (``parallel/mesh.py``): each
rank holds the contiguous columns ``[r * K/M, (r + 1) * K/M)`` of W and b and
runs the kernels of one process (``ops/joint_kernel.py``) on them. Three
O(N) vectors cross the group in the forward (the partial sums of exp, the
label and the blank logits) and the [N, Hj] dh in the backward.

Layout contract, as in the JAX module:

- h, labels and the cotangents are alike on every rank of the group;
- ``w_local`` [Hj, K/M] and ``b_local`` [K/M] are this rank's shard, all
  shards of one width;
- ``blank_idx`` and the labels are global ids: a label of another shard
  meets no column here (the kernels' column compare is signed) and the
  blank column is added by the shard that owns it;
- every rank differentiates its own copy of the whole loss, so the
  cotangent arrives whole: dW and db are this shard's final gradients and
  dh is summed over the group.

``VocabParallelJointLSE`` runs, under a gradient, K5-store over the columns
``[0, ks)`` its bf16 slab holds (``ks`` from ``joint_kernel._store_cols`` on
the shard, as ``vocab_parallel.py:109-122``) and K2 over ``[ks, K/M)``; its
backward K5-A and K4-A for dh, K5-B and K4-B for dW and db, on labels
relative to the shard. ``vp_joint_lse_plain`` is the same function in plain
PyTorch autograd, for tests.

The train state's sharded leaves (``VOCAB_SHARDED``: ``joint_fc`` and the
pruned loss's heads) are cut from the whole tensors by ``shard_tree`` and
joined again by ``gather_tree``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from caiman_asr_tpu_torch.ops import joint_kernel as jk
from caiman_asr_tpu_torch.parallel.mesh import IdentPsumCt, PsumKeepCt
from caiman_asr_tpu_torch.training.tree import Tree, tree_items

# the parameter subtrees sharded on their vocab axis (the first: [K, Hj] and
# [K]), as the JAX step's ``joint_fc_pspecs`` (training/step.py:550-565)
VOCAB_SHARDED = ("joint_fc", "simple_am", "simple_lm")


def shard_relative_ids(ids, k_off: int, width: int):
    """(in-shard mask, relative id clipped into the shard) of global vocab
    ids against the columns ``[k_off, k_off + width)``; ``ids`` a tensor or
    an int."""
    if not isinstance(ids, torch.Tensor):
        rel = int(ids) - k_off
        return 0 <= rel < width, min(max(rel, 0), width - 1)
    rel = ids - k_off
    return (rel >= 0) & (rel < width), rel.clamp(0, width - 1)


def _local_onehot_logits(h, wt_local, b32, labels, blank_idx: int, k_off: int):
    """This shard's parts of the blank and label logits [N] (0 where the
    column is another shard's); ``wt_local`` [Kl, Hj]."""
    Kl = wt_local.shape[0]
    lab_in, lab_c = shard_relative_ids(labels.long(), k_off, Kl)
    z_lab = (h.float() * wt_local[lab_c].float()).sum(1) + b32[lab_c]
    z_lab = torch.where(lab_in, z_lab, 0.0)
    blank_in, blank_c = shard_relative_ids(blank_idx, k_off, Kl)
    if blank_in:
        z_blank = h.float() @ wt_local[blank_c].float() + b32[blank_c]
    else:
        z_blank = h.new_zeros((h.shape[0],), dtype=torch.float32)
    return z_blank, z_lab


def _k_off(group, Kl: int) -> int:
    return dist.get_rank(group) * Kl


def store_cols(N: int, Hj: int, Kl: int) -> int:
    """The columns of the shard that the bf16 slab holds under a gradient:
    the one-process budget on the shard's padded width
    (``vocab_parallel.py:105-113``), bf16 whatever the shape."""
    tp, kt = jk._tiles(Hj)[:2]
    return min(jk._store_cols(jk._pad(N, tp), jk._pad(Kl, kt), kt), Kl)


class VocabParallelJointLSE(torch.autograd.Function):
    """(lp_blank, lp_label) [N] from h [N, Hj], this rank's w [Hj, Kl] and b
    [Kl], global labels [N] and blank id; ``ks`` columns stored (0 without a
    gradient). One all-reduce over ``group`` in the forward, one in the
    backward (dh)."""

    @staticmethod
    def forward(ctx, h, w, b, labels, blank_idx: int, group, ks: int):
        h = h.contiguous()
        wt = w.t().contiguous()  # [Kl, Hj]
        b32 = b.float().contiguous()
        Kl = wt.shape[0]
        k_off = _k_off(group, Kl)
        u = None
        if ks > 0:
            sums, u = jk.joint_fwd_store(h, wt[:ks], b32[:ks])
            if ks < Kl:
                sums = sums + jk.joint_fwd(h, wt[ks:], b32[ks:])[0]
        else:
            sums = jk.joint_fwd(h, wt, b32)[0]
        z_blank, z_lab = _local_onehot_logits(h, wt, b32, labels, blank_idx, k_off)
        # everything the forward needs from the other shards, in one all-reduce
        flat = torch.cat([sums, z_blank, z_lab])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        sums, z_blank, z_lab = flat.view(3, -1)
        denom = torch.log(sums)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ctx.blank_idx, ctx.group, ctx.k_off, ctx.ks = blank_idx, group, k_off, ks
            ctx.b_dtype = b.dtype
            ctx.save_for_backward(h, w, b32, labels, denom, *([u] if u is not None else []))
        return z_blank - denom, z_lab - denom

    @staticmethod
    def backward(ctx, cb, cl):
        h, w, b32, labels, denom, *slab = ctx.saved_tensors
        ks, k_off = ctx.ks, ctx.k_off
        Kl = w.shape[1]
        w = w.contiguous()
        cb, cl = cb.float().contiguous(), cl.float().contiguous()
        c = cb + cl
        lab_rel = (labels.long() - k_off).to(torch.int32).contiguous()
        # pass A: the smear over this shard's columns
        smear = None
        if ks > 0:
            cs = c * torch.exp(-denom)
            ws = w if ks == Kl else w[:, :ks].contiguous()
            smear = jk.joint_bwd_dh(slab[0], ws, cs)
        if ks < Kl:
            rest = jk.joint_bwd_dh_recompute(h, w, b32, denom, c, ks, Kl)
            smear = rest if smear is None else smear.add_(rest)
        # the one-hot terms of the columns this shard owns
        lab_in, lab_c = shard_relative_ids(lab_rel.long(), 0, Kl)
        blank_in, blank_c = shard_relative_ids(ctx.blank_idx, k_off, Kl)
        dh = smear + torch.where(lab_in, cl, 0.0)[:, None] * w.t()[lab_c].float()
        if blank_in:
            dh += cb[:, None] * w[:, blank_c][None, :].float()
        dist.all_reduce(dh, op=dist.ReduceOp.SUM, group=ctx.group)
        # pass B: dW and db are this shard's own, no collective; the labels
        # relative to the shard, and to ks for the recomputed columns
        dws, dbs = [], []
        if ks > 0:
            dw1, db1 = jk.joint_bwd_dw(h, slab[0], cs, cl, lab_rel)
            dws.append(dw1)
            dbs.append(db1)
        if ks < Kl:
            dw2, db2 = jk.joint_bwd_dw_recompute(h, w, b32, denom, c, cl, lab_rel - ks, ks, Kl)
            dws.append(dw2)
            dbs.append(db2)
        dw, db = (torch.cat(dws, 1), torch.cat(dbs)) if len(dws) > 1 else (dws[0], dbs[0])
        if blank_in:
            # the blank one-hot: a rank-1 update of its column
            # (vocab_parallel.py:218-227)
            dw[:, blank_c] += h.float().t() @ cb
            db[blank_c] += cb.sum()
        return (dh.to(h.dtype), dw.to(w.dtype), db.to(ctx.b_dtype), None, None, None, None)


def vp_joint_lse(h, w_local, b_local, labels, blank_idx: int, group):
    """The vocab-parallel ``fused_joint_lse``: h [N, Hj]; ``w_local`` [Hj, Kl]
    and ``b_local`` [Kl] this rank's shard of ``group``; labels [N] and
    ``blank_idx`` global. Returns (lp_blank [N], lp_label [N]) fp32, alike on
    every rank of the group."""
    if not dist.is_initialized():
        raise RuntimeError("the vocab-parallel joint needs torch.distributed initialised "
                           "(parallel/mesh.init_multihost, init_model_parallel)")
    ks = 0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w_local, b_local)):
        ks = store_cols(h.shape[0], h.shape[1], w_local.shape[1])
    return VocabParallelJointLSE.apply(h, w_local, b_local, labels, blank_idx, group, ks)


def vp_joint_lse_plain(h, w_local, b_local, labels, blank_idx: int, group):
    """``vp_joint_lse`` in plain PyTorch autograd: the shard's fp32 logits,
    their sums of exp and one-hot logits summed over the group with
    ``PsumKeepCt``, h entering through ``IdentPsumCt``."""
    h = IdentPsumCt.apply(h, group)
    Kl = w_local.shape[1]
    k_off = _k_off(group, Kl)
    z = h.float() @ w_local.float() + b_local.float()
    sums = torch.exp(z).sum(1)
    lab_in, lab_c = shard_relative_ids(labels.long(), k_off, Kl)
    z_lab = torch.where(lab_in, z.gather(1, lab_c[:, None])[:, 0], 0.0)
    blank_in, blank_c = shard_relative_ids(blank_idx, k_off, Kl)
    z_blank = z[:, blank_c] if blank_in else torch.zeros_like(sums)
    sums, z_blank, z_lab = PsumKeepCt.apply(group, sums, z_blank, z_lab)
    denom = torch.log(sums)
    return z_blank - denom, z_lab - denom


# ------------------------------------------------------ the sharded state
def is_sharded(path: Tuple[str, ...]) -> bool:
    return path[0] in VOCAB_SHARDED


def shard_rows(t: torch.Tensor, rank: int, m: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of ``t``'s first axis of ``m``."""
    if t.shape[0] % m:
        raise ValueError(f"a vocabulary of {t.shape[0]} does not split into {m} equal shards")
    n = t.shape[0] // m
    return t[rank * n:(rank + 1) * n]


@torch.no_grad()
def shard_tree(tree: Tree, rank: int, m: int) -> Tree:
    """``tree`` with each sharded leaf replaced by a new tensor holding rank
    ``rank``'s shard of it (requiring a gradient where the leaf did); the
    other leaves are the same tensors."""
    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = prefix + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif is_sharded(path):
                out[k] = shard_rows(v, rank, m).clone().requires_grad_(v.requires_grad)
            else:
                out[k] = v
        return out
    return walk(tree, ())


@torch.no_grad()
def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The shards of ``group`` joined on the first axis in rank order (a
    collective), on ``t``'s device."""
    from caiman_asr_tpu_torch.parallel.mesh import _host_device

    n = dist.get_world_size(group)
    host = _host_device()
    parts = [torch.empty_like(t, device=host) for _ in range(n)]
    dist.all_gather(parts, t.detach().to(host).contiguous(), group=group)
    return torch.cat(parts).to(t.device)


def gather_tree(tree: Tree, group) -> Tree:
    """``tree`` with each sharded leaf joined over ``group`` (a collective,
    one a sharded leaf); the other leaves are the same tensors. ``group``
    None returns ``tree``."""
    if group is None:
        return tree
    out: Tree = {}
    for path, leaf in tree_items(tree):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = gather_rows(leaf, group) if is_sharded(path) else leaf
    return out


def sharded_paths(tree: Tree) -> set:
    return {path for path, _ in tree_items(tree) if is_sharded(path)}
