"""The fused LAMB finish: the tail of every train step in three passes.

The counterpart of ``caiman_asr_tpu/training/fused_finish.py``
(``fused_lamb_ema_update``, ``:96-208``), which the JAX train step takes by
default (``caiman_asr_tpu/training/step.py:272-331``). The non-finite guard,
the global gradient norm before the clip, the clip, LAMB (Adam with bias
correction at the incremented count, weight decay, the trust ratio with its
zero-norm guard, the schedule at the count before the increment, the
per-module lr factors) and the EMA of the weights, as three passes over the
parameter trees instead of a chain of per-leaf operations:

  pass 0  read g                -> per-leaf sum of nan_to_num(g)^2
  pass 1  read g, mu, nu, p     -> write mu', nu'; per-leaf ||p||^2, ||u||^2
  pass 2  read mu', nu', p, ema -> write p', ema' (u recomputed)

Each pass is one kernel launch over all the leaves on the card
(``ops/finish_kernel.py``, ``ops/csrc/lamb_finish.cu``) and its plain
version on the CPU. The gradients are taken as the step accumulated them:
a leaf's gradient may be None (no gradient: zeros) or hold NaN and inf,
which the passes make finite on the fly (``nan_to_num``).

Where the JAX version returns new trees, this one writes the parameters,
EMA and moments in place. Its skip is a host bool (``good``): on a
non-finite loss only pass 0 runs, for the gradient norm, and nothing
changes. A leaf in ``overwrite`` (a batch-norm running statistic) takes that
value in place of its update, before the EMA.

Under model parallelism (``sharded`` paths over the model ``group``) a
sharded leaf is this rank's vocab shard of a whole tensor. The JAX step
takes LAMB's norms on the whole tensors (GSPMD, ``step.py:590-593``); here
the global norm sums the replicated leaves' squares once and adds the
sharded leaves' sum all-reduced over the group (between passes 0 and 1),
and each sharded leaf's trust ratio takes ``||p||^2`` and ``||u||^2``
all-reduced likewise (between passes 1 and 2, one all-reduce for all of
them), so that every rank takes the unsharded step.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from caiman_asr_tpu_torch.ops import finish_kernel as fk
from caiman_asr_tpu_torch.training.tree import Tree

INT32_MAX = 2 ** 31 - 1  # optax's safe_increment saturates the int32 counts

Path = Tuple[str, ...]


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t if t is None or t.is_contiguous() else t.contiguous()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _flatten(params: Tree, *alike: Tree):
    """The parameters' paths and leaves in tree order, and the leaves of
    trees of the same structure (EMA, moments) at those paths, in one walk
    (the finish's host work a step)."""
    paths: list = []
    cols: Tuple[list, ...] = tuple([] for _ in range(1 + len(alike)))

    def walk(nodes, at):
        for key, value in nodes[0].items():
            if isinstance(value, dict):
                walk([value] + [n[key] for n in nodes[1:]], at + (key,))
            else:
                paths.append(at + (key,))
                for col, n in zip(cols, nodes):
                    col.append(n[key])

    walk([params, *alike], ())
    return (paths, *map(tuple, cols))


@torch.no_grad()
def fused_lamb_ema_update(params: Tree, ema_params: Tree, state,
                          grads: Dict[Path, Optional[torch.Tensor]], good: bool, cfg, lr_factors: Optional[Dict[str, float]],
                          schedule: Callable[[int], float], ema_decay: float,
                          overwrite: Optional[Dict[Path, torch.Tensor]] = None,
                          sharded: FrozenSet[Path] = frozenset(), group=None):
    """One LAMB + EMA step with the skip, in place.

    ``state``: the optimizer's state (``optimizer.LambState``: the moments'
    trees ``mu``, ``nu`` and the counts ``count``, ``sched_count``); ``cfg``:
    its ``OptimizerConfig``; ``grads``: each parameter's tree path to its
    gradient (missing or None: no gradient). Returns (the new state, the
    global gradient norm before the clip, a device scalar)."""
    overwrite = overwrite or {}
    sharded = frozenset(sharded) if group is not None else frozenset()
    lr_factors = lr_factors or {}
    paths, p, e, m, v = _flatten(params, ema_params, state.mu, state.nu)
    leaves = fk.Leaves(
        p=p, e=e, m=m, v=v, factor=tuple(float(lr_factors.get(path[0], 1.0)) for path in paths),
        sharded=tuple(path in sharded for path in paths))
    g = [_contiguous(grads.get(path)) for path in paths]
    rows = [i for i, s in enumerate(leaves.sharded) if s]

    # pass 0: the gradient norm (after nan_to_num, before the clip)
    leaf_sq, grad_sq = fk.lamb_finish_norms(leaves, g)
    if rows:
        grad_sq = grad_sq + _all_reduce(torch.stack([leaf_sq[i] for i in rows]).sum(), group)
    grad_norm = torch.sqrt(grad_sq)
    if not good:
        return state, grad_norm

    f32 = np.float32
    count_inc = min(state.count + 1, INT32_MAX)
    consts = fk.Consts(
        clip_norm=cfg.clip_norm, beta1=cfg.beta1, beta2=cfg.beta2,
        bc1=float(f32(1.0) - f32(cfg.beta1) ** f32(count_inc)),
        bc2=float(f32(1.0) - f32(cfg.beta2) ** f32(count_inc)),
        eps=cfg.eps, weight_decay=cfg.weight_decay)
    # pass 1: the clip, the moments, each leaf's ||p||^2 and ||u||^2
    pu = fk.lamb_finish_moments(leaves, g, grad_norm, consts)
    if rows:
        whole = _all_reduce(torch.stack([pu[i] for i in rows]), group)
        for k, i in enumerate(rows):
            pu[i] = whole[k]
    # pass 2: the parameters (the schedule at the count before the increment)
    # and the EMA
    sources = [None if path not in overwrite else
               _contiguous(overwrite[path].to(leaf.dtype)) for path, leaf in zip(paths, p)]
    fk.lamb_finish_apply(leaves, pu, consts, schedule(state.sched_count), ema_decay, sources)
    new = state._replace(count=count_inc, sched_count=min(state.sched_count + 1, INT32_MAX))
    return new, grad_norm
