"""LAMB with per-module learning-rate factors, global-norm clipping and the
EMA of the weights, written by hand.

Follows the JAX package's fused finish step
(``caiman_asr_tpu/training/fused_finish.py:96-208``), which computes the
same numbers as its optax chain ``clip_by_global_norm -> lamb -> module lr
factors`` (``caiman_asr_tpu/training/optimizer.py``): non-finite gradients
become finite (``nan_to_num``), the global norm is taken before the clip
(it is the logged metric), the clip scales by ``clip / norm`` unless the
norm is below the clip, the Adam moments are bias-corrected at the
incremented count, weight decay is added to the update, the trust ratio
``||p|| / ||u||`` falls back to 1 when either norm is 0, the learning rate
is the schedule at the count before the increment times the module's
factor, and the EMA is ``e + (1 - decay) (p' - e)``. On a non-finite loss
nothing changes: parameters, EMA, moments and both counts.

``overwrite`` replaces some updated leaves before the EMA takes them: the
batch-norm running stats, which the train step folds from the batch
(``caiman_asr_tpu/training/step.py:336-357``, its optax path).

The update is written in place, under ``torch.no_grad``, into the
parameter, EMA and moment tensors it is given (the JAX version returns new
trees); the counts are Python ints in a new state.

Under model parallelism (``sharded`` paths and a model ``group``) some
leaves are this rank's vocab shard of a whole tensor. The JAX step takes
LAMB's norms on the whole tensors (GSPMD, ``step.py:590-593``); here the
global norm sums the squares of the replicated leaves once and adds the
sharded leaves' sums all-reduced over the group, and each sharded leaf's
trust ratio uses ``||p||`` and ``||u||`` all-reduced likewise (one
all-reduce for all of them), so that every rank takes the unsharded step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from caiman_asr_tpu_torch.training.lr import lr_schedule
from caiman_asr_tpu_torch.training.tree import Tree, tree_items, tree_map

INT32_MAX = 2 ** 31 - 1  # optax's safe_increment saturates the int32 counts


@dataclass(frozen=True)
class OptimizerConfig:
    """Defaults mirror the reference CLI (args/train.py:118-151)."""

    lr: float = 4e-3
    min_lr: float = 4e-4
    weight_decay: float = 1e-2
    clip_norm: Optional[float] = 1.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-9
    warmup_steps: int = 1632
    hold_steps: int = 18000
    half_life_steps: int = 10880
    ema: float = 0.999


class LambState(NamedTuple):
    mu: Tree        # first moments, fp32, the parameters' tree
    nu: Tree        # second moments
    count: int      # Adam's step count (taken steps)
    sched_count: int  # the schedule's step count


class Lamb:
    """The optimizer for ``cfg`` with per-module learning-rate factors
    (``RNNT.param_lr_factors()``): ``init(params)`` and ``update(...)``."""

    def __init__(self, cfg: OptimizerConfig, lr_factors: Optional[Dict[str, float]] = None):
        self.cfg = cfg
        self.lr_factors = dict(lr_factors or {})
        self.schedule = lr_schedule(cfg.lr, cfg.min_lr, cfg.warmup_steps, cfg.hold_steps,
                                    cfg.half_life_steps)

    def init(self, params: Tree) -> LambState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return LambState(tree_map(zeros, params), tree_map(zeros, params), 0, 0)

    @torch.no_grad()
    def update(self, params: Tree, ema_params: Tree, state: LambState,
               grads: Dict[Tuple[str, ...], Optional[torch.Tensor]], good: bool,
               ema_decay: float,
               overwrite: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None,
               sharded: FrozenSet[Tuple[str, ...]] = frozenset(), group=None,
               ) -> Tuple[LambState, torch.Tensor]:
        """One step. ``grads`` maps each parameter's tree path to its
        gradient (None: no gradient, counted as zeros). Writes params, EMA
        and moments in place when ``good``; a leaf whose path is in
        ``overwrite`` takes that value in place of its update, before the
        EMA. ``sharded``: the paths whose leaves are this rank's shard over
        the model ``group``. Returns (new state, the global gradient norm
        before the clip)."""
        overwrite = overwrite or {}
        sharded = frozenset(sharded) if group is not None else frozenset()
        cfg = self.cfg
        f32 = np.float32
        paths = [path for path, _ in tree_items(params)]
        g32 = {path: None if grads.get(path) is None
               else torch.nan_to_num(grads[path].float()) for path in paths}
        sq = [torch.sum(g * g) for path, g in g32.items()
              if g is not None and path not in sharded]
        sq_sh = [torch.sum(g * g) for path, g in g32.items() if g is not None and path in sharded]
        if sq_sh:
            part = torch.stack(sq_sh).sum()
            dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
            sq.append(part)
        grad_norm = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
        if not good:
            return state, grad_norm
        clip_s = torch.ones((), device=grad_norm.device)
        if cfg.clip_norm is not None:
            clip_s = torch.where(grad_norm < cfg.clip_norm, clip_s, cfg.clip_norm / grad_norm)
        count_inc = min(state.count + 1, INT32_MAX)
        bc1 = float(f32(1.0) - f32(cfg.beta1) ** f32(count_inc))
        bc2 = float(f32(1.0) - f32(cfg.beta2) ** f32(count_inc))
        lr = self.schedule(state.sched_count)
        leaves = {
            name: dict(tree_items(tree))
            for name, tree in (("p", params), ("e", ema_params), ("m", state.mu),
                               ("v", state.nu))
        }

        def direction(path):
            """The leaf's fp32 value and LAMB direction u, its moments
            updated in place."""
            p, m, v = leaves["p"][path], leaves["m"][path], leaves["v"][path]
            g = g32[path]
            gc = (g if g is not None else torch.zeros_like(m)) * clip_s
            m.mul_(cfg.beta1).add_((1.0 - cfg.beta1) * gc)
            v.mul_(cfg.beta2).add_((1.0 - cfg.beta2) * (gc * gc))
            p32 = p.float()
            return p32, (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32

        # the sharded leaves first: their norms over the whole tensors
        shard_dirs, norms = {}, {}
        for path in paths:
            if path in sharded:
                shard_dirs[path] = direction(path)
        if shard_dirs:
            sq_pu = torch.stack([torch.stack([torch.sum(p32 * p32), torch.sum(u * u)])
                                 for p32, u in shard_dirs.values()])
            dist.all_reduce(sq_pu, op=dist.ReduceOp.SUM, group=group)
            norms = dict(zip(shard_dirs, torch.sqrt(sq_pu)))
        for path in paths:
            p, e = leaves["p"][path], leaves["e"][path]
            if path in shard_dirs:
                p32, u = shard_dirs.pop(path)
                pn, un = norms[path]
            else:
                p32, u = direction(path)
                pn = torch.linalg.vector_norm(p32)
                un = torch.linalg.vector_norm(u)
            trust = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
            factor = self.lr_factors.get(path[0], 1.0)
            p_new = (p32 + (-lr * factor * trust) * u).to(p.dtype)
            if path in overwrite:
                p_new = overwrite[path].to(p.dtype)
            e.add_(((1.0 - ema_decay) * (p_new.float() - e.float())).to(e.dtype))
            p.copy_(p_new)
        new = LambState(state.mu, state.nu, count_inc, min(state.sched_count + 1, INT32_MAX))
        return new, grad_norm
