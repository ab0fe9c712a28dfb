"""LAMB with per-module learning-rate factors, global-norm clipping and the
EMA of the weights.

The same numbers as the JAX package's optax chain ``clip_by_global_norm ->
lamb -> module lr factors`` (``caiman_asr_tpu/training/optimizer.py``) and
its fused finish step (``caiman_asr_tpu/training/fused_finish.py:96-208``):
non-finite gradients become finite (``nan_to_num``), the global norm is
taken before the clip (it is the logged metric), the clip scales by ``clip
/ norm`` unless the norm is below the clip, the Adam moments are
bias-corrected at the incremented count, weight decay is added to the
update, the trust ratio ``||p|| / ||u||`` falls back to 1 when either norm
is 0, the learning rate is the schedule at the count before the increment
times the module's factor, and the EMA is ``e + (1 - decay) (p' - e)``. On a
non-finite loss nothing changes: parameters, EMA, moments and both counts.

``Lamb.update`` runs it as ``training/fused_finish.py`` does: three passes
over all the leaves, each one kernel launch on the card
(``ops/finish_kernel.py``) and its plain per-leaf version on the CPU. There
is no switch to another route (the JAX package's ``CAIMAN_FUSED_FINISH``
and its fallback to the optax chain are not ported).

``overwrite`` replaces some updated leaves before the EMA takes them: the
batch-norm running stats, which the train step folds from the batch
(``caiman_asr_tpu/training/step.py:336-357``, its optax path).

The update is written in place, under ``torch.no_grad``, into the
parameter, EMA and moment tensors it is given (the JAX version returns new
trees); the counts are Python ints in a new state. Under model parallelism
(``sharded`` paths and a model ``group``) every rank takes the unsharded
step: see ``training/fused_finish.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, NamedTuple, Optional, Tuple

import torch

from caiman_asr_tpu_torch.training.fused_finish import fused_lamb_ema_update
from caiman_asr_tpu_torch.training.lr import lr_schedule
from caiman_asr_tpu_torch.training.tree import Tree, tree_map


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
        return fused_lamb_ema_update(params, ema_params, state, grads, good, self.cfg,
                                     self.lr_factors, self.schedule, ema_decay, overwrite,
                                     sharded, group)
