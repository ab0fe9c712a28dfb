"""The train step and the validation loss, mirroring
``caiman_asr_tpu/training/step.py``.

- Gradient accumulation over the A microbatches of a batch: the loss of
  each is its per-utterance sum over A*B, the gradients are summed in fp32.
- Mixed precision as ``_cast_compute``: with ``compute_dtype``, matrices
  (and the features) are cast to it and vectors stay fp32; the fp32
  parameters are the master weights and get the gradients.
- The non-finite skip: a step whose total loss is not finite changes
  nothing (``optimizer.Lamb.update``).
- LAMB, its learning-rate schedule and the EMA of the weights
  (``training/optimizer.py``).

Batch layout (accumulation-major, time-major)::

  feats      [A, T, B, F]   float
  feat_lens  [A, B]         int
  txt        [A, B, U]      int
  txt_lens   [A, B]         int

Not ported yet, each raising when asked: random state passing (``rsp``),
gradient noise, batch-norm training, the pruned loss, the tensor-parallel
step and layer statistics.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.ops.transducer_loss import LossModifiers, transducer_loss_from_fg
from caiman_asr_tpu_torch.training.optimizer import Lamb, LambState
from caiman_asr_tpu_torch.training.tree import Tree, tree_items, tree_map

class TrainState(NamedTuple):
    params: Tree        # the model's own (fp32 master) parameters, updated in place
    ema_params: Tree
    opt_state: LambState
    step: int           # taken optimizer steps


def _on_device(model, device) -> torch.device:
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"model parameters are on {param_dev}, asked for {dev}")
    return dev


def init_train_state(model, optimizer: Lamb, *, device="cuda") -> TrainState:
    """A fresh state around ``model``'s current weights (drawn by
    ``RNNT.init_weights`` or loaded): EMA equal to them, zero moments."""
    _on_device(model, device)
    params = model.param_tree()
    ema = tree_map(lambda p: p.detach().clone(), params)
    return TrainState(params, ema, optimizer.init(params), 0)


def _cast_compute(params: Tree, feats: torch.Tensor, compute_dtype):
    """Matrices and features in ``compute_dtype``, vectors fp32
    (``step.py:78-89``); None leaves everything as it is."""
    if compute_dtype is None:
        return params, feats
    cast = lambda p: p.to(compute_dtype) if p.dtype == torch.float32 and p.ndim > 1 else p
    return tree_map(cast, params), feats.to(compute_dtype)


def _micro_loss(model, params: Tree, mb: Dict[str, torch.Tensor], generator,
                mods: LossModifiers, denom: float, blank_idx: int, compute_dtype=None):
    """Normalised loss of one microbatch (feats [T, B, F])."""
    p, feats = _cast_compute(params, mb["feats"], compute_dtype)
    (f, f_lens), (g, _) = model.enc_pred(feats, mb["feat_lens"], mb["txt"], mb["txt_lens"],
                                         params=p, train=True, generator=generator)
    per_utt = transducer_loss_from_fg(
        f, g, p["joint_fc"]["w"], p["joint_fc"]["b"], mb["txt"], f_lens, mb["txt_lens"],
        blank_idx, mods, generator=generator, dropout_rate=model.cfg.joint_dropout,
    )
    return per_utt.sum() / denom


def make_train_step(
    model,
    optimizer: Lamb,
    blank_idx: int,
    *,
    ema_decay: float = 0.999,
    eos_idx: int = -1,
    star_idx: int = -1,
    eos_penalty: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    grad_noise: bool = False,
    rsp: bool = False,
    pruned_range: int = 0,
    collect_layer_stats: bool = False,
    device="cuda",
):
    """Build ``step(state, batch, generator, scalars) -> (state, metrics)``.

    ``scalars`` holds the host-scheduled ``delay_penalty`` and
    ``star_penalty``; ``generator`` draws every dropout mask. The step
    updates ``state``'s tensors in place and returns the new state with
    metrics ``{"loss", "grad_norm", "skipped"}``. Runs on ``device``
    ("cuda" unless the caller asks for "cpu"), where the model must be.
    """
    _on_device(model, device)
    for flag, name in ((rsp, "random state passing"), (grad_noise, "gradient noise"),
                       (pruned_range > 0, "the pruned loss"),
                       (collect_layer_stats, "layer statistics"),
                       (model.has_batch_norm, "batch-norm training")):
        if flag:
            raise NotImplementedError(f"{name} is not ported yet")

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator,
             scalars: Dict[str, Any]):
        A, _, B, _ = batch["feats"].shape
        denom = float(A * B)
        mods = LossModifiers(
            delay_penalty=float(scalars["delay_penalty"]), eos_penalty=eos_penalty,
            eos_idx=eos_idx, star_penalty=float(scalars["star_penalty"]), star_idx=star_idx,
        )
        paths, leaves = zip(*tree_items(state.params))
        grads = [None] * len(leaves)
        total = None
        for a in range(A):
            mb = {k: v[a] for k, v in batch.items()}
            loss = _micro_loss(model, state.params, mb, generator, mods, denom, blank_idx,
                               compute_dtype)
            mb_grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for i, g in enumerate(mb_grads):
                if g is not None:
                    grads[i] = g.float() if grads[i] is None else grads[i] + g.float()
            total = loss.detach() if total is None else total + loss.detach()
        good = bool(torch.isfinite(total))
        opt_state, grad_norm = optimizer.update(
            state.params, state.ema_params, state.opt_state, dict(zip(paths, grads)), good,
            ema_decay)
        new = TrainState(state.params, state.ema_params, opt_state, state.step + int(good))
        return new, {"loss": total, "grad_norm": grad_norm, "skipped": int(not good)}

    return step


def make_val_loss_step(model, blank_idx: int, *, device="cuda"):
    """``val(params, batch) -> (summed loss, utterance count)`` for a batch
    {feats [T, B, F], feat_lens, txt, txt_lens} without gradients; the
    caller averages. ``params`` is a tree as ``RNNT.param_tree`` (e.g. the
    EMA of a train state)."""
    _on_device(model, device)

    @torch.no_grad()
    def val(params: Tree, batch: Dict[str, torch.Tensor]):
        (f, f_lens), (g, _) = model.enc_pred(batch["feats"], batch["feat_lens"], batch["txt"],
                                             batch["txt_lens"], params=params)
        per_utt = transducer_loss_from_fg(
            f, g, params["joint_fc"]["w"], params["joint_fc"]["b"], batch["txt"], f_lens,
            batch["txt_lens"], blank_idx,
        )
        return per_utt.sum(), float(per_utt.shape[0])

    return val
