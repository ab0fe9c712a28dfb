"""The train step and the validation loss, mirroring
``caiman_asr_tpu/training/step.py``.

- Gradient accumulation over the A microbatches of a batch: the loss of
  each is its per-utterance sum over A*B, the gradients are summed in fp32.
- Mixed precision as ``_cast_compute``: with ``compute_dtype``, matrices
  (and the features) are cast to it and vectors stay fp32; the fp32
  parameters are the master weights and get the gradients.
- Random state passing (``rsp``): the streaming state is threaded through
  the microbatches, each gated by its own 0/1 gate, detached and cast to
  the carry's dtype after each (``_micro_loss``); a skipped step returns a
  zero state.
- The packed joint (``pack_to``) on every microbatch.
- Gradient noise (``grad_noise``): ``std * N(0, 1)`` added to the encoder's
  gradients after ``nan_to_num`` (``add_grad_noise``).
- Batch-norm training: each microbatch's batch statistics folded into the
  running stats in turn with ``BN_MOMENTUM``; after the LAMB update the
  stat leaves take the folded stats, then the EMA.
- Layer statistics (``collect_layer_stats``) from the parameters before
  the update and the gradients the optimizer takes.
- The non-finite skip: a step whose total loss is not finite changes
  nothing (``optimizer.Lamb.update``).
- LAMB, its learning-rate schedule and the EMA of the weights
  (``training/optimizer.py``).
- Over several processes (``group``): each rank runs its own rows and the
  step computes what the JAX step computes over the global batch. The loss
  is normalised by A*B*W; the raw fp32 gradients and the total loss are
  summed over the ranks in one all-reduce (``parallel/mesh.all_reduce_flat``)
  before ``nan_to_num``, so the non-finite skip, the gradient norm, the
  layer statistics and the update are alike on every rank; the gradient
  noise is drawn from a generator the caller seeds alike on every rank;
  batch-norm normalises with the global batch's statistics
  (``ops/lstm.batch_norm_group``).

- The pruned loss (``pruned_range`` > 0, ``ops/pruned_loss.py``): the
  state's tree then holds the training-only heads ``simple_am`` /
  ``simple_lm`` (``init_train_state(..., pruned_loss=True)``) and the loss
  is ``simple_loss_scale * simple + pruned``; packing is not used (the band
  bounds the joint's rows), random state passing is.
- The tensor-parallel step (``make_train_step_tp``, ``--model_parallel``):
  ``joint_fc`` and the heads are this rank's vocab shard over a model group
  (``parallel/vocab_parallel.py``), everything else is replicated; the
  gradients are summed over the data group only, LAMB takes its norms over
  the whole tensors (``training/optimizer.py``), and the caller draws the
  dropout from a generator seeded by the data rank, alike on every rank of
  a model group.

Batch layout (accumulation-major, time-major)::

  feats      [A, T, B, F]   float
  feat_lens  [A, B]         int
  txt        [A, B, U]      int
  txt_lens   [A, B]         int
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.log.layer_stats import layer_stats_vec
from caiman_asr_tpu_torch.models.state import RNNTState
from caiman_asr_tpu_torch.ops.lstm import BN_MOMENTUM, batch_norm_group
from caiman_asr_tpu_torch.parallel import mesh
from caiman_asr_tpu_torch.parallel.vocab_parallel import gather_tree, shard_tree, sharded_paths
from caiman_asr_tpu_torch.ops.pruned_loss import (
    init_simple_params,
    pruned_transducer_loss_from_fg,
)
from caiman_asr_tpu_torch.ops.transducer_loss import LossModifiers, transducer_loss_from_fg
from caiman_asr_tpu_torch.training.optimizer import Lamb, LambState
from caiman_asr_tpu_torch.training.tree import Tree, tree_items, tree_map

Path = Tuple[str, ...]


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


SIMPLE_SEED_TAG = 0x51  # the JAX step's fold_in for the heads' key


def init_train_state(model, optimizer: Lamb, *, device="cuda", pruned_loss: bool = False,
                     seed: int = 0) -> TrainState:
    """A fresh state around ``model``'s current weights (drawn by
    ``RNNT.init_weights`` or loaded): EMA equal to them, zero moments. With
    ``pruned_loss`` the tree also holds the pruned loss's heads, drawn from
    a generator seeded by (``seed``, 0x51) (JAX ``step.py:57-69``)."""
    dev = _on_device(model, device)
    params = model.param_tree()
    if pruned_loss:
        gen = torch.Generator(device=dev).manual_seed(
            int(np.random.SeedSequence([seed, SIMPLE_SEED_TAG]).generate_state(1)[0]))
        params = {**params, **init_simple_params(gen, model.cfg.joint_n_hid, model.n_classes)}
    ema = tree_map(lambda p: p.detach().clone(), params)
    return TrainState(params, ema, optimizer.init(params), 0)


def shard_state(state: TrainState, rank: int, m: int) -> TrainState:
    """The state of model rank ``rank`` of ``m``: its vocab shard of the
    sharded leaves (``parallel/vocab_parallel.VOCAB_SHARDED``) of the
    parameters, the EMA and both moments, new tensors; the rest shared."""
    cut = lambda tree: shard_tree(tree, rank, m)
    opt = state.opt_state
    return TrainState(cut(state.params), cut(state.ema_params),
                      opt._replace(mu=cut(opt.mu), nu=cut(opt.nu)), state.step)


def gather_state(state: TrainState, model_group) -> TrainState:
    """The whole state from every model rank's shards (a collective, one a
    sharded leaf), as a checkpoint holds it; ``state`` itself without a
    model group."""
    if model_group is None:
        return state
    whole = lambda tree: gather_tree(tree, model_group)
    opt = state.opt_state
    return TrainState(whole(state.params), whole(state.ema_params),
                      opt._replace(mu=whole(opt.mu), nu=whole(opt.nu)), state.step)


def _cast_compute(params: Tree, feats: torch.Tensor, compute_dtype):
    """Matrices and features in ``compute_dtype``, vectors fp32
    (``step.py:78-89``); None leaves everything as it is."""
    if compute_dtype is None:
        return params, feats
    cast = lambda p: p.to(compute_dtype) if p.dtype == torch.float32 and p.ndim > 1 else p
    return tree_map(cast, params), feats.to(compute_dtype)


def map_state(fn, *states: RNNTState) -> RNNTState:
    """``fn`` over the leaves of one or more RNNTStates of one layout."""
    def walk(*nodes):
        if isinstance(nodes[0], torch.Tensor):
            return fn(*nodes)
        kids = [walk(*k) for k in zip(*nodes)]
        return type(nodes[0])(*kids) if hasattr(nodes[0], "_fields") else tuple(kids)
    return walk(*states)


def _micro_loss(model, params: Tree, mb: Dict[str, torch.Tensor], generator,
                mods: LossModifiers, denom: float, blank_idx: int, compute_dtype=None, *,
                pack_to: Optional[int] = None, rnnt_state: Optional[RNNTState] = None,
                gate: Optional[torch.Tensor] = None, bn_updates: Optional[list] = None,
                pruned_range: int = 0, simple_scale: float = 0.5, model_group=None):
    """(normalised loss, new streaming state) of one microbatch (feats
    [T, B, F]). With ``rnnt_state`` (random state passing) the microbatch
    starts from it, gated by ``gate`` (a 0-d 0/1 tensor) for every sample,
    and the new state comes back detached in the carry's dtypes (JAX's
    ``_micro_loss_rsp``). ``pruned_range`` > 0 takes the pruned loss, which
    ignores ``pack_to`` (JAX ``step.py:127-141``); ``model_group`` the
    vocab-parallel joint."""
    p, feats = _cast_compute(params, mb["feats"], compute_dtype)
    B = feats.shape[1]
    (f, f_lens), (g, _), new_state = model.enc_pred(
        feats, mb["feat_lens"], mb["txt"], mb["txt_lens"], rnnt_state,
        state_gate=None if gate is None else gate.expand(B), params=p, train=True,
        generator=generator, bn_updates=bn_updates)
    if pruned_range > 0:
        per_utt = pruned_transducer_loss_from_fg(
            f, g, p["joint_fc"]["w"], p["joint_fc"]["b"],
            {"simple_am": p["simple_am"], "simple_lm": p["simple_lm"]}, mb["txt"], f_lens,
            mb["txt_lens"], blank_idx, mods, prune_range=pruned_range, simple_scale=simple_scale,
            generator=generator, dropout_rate=model.cfg.joint_dropout, model_group=model_group)
    else:
        per_utt = transducer_loss_from_fg(
            f, g, p["joint_fc"]["w"], p["joint_fc"]["b"], mb["txt"], f_lens, mb["txt_lens"],
            blank_idx, mods, generator=generator, dropout_rate=model.cfg.joint_dropout,
            pack_to=pack_to, model_group=model_group,
        )
    if rnnt_state is not None:
        new_state = map_state(lambda n, o: n.detach().to(o.dtype), new_state, rnnt_state)
    return per_utt.sum() / denom, new_state


def add_grad_noise(grads: Dict[Path, torch.Tensor], std: float,
                   generator: Optional[torch.Generator] = None,
                   normals: Optional[Dict[Path, torch.Tensor]] = None) -> Dict[Path, torch.Tensor]:
    """``grads`` with ``std * N(0, 1)`` added to every encoder leaf
    (``step.py:260-270``). The normals are drawn from ``generator``, or
    taken from ``normals`` by path where given."""
    if normals is None and generator is None:
        raise ValueError("gradient noise requires a generator")
    out = dict(grads)
    for path, g in grads.items():
        if path[0] != "encoder":
            continue
        if normals is not None:
            z = normals[path].to(device=g.device, dtype=g.dtype)
        else:
            z = torch.randn(g.shape, generator=generator, device=g.device, dtype=g.dtype)
        out[path] = g + std * z
    return out


def _nested(items: Dict[Path, torch.Tensor]) -> Tree:
    tree: Tree = {}
    for path, leaf in items.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


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
    simple_loss_scale: float = 0.5,
    collect_layer_stats: bool = False,
    group=None,
    model_group=None,
    device="cuda",
):
    """Build ``step(state, batch, generator, scalars, rnnt_state=None,
    gates=None, pack_to=None, noise_generator=None)``.

    ``scalars`` holds the host-scheduled ``delay_penalty`` and
    ``star_penalty``, and ``grad_noise_std`` with ``grad_noise``;
    ``generator`` draws every dropout mask and the gradient noise.
    ``pack_to`` runs the joint over that many rows (``training/pack``). The
    step updates ``state``'s tensors in place and returns the new state with
    metrics ``{"loss", "grad_norm", "skipped"}`` (and ``"layer_stats"``,
    the vector of ``log/layer_stats``, with ``collect_layer_stats``).

    With ``rsp`` the step takes the carried ``rnnt_state`` and the A
    microbatches' ``gates`` (``training/rsp.RSPController``) and returns
    ``(state, metrics, new_rnnt_state)``; after a skipped step the returned
    state is zero and the caller resets its controller. Runs on ``device``
    ("cuda" unless the caller asks for "cpu"), where the model must be.

    ``group``: the process group of data-parallel ranks (None: one
    process). The batch is then this rank's rows; ``noise_generator``, seeded
    alike on every rank, draws the gradient noise (else ``generator``).
    ``pruned_range`` > 0: the pruned loss with band width ``pruned_range``
    and ``simple_loss_scale``; the state must hold the heads.
    ``model_group``: see ``make_train_step_tp``.
    """
    dev = _on_device(model, device)
    has_bn = model.has_batch_norm
    if rsp and has_bn:
        # the JAX package's own rule (the reference's constraint)
        raise NotImplementedError("random state passing is not supported with batch-norm LSTMs")

    world = 1 if group is None else torch.distributed.get_world_size(group)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator,
             scalars: Dict[str, Any], rnnt_state: Optional[RNNTState] = None, gates=None,
             pack_to: Optional[int] = None, noise_generator=None):
        A, _, B, _ = batch["feats"].shape
        if rsp and (rnnt_state is None or gates is None):
            raise ValueError("random state passing needs rnnt_state and gates")
        if pruned_range > 0 and "simple_am" not in state.params:
            raise ValueError("the pruned loss needs the simple heads in the state: "
                             "init_train_state(..., pruned_loss=True)")
        denom = float(A * B * world)
        mods = LossModifiers(
            delay_penalty=float(scalars["delay_penalty"]), eos_penalty=eos_penalty,
            eos_idx=eos_idx, star_penalty=float(scalars["star_penalty"]), star_idx=star_idx,
        )
        paths, leaves = zip(*tree_items(state.params))
        wanted = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        grads = [None] * len(leaves)
        gate_t = (torch.as_tensor(gates, dtype=torch.float32).to(dev) if rsp else None)
        bn_stats = list(model.bn_stats(state.params)) if has_bn else None
        rs = rnnt_state if rsp else None
        total = None
        sync_bn = has_bn and group is not None
        for a in range(A):
            mb = {k: v[a] for k, v in batch.items()}
            bn_updates = [] if has_bn else None
            with batch_norm_group(group) if sync_bn else contextlib.nullcontext():
                loss, new_rs = _micro_loss(
                    model, state.params, mb, generator, mods, denom, blank_idx, compute_dtype,
                    pack_to=pack_to, rnnt_state=rs, gate=gate_t[a] if rsp else None,
                    bn_updates=bn_updates, pruned_range=pruned_range,
                    simple_scale=simple_loss_scale, model_group=model_group)
                mb_grads = torch.autograd.grad(loss, [leaves[i] for i in wanted],
                                               allow_unused=True)
            for i, g in zip(wanted, mb_grads):
                if g is not None:
                    grads[i] = g.float() if grads[i] is None else grads[i] + g.float()
            total = loss.detach() if total is None else total + loss.detach()
            if rsp:
                rs = new_rs
            if has_bn:
                bn_stats = [((1 - BN_MOMENTUM) * m + BN_MOMENTUM * bm,
                             (1 - BN_MOMENTUM) * v + BN_MOMENTUM * bv)
                            for (m, v), (bm, bv) in zip(bn_stats, bn_updates)]
        if group is not None:
            # the global gradient and loss, before anything reads them
            summed = mesh.all_reduce_flat(
                [grads[i] if grads[i] is not None else torch.zeros_like(leaves[i],
                                                                        dtype=torch.float32)
                 for i in wanted] + [total.reshape(1)], group)
            for i, g in zip(wanted, summed):
                grads[i] = g
            total = summed[-1].reshape(())
        good = bool(torch.isfinite(total))
        # the optimizer takes the gradients as they are (None where the loss
        # does not reach a leaf: the batch-norm running stats) and makes
        # them finite on the fly (training/fused_finish.py); they are cleaned
        # here only where the noise or the layer statistics read them first
        # (the JAX step's fused path, step.py:303-306)
        g32 = dict(zip(paths, grads))
        if grad_noise or collect_layer_stats:
            clean = {path: torch.nan_to_num(g) if g is not None
                     else torch.zeros_like(leaf, dtype=torch.float32)
                     for path, g, leaf in zip(paths, grads, leaves)}
            if grad_noise:
                clean = g32 = add_grad_noise(
                    clean, float(scalars["grad_noise_std"]),
                    noise_generator if noise_generator is not None else generator)
        metrics = {}
        if collect_layer_stats:
            # on the whole tensors, as the JAX step's GSPMD takes them
            metrics["layer_stats"] = layer_stats_vec(gather_tree(state.params, model_group),
                                                     gather_tree(_nested(clean), model_group))
        overwrite = None
        if has_bn:
            overwrite = {path: stat for pair_paths, pair in zip(
                model.bn_stat_paths(state.params), bn_stats) for path, stat in zip(pair_paths,
                                                                                   pair)}
        opt_state, grad_norm = optimizer.update(
            state.params, state.ema_params, state.opt_state, g32, good, ema_decay, overwrite,
            sharded=sharded_paths(state.params), group=model_group)
        new = TrainState(state.params, state.ema_params, opt_state, state.step + int(good))
        metrics = {"loss": total, "grad_norm": grad_norm, "skipped": int(not good), **metrics}
        if rsp:
            # a non-finite step may have poisoned the carried state: zero it
            return new, metrics, rs if good else map_state(torch.zeros_like, rs)
        return new, metrics

    return step


def make_train_step_tp(model, optimizer: Lamb, blank_idx: int, *, data_group, model_group,
                       rsp: bool = False, **kw):
    """The tensor-parallel train step (JAX ``make_train_step_tp``,
    ``step.py:568-660``) over a (data x model) layout
    (``parallel/mesh.init_model_parallel``): ``state.params`` holds this
    rank's vocab shard of ``joint_fc`` (and of the pruned loss's heads), cut
    by ``parallel/vocab_parallel.shard_tree``; the dense, packed and pruned
    losses run the vocab-parallel joint over ``model_group``; the gradients
    are summed over ``data_group`` only (None: one data rank); LAMB's norms
    are over the whole tensors. The replicated leaves stay alike on every
    rank. ``generator`` must draw alike on every rank of a model group (the
    JAX step folds in the data index only), ``noise_generator`` alike on
    every rank. Batch-norm models and random state passing raise, as in the
    JAX package. Otherwise ``make_train_step``'s arguments."""
    if model.has_batch_norm:
        raise NotImplementedError("the tensor-parallel step does not support batch-norm LSTMs")
    if rsp:
        raise NotImplementedError("the tensor-parallel step does not support random state "
                                  "passing (data-parallel only)")
    if model_group is None:
        raise ValueError("the tensor-parallel step needs a model group")
    return make_train_step(model, optimizer, blank_idx, group=data_group,
                           model_group=model_group, **kw)


def make_val_loss_step(model, blank_idx: int, *, device="cuda"):
    """``val(params, batch) -> (summed loss, utterance count)`` for a batch
    {feats [T, B, F], feat_lens, txt, txt_lens} without gradients; the
    caller averages. ``params`` is a tree as ``RNNT.param_tree`` (e.g. the
    EMA of a train state)."""
    _on_device(model, device)

    @torch.no_grad()
    def val(params: Tree, batch: Dict[str, torch.Tensor]):
        (f, f_lens), (g, _), _ = model.enc_pred(batch["feats"], batch["feat_lens"],
                                                batch["txt"], batch["txt_lens"], params=params)
        per_utt = transducer_loss_from_fg(
            f, g, params["joint_fc"]["w"], params["joint_fc"]["b"], batch["txt"], f_lens,
            batch["txt_lens"], blank_idx,
        )
        return per_utt.sum(), float(per_utt.shape[0])

    return val
