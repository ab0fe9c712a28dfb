"""Carry weights (and a train state) from the JAX package into the port.

The tree arrives as nested dicts of numpy arrays (``np.asarray`` over the
JAX leaves), so nothing here imports JAX. Names follow the reference torch
model; layouts are the same on both sides (LSTM ``[4H, in]`` with gates
i, f, g, o; Linear ``[out, in]``), so the mapping is renaming only. The
pruned loss's training-only heads (``simple_am``, ``simple_lm``) are no
module parameters: a train state carries them in its tree, the model's
``state_dict`` leaves them out.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

_STACKS = (("encoder", "pre_rnn"), ("encoder", "post_rnn"), ("prediction", "dec_rnn"))
_LSTM = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_LINEARS = {"joint_enc": "joint_enc", "joint_pred": "joint_pred", "joint_fc": "joint_net.2"}
_TREE = {"encoder": {"pre_rnn", "post_rnn"}, "prediction": {"embed", "dec_rnn"},
         **{k: None for k in _LINEARS}}
TRAIN_ONLY = ("simple_am", "simple_lm")  # the pruned loss's heads


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX RNN-T parameter tree -> the port's ``state_dict``.

    Raises on a leaf this mapping does not know, so nothing is dropped
    silently; the pruned loss's heads (``TRAIN_ONLY``) are left out."""
    unknown = sorted(set(params) - set(_TREE) - set(TRAIN_ONLY)) + sorted(
        f"{top}/{k}" for top, subs in _TREE.items() if subs
        for k in set(params[top]) - subs
    )
    if unknown:
        raise ValueError(f"parameters with no counterpart in the port: {unknown}")
    out: Dict[str, torch.Tensor] = {}
    for top, name in _STACKS:
        stack = params[top][name]
        prefix = f"{top}.{name}"
        has_bn = any("bn" in layer for layer in stack.values())
        for key, layer in stack.items():
            i = int(key.removeprefix("layer_"))
            extra = set(layer) - set(_LSTM) - {"bn"}
            if extra:
                raise ValueError(f"unknown leaves in {prefix}.{key}: {sorted(extra)}")
            for src, dst in _LSTM.items():
                if has_bn:
                    out[f"{prefix}.lstms.{i}.{dst}_l0"] = _t(layer[src])
                else:
                    out[f"{prefix}.lstm.{dst}_l{i}"] = _t(layer[src])
            if has_bn:
                for src, dst in _BN.items():
                    out[f"{prefix}.batch_norms.{i}.{dst}"] = _t(layer["bn"][src])
                out[f"{prefix}.batch_norms.{i}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.int64
                )
    out["prediction.embed.weight"] = _t(params["prediction"]["embed"])
    for src, dst in _LINEARS.items():
        out[f"{dst}.weight"] = _t(params[src]["w"])
        out[f"{dst}.bias"] = _t(params[src]["b"])
    return out


def lstm_layers_from_jax(layer_params: Sequence[Mapping]) -> List[Dict[str, torch.Tensor]]:
    """A list of JAX LSTM layer dicts (numpy ``w_ih`` [4H, I], ``w_hh``,
    ``b_ih``, ``b_hh``) -> the port's layer dicts, the same names and
    layouts (``ops/wavefront.run_lstm_stack_wavefront`` takes them). Raises
    on any other leaf."""
    out = []
    for i, layer in enumerate(layer_params):
        extra = set(layer) - set(_LSTM)
        if extra:
            raise ValueError(f"unknown leaves in layer {i}: {sorted(extra)}")
        out.append({k: _t(layer[k]) for k in _LSTM})
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a JAX parameter tree (numpy leaves) into ``model``, strictly."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def train_state_from_jax(model: torch.nn.Module, params: Mapping, ema_params: Mapping,
                         mu: Mapping, nu: Mapping, count: int, sched_count: int,
                         step: Optional[int] = None):
    """A JAX train state -> the port's ``TrainState`` around ``model``.

    ``params`` is loaded into ``model`` (its parameters become the state's
    master weights); ``ema_params`` and the Adam moments ``mu`` / ``nu``
    (numpy trees of the parameters' layout, as the caller takes them from
    the optax state) become fp32 tensors on the model's device; ``count``
    and ``sched_count`` are the Adam and schedule counts; ``step`` the taken
    steps (default: ``count``). The pruned loss's heads, where ``params``
    holds them, join the state's tree (fp32, requiring gradients) with their
    EMA and moments."""
    from caiman_asr_tpu_torch.training.optimizer import LambState
    from caiman_asr_tpu_torch.training.step import TrainState
    from caiman_asr_tpu_torch.training.tree import tree_map

    load_jax_params(model, params)
    tree = model.param_tree()
    dev = next(model.parameters()).device
    for top in TRAIN_ONLY:
        if top in params:
            tree[top] = {k: _t(v).to(dev, torch.float32).requires_grad_()
                         for k, v in params[top].items()}

    def like(src: Mapping):
        return tree_map(lambda p, a: _t(a).to(dev, torch.float32).reshape(p.shape), tree,
                        dict(src))

    return TrainState(tree, like(ema_params), LambState(like(mu), like(nu), int(count),
                                                        int(sched_count)),
                      int(count if step is None else step))


def rnnt_state_from_jax(state, *, device="cpu"):
    """A JAX ``RNNTState`` whose leaves are numpy arrays (as a resumed run's
    ``rsp/`` checkpoint leaves or a test give it) -> the port's
    ``RNNTState`` on ``device``, dtypes kept."""
    from caiman_asr_tpu_torch.models.state import EncoderState, PredNetState, RNNTState

    t = lambda a: _t(a).to(device)
    hc = lambda pair: (t(pair[0]), t(pair[1]))
    enc, pn = state.enc_state, state.pred_net_state
    return RNNTState(EncoderState(hc(enc.pre_rnn), hc(enc.post_rnn)),
                     PredNetState(hc(pn.next_to_last_pred_state), t(pn.last_token)))
