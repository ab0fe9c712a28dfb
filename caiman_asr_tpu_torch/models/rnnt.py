"""RNN-T model (encoder / prediction / joint) as an ``nn.Module``, mirroring
``caiman_asr_tpu/models/rnnt.py``.

  encoder:    pre_rnn (LSTM stack) -> StackTime(factor) -> post_rnn (LSTM
              stack) -> joint_enc Linear(H_enc -> H_joint)        [f: B,T,Hj]
  prediction: Embedding(n_classes-1) -> SOS prepend -> dec_rnn ->
              joint_pred Linear(H_pred -> H_joint)                [g: B,U+1,Hj]
  joint:      relu(f + g) -> joint_net.2 Linear(H_joint -> n_classes)

The blank token is the last index and has no embedding row. Parameter names
follow the reference torch model (``encoder.pre_rnn.lstm.weight_ih_l0``,
``joint_net.2.weight``, ...; batch-norm stacks use ``lstms.{i}`` and
``batch_norms.{i}``). Parameters stay in fp32; each call computes in the
dtype of its input, casting weights as the JAX package does.

``param_tree()`` gives the parameters in the JAX package's tree layout
(``{"encoder": {"pre_rnn": {"layer_0": {"w_ih", ...}}}, "joint_fc": {"w",
"b"}, ...}``), with the module's own tensors as leaves. The training entry
points (``enc_pred``) take such a tree explicitly, as the JAX functions take
``params``, so the train step can hand them compute-dtype copies of the fp32
master weights. The inference methods read the module's own parameters.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.state import EncoderState, PredNetState, RNNTState
from caiman_asr_tpu_torch.ops.features import stack_time
from caiman_asr_tpu_torch.ops.lstm import Params, dot_f32, lstm_step, run_lstm


class LSTMWeights(nn.Module):
    """An L-layer LSTM's parameters under ``torch.nn.LSTM``'s names."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, device):
        super().__init__()
        H = hidden_size
        for i in range(num_layers):
            in_size = input_size if i == 0 else H
            for name, shape in (
                ("weight_ih", (4 * H, in_size)), ("weight_hh", (4 * H, H)),
                ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,)),
            ):
                self.register_parameter(
                    f"{name}_l{i}", nn.Parameter(torch.empty(shape, device=device))
                )

    def layer(self, i: int) -> Params:
        return {
            "w_ih": getattr(self, f"weight_ih_l{i}"),
            "w_hh": getattr(self, f"weight_hh_l{i}"),
            "b_ih": getattr(self, f"bias_ih_l{i}"),
            "b_hh": getattr(self, f"bias_hh_l{i}"),
        }


class LSTMStack(nn.Module):
    """A stack of LSTM layers, with batch-norm after each layer when
    ``batch_norm`` (then one 1-layer LSTM per layer, as the reference)."""

    def __init__(self, input_size, hidden_size, num_layers, batch_norm, device):
        super().__init__()
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        if batch_norm:
            self.lstms = nn.ModuleList(
                LSTMWeights(input_size if i == 0 else hidden_size, hidden_size, 1, device)
                for i in range(num_layers)
            )
            self.batch_norms = nn.ModuleList(
                nn.BatchNorm1d(hidden_size, device=device) for _ in range(num_layers)
            )
        else:
            self.lstm = LSTMWeights(input_size, hidden_size, num_layers, device)

    def params(self) -> Params:
        """The stack as ``{"layer_i": {...}}`` for ``ops/lstm.py``."""
        out = {}
        for i in range(self.num_layers):
            if self.batch_norm:
                bn = self.batch_norms[i]
                out[f"layer_{i}"] = dict(
                    self.lstms[i].layer(0),
                    bn={"scale": bn.weight, "bias": bn.bias,
                        "mean": bn.running_mean, "var": bn.running_var},
                )
            else:
                out[f"layer_{i}"] = self.lstm.layer(i)
        return out


def _node(lin: nn.Linear) -> Params:
    return {"w": lin.weight, "b": lin.bias}


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A Linear over a {"w" [out, in], "b" [out]} tree node, in x's dtype."""
    return (dot_f32(x, p["w"].t()) + p["b"].float()).to(x.dtype)


class RNNT(nn.Module):
    """RNN-T model for inference. Built on ``device`` ("cuda" unless the
    caller asks for "cpu"); weights come from :meth:`init_weights` or
    ``export/from_jax.load_jax_params``."""

    def __init__(self, config: RNNTModelConfig, n_classes: int, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        self.cfg = cfg
        self.n_classes = n_classes
        self.encoder = nn.ModuleDict({
            "pre_rnn": LSTMStack(cfg.in_feats, cfg.enc_n_hid, cfg.enc_pre_rnn_layers,
                                 cfg.enc_batch_norm, dev),
            "post_rnn": LSTMStack(cfg.enc_stack_time_factor * cfg.enc_n_hid,
                                  cfg.enc_n_hid, cfg.enc_post_rnn_layers,
                                  cfg.enc_batch_norm, dev),
        })
        self.prediction = nn.ModuleDict({
            "embed": nn.Embedding(n_classes - 1, cfg.pred_n_hid, device=dev),
            "dec_rnn": LSTMStack(cfg.pred_n_hid, cfg.pred_n_hid, cfg.pred_rnn_layers,
                                 cfg.pred_batch_norm, dev),
        })
        self.joint_enc = nn.Linear(cfg.enc_n_hid, cfg.joint_n_hid, device=dev)
        self.joint_pred = nn.Linear(cfg.pred_n_hid, cfg.joint_n_hid, device=dev)
        # the reference's layout: ReLU, dropout, Linear (only index 2 has weights)
        self.joint_net = nn.Sequential(
            nn.ReLU(), nn.Dropout(cfg.joint_dropout),
            nn.Linear(cfg.joint_n_hid, n_classes, device=dev),
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RNNT":
        """Draw every weight from ``generator`` with the JAX package's init
        distributions: LSTMs U(-1/sqrt(H), 1/sqrt(H)) times
        ``weights_init_scale`` with the forget-gate bias policy, Linears
        U(-1/sqrt(in), 1/sqrt(in)), the embedding N(0, 1)."""
        cfg = self.cfg

        def draw(p, fn):
            p.copy_(fn(p.shape))

        def uniform(bound):
            return lambda shape: (
                torch.rand(shape, generator=generator, device=generator.device) * 2 - 1
            ) * bound

        stacks = (self.encoder["pre_rnn"], self.encoder["post_rnn"],
                  self.prediction["dec_rnn"])
        for stack in stacks:
            for layer in stack.params().values():
                H = layer["w_hh"].shape[1]
                for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                    draw(layer[k], uniform(1.0 / math.sqrt(H)))
                    layer[k].mul_(cfg.weights_init_scale)
                if cfg.forget_gate_bias is not None:
                    layer["b_ih"][H:2 * H] = cfg.forget_gate_bias
                    layer["b_hh"][H:2 * H] *= cfg.hidden_hidden_bias_scale
                if "bn" in layer:
                    layer["bn"]["scale"].fill_(1.0)
                    layer["bn"]["bias"].zero_()
                    layer["bn"]["mean"].zero_()
                    layer["bn"]["var"].fill_(1.0)
        draw(self.prediction["embed"].weight, lambda shape: torch.randn(
            shape, generator=generator, device=generator.device))
        for lin in (self.joint_enc, self.joint_pred, self.joint_net[2]):
            bound = 1.0 / math.sqrt(lin.in_features)
            draw(lin.weight, uniform(bound))
            draw(lin.bias, uniform(bound))
        return self

    def param_tree(self) -> Params:
        """The parameters (and eval batch-norm statistics) in the JAX
        package's tree layout; the leaves are this module's tensors."""
        return {
            "encoder": {"pre_rnn": self.encoder["pre_rnn"].params(),
                        "post_rnn": self.encoder["post_rnn"].params()},
            "prediction": {"embed": self.prediction["embed"].weight,
                           "dec_rnn": self.prediction["dec_rnn"].params()},
            "joint_enc": _node(self.joint_enc),
            "joint_pred": _node(self.joint_pred),
            "joint_fc": _node(self.joint_net[2]),
        }

    def param_lr_factors(self) -> Dict[str, float]:
        """Per-module learning-rate factors, keyed like ``param_tree``."""
        cfg = self.cfg
        return {
            "encoder": cfg.enc_lr_factor,
            "prediction": cfg.pred_lr_factor,
            "joint_enc": cfg.joint_enc_lr_factor,
            "joint_pred": cfg.joint_pred_lr_factor,
            "joint_fc": cfg.joint_net_lr_factor,
        }

    @property
    def has_batch_norm(self) -> bool:
        return self.cfg.enc_batch_norm or self.cfg.pred_batch_norm

    @staticmethod
    def _bn_layers(params: Params):
        """(path, layer) of every batch-norm layer of ``params`` in the JAX
        traversal order: encoder.pre_rnn, encoder.post_rnn, prediction.dec_rnn,
        each by layer index."""
        for top, name in (("encoder", "pre_rnn"), ("encoder", "post_rnn"),
                          ("prediction", "dec_rnn")):
            stack = params[top][name]
            for i in range(len(stack)):
                layer = stack[f"layer_{i}"]
                if "bn" in layer:
                    yield (top, name, f"layer_{i}", "bn"), layer["bn"]

    def bn_stats(self, params: Params) -> tuple:
        """The running (mean, var) of every batch-norm layer, in the order
        ``enc_pred``'s ``bn_updates`` fills and :meth:`apply_bn_updates`
        takes."""
        return tuple((bn["mean"], bn["var"]) for _, bn in self._bn_layers(params))

    def bn_stat_paths(self, params: Params) -> list:
        """The tree paths of :meth:`bn_stats`' leaves, as (mean, var) pairs."""
        return [(path + ("mean",), path + ("var",)) for path, _ in self._bn_layers(params)]

    def apply_bn_updates(self, params: Params, updates) -> Params:
        """A tree like ``params`` (containers copied, leaves shared) whose
        running stats are ``updates``, (mean, var) pairs in :meth:`bn_stats`'
        order."""
        params = _copy_containers(params)
        layers = list(self._bn_layers(params))
        if len(layers) != len(updates):
            raise ValueError(f"{len(updates)} batch-norm updates for {len(layers)} layers")
        for (path, bn), (mean, var) in zip(layers, updates):
            params[path[0]][path[1]][path[2]]["bn"] = dict(bn, mean=mean, var=var)
        return params

    # ----------------------------------------------------------- encode
    def _encode(self, p: Params, x, x_lens, enc_state=None, *, train=False, generator=None,
                bn_updates=None):
        cfg = self.cfg
        kw = dict(hard=cfg.hard_activations, quantize=cfg.quantize, train=train,
                  dropout=cfg.enc_dropout, rw_dropout=cfg.enc_rw_dropout,
                  generator=generator, bn_updates=bn_updates)
        out, _, (all_h0, all_c0) = run_lstm(
            p["encoder"]["pre_rnn"], x,
            enc_state.pre_rnn if enc_state is not None else None, **kw,
        )
        pre_state = _last_nonpadded_state(all_h0, all_c0, x_lens)
        out, out_lens = stack_time(out, x_lens, cfg.enc_stack_time_factor)
        out, _, (all_h1, all_c1) = run_lstm(
            p["encoder"]["post_rnn"], out,
            enc_state.post_rnn if enc_state is not None else None, **kw,
        )
        post_state = _last_nonpadded_state(all_h1, all_c1, out_lens)
        f = _linear(p["joint_enc"], out.transpose(0, 1))
        if cfg.enc_freeze:
            f = f.detach()
        return f, out_lens, EncoderState(pre_rnn=pre_state, post_rnn=post_state)

    @torch.no_grad()
    def encode(
        self,
        x: torch.Tensor,
        x_lens: torch.Tensor,
        enc_state: Optional[EncoderState] = None,
        *,
        params: Optional[Params] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, EncoderState]:
        """x: [T, B, in_feats] time-major; x_lens: [B]. Returns (f [B, T', Hj],
        f_lens [B], state), the state being every layer's (h, c) at each
        utterance's last non-padded frame. ``params``: a tree as
        :meth:`param_tree` gives (default: this module's own), e.g. the
        streaming engine's copies in its compute dtype."""
        return self._encode(self.param_tree() if params is None else params, x, x_lens,
                            enc_state)

    # ---------------------------------------------------------- predict
    def _predict(self, p: Params, y, pred_state=None, *, add_sos=True, special_sos=None,
                 sos_gate=None, batch_size=1, train=False, generator=None, bn_updates=None):
        cfg = self.cfg
        embed = p["prediction"]["embed"]
        if y is not None:
            emb = embed[y.long()]
        else:
            B = batch_size if pred_state is None else pred_state[0].shape[1]
            emb = embed.new_zeros((B, 1, cfg.pred_n_hid))
        if add_sos:
            B = emb.shape[0]
            if special_sos is None:
                start = emb.new_zeros((B, 1, cfg.pred_n_hid))
            else:
                start = embed[torch.clamp(special_sos.reshape(B, 1).long(), 0, embed.shape[0] - 1)]
                if sos_gate is not None:
                    start = start * sos_gate.reshape(B, 1, 1).to(start.dtype)
            emb = torch.cat([start, emb], dim=1)
        out, hid, all_hid = run_lstm(
            p["prediction"]["dec_rnn"], emb.transpose(0, 1), pred_state,
            hard=cfg.hard_activations, quantize=cfg.quantize, train=train,
            dropout=cfg.pred_dropout, rw_dropout=cfg.pred_rw_dropout, generator=generator,
            bn_updates=bn_updates,
        )
        return _linear(p["joint_pred"], out.transpose(0, 1)), hid, all_hid

    @torch.no_grad()
    def predict(
        self,
        y: Optional[torch.Tensor],
        pred_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        *,
        add_sos: bool = True,
        special_sos: Optional[torch.Tensor] = None,
        sos_gate: Optional[torch.Tensor] = None,
        batch_size: int = 1,
    ):
        """Prediction network over labels y [B, U] (None: a lone zero-vector
        SOS step). Returns (g [B, U+1, Hj], final (h, c) [L, B, Hp],
        all (h, c) [L, U+1, B, Hp]). ``sos_gate`` [B] 0/1 selects per sample
        between the embedded ``special_sos`` (1) and the zero SOS (0)."""
        return self._predict(self.param_tree(), y, pred_state, add_sos=add_sos,
                             special_sos=special_sos, sos_gate=sos_gate,
                             batch_size=batch_size)

    # ---------------------------------------------------------- forward
    def enc_pred(
        self,
        x: torch.Tensor,
        x_lens: torch.Tensor,
        y: torch.Tensor,
        y_lens: torch.Tensor,
        rnnt_state: Optional[RNNTState] = None,
        *,
        state_gate: Optional[torch.Tensor] = None,
        params: Optional[Params] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        bn_updates: Optional[list] = None,
    ):
        """Encoder and prediction nets over a whole batch
        (``caiman_asr_tpu/models/rnnt.py:316-372``).

        x: [T, B, in_feats]; y: [B, U] labels. ``params`` is a tree as
        :meth:`param_tree` gives (default: this module's own), e.g. the
        train step's compute-dtype copies. With ``train`` the configured
        dropouts are drawn from ``generator`` and batch-norm layers use the
        batch's statistics, appended to ``bn_updates`` when given.
        Differentiable.

        ``rnnt_state`` is the streaming state carried from the previous
        segment (random state passing; detached where it enters the LSTMs),
        ``state_gate`` [B] 0/1 per sample: 0 zeroes that sample's h and c
        and its re-embedded last token, as if it had no state. Returns
        ((f [B, T', Hj], f_lens), (g [B, U+1, Hj], g_lens = y_lens + 1),
        new_state): the encoder's (h, c) at each utterance's last frame and
        the predictor's state before its last label, with that label.
        """
        p = self.param_tree() if params is None else params
        enc_state = rnnt_state.enc_state if rnnt_state is not None else None
        pn_state = rnnt_state.pred_net_state if rnnt_state is not None else None
        if state_gate is not None and rnnt_state is not None:
            gate = state_gate.float()
            zero_hc = lambda hc: tuple(h * gate[None, :, None].to(h.dtype) for h in hc)
            enc_state = EncoderState(zero_hc(enc_state.pre_rnn), zero_hc(enc_state.post_rnn))
            pn_state = PredNetState(zero_hc(pn_state.next_to_last_pred_state),
                                    pn_state.last_token)
        f, f_lens, new_enc_state = self._encode(p, x, x_lens, enc_state, train=train,
                                                generator=generator, bn_updates=bn_updates)
        g, _, all_pred_hid = self._predict(
            p, y, pn_state.next_to_last_pred_state if pn_state is not None else None,
            special_sos=pn_state.last_token if pn_state is not None else None,
            sos_gate=state_gate, train=train, generator=generator, bn_updates=bn_updates)
        new_state = RNNTState(new_enc_state, _get_pred_net_state(y, all_pred_hid, y_lens))
        return (f, f_lens), (g, y_lens + 1), new_state

    @torch.no_grad()
    def pred_step(
        self,
        token: Optional[torch.Tensor],
        state: Tuple[torch.Tensor, torch.Tensor],
        *,
        params: Optional[Params] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One prediction-net step: token [B] (None: zero-vector SOS),
        state (h, c) [L, B, Hp]. Returns (g [B, Hj], new state). ``params``
        as for :meth:`encode`."""
        p = self.param_tree() if params is None else params
        embed = p["prediction"]["embed"]
        h, c = state
        if token is None:
            emb = embed.new_zeros((h.shape[1], self.cfg.pred_n_hid))
        else:
            emb = embed[torch.clamp(token.long(), 0, embed.shape[0] - 1)]
        y, h_new, c_new = lstm_step(
            p["prediction"]["dec_rnn"], emb, h, c,
            hard=self.cfg.hard_activations, quantize=self.cfg.quantize,
        )
        return _linear(p["joint_pred"], y), (h_new, c_new)

    # ------------------------------------------------------------ joint
    @torch.no_grad()
    def joint(self, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Dense joint: f [B, T, Hj], g [B, U+1, Hj] -> logits [B, T, U+1, K]."""
        return _linear(_node(self.joint_net[2]), torch.relu(f[:, :, None, :] + g[:, None, :, :]))

    @torch.no_grad()
    def joint_step(self, f: torch.Tensor, g: torch.Tensor, *,
                   params: Optional[Params] = None) -> torch.Tensor:
        """Single-frame joint: f, g [B, Hj] -> logits [B, K]. ``params`` as
        for :meth:`encode`."""
        p = _node(self.joint_net[2]) if params is None else params["joint_fc"]
        return _linear(p, torch.relu(f + g))


def _copy_containers(tree: Params) -> Params:
    return {k: _copy_containers(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _get_pred_net_state(y, all_pred_hid, y_lens) -> PredNetState:
    """The predictor's state to carry into the next segment: (h, c) before
    the last label (position y_len - 1 of the SOS-prefixed sequence), and
    that label [B, 1], re-embedded there as the start of the sequence."""
    all_h, all_c = all_pred_hid  # [L, U+1, B, H]
    idx = torch.clamp(y_lens.long() - 1, min=0)
    bix = torch.arange(all_h.shape[2], device=all_h.device)
    return PredNetState((all_h[:, idx, bix], all_c[:, idx, bix]), y.gather(1, idx[:, None]))


def _last_nonpadded_state(all_h, all_c, lens):
    """Per-sample state at t = len - 1. all_h, all_c: [L, T, B, H] -> [L, B, H]."""
    idx = torch.clamp(lens.long() - 1, min=0)
    bix = torch.arange(all_h.shape[2], device=all_h.device)
    return all_h[:, idx, bix], all_c[:, idx, bix]
