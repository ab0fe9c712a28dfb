"""Weights drawn from a seed on the device, under the reference torch
names of the published model (``encoder.pre_rnn.lstm.weight_ih_l0``,
``joint_net.2.weight``, ...), in float32.

The published initialisation: every LSTM tensor U(-1/sqrt(H), 1/sqrt(H)),
then the forget gate's input bias set to ``forget_gate_bias`` and its
hidden bias scaled by ``hidden_hidden_bias_scale``; the embedding N(0, 1);
each Linear's weight and bias U(-1/sqrt(in), 1/sqrt(in)). All the uniforms
come from one draw and all the normals from another, on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[str, tuple, str, float]]  # name, shape, kind, bound


def _lstm(prefix: str, n_in: int, H: int, layers: int) -> Layout:
    out = []
    b = 1.0 / math.sqrt(H)
    for i in range(layers):
        n = n_in if i == 0 else H
        out += [(f"{prefix}.weight_ih_l{i}", (4 * H, n), "u", b),
                (f"{prefix}.weight_hh_l{i}", (4 * H, H), "u", b),
                (f"{prefix}.bias_ih_l{i}", (4 * H,), "u", b),
                (f"{prefix}.bias_hh_l{i}", (4 * H,), "u", b)]
    return out


def _linear(prefix: str, n_in: int, n_out: int) -> Layout:
    b = 1.0 / math.sqrt(n_in)
    return [(f"{prefix}.weight", (n_out, n_in), "u", b), (f"{prefix}.bias", (n_out,), "u", b)]


def layout(rnnt: dict, n_classes: int) -> Layout:
    """Every tensor of the model: (name, shape, 'u' or 'n', bound)."""
    H, Hp, Hj = rnnt["enc_n_hid"], rnnt["pred_n_hid"], rnnt["joint_n_hid"]
    f = rnnt["enc_stack_time_factor"]
    return (_lstm("encoder.pre_rnn.lstm", rnnt["in_feats"], H, rnnt["enc_pre_rnn_layers"])
            + _lstm("encoder.post_rnn.lstm", f * H, H, rnnt["enc_post_rnn_layers"])
            + [("prediction.embed.weight", (n_classes - 1, Hp), "n", 1.0)]
            + _lstm("prediction.dec_rnn.lstm", Hp, Hp, rnnt["pred_rnn_layers"])
            + _linear("joint_enc", H, Hj) + _linear("joint_pred", Hp, Hj)
            + _linear("joint_net.2", Hj, n_classes))


def make_weights(rnnt: dict, n_classes: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed`` (any non-negative int below 2**64)."""
    lay = layout(rnnt, n_classes)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for _, s, k, _ in lay if k == "u")
    n_n = sum(math.prod(s) for _, s, k, _ in lay if k == "n")
    u = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device)
    out, iu, iz = {}, 0, 0
    for name, shape, kind, bound in lay:
        n = math.prod(shape)
        if kind == "u":
            out[name] = u[iu:iu + n].view(shape) * bound
            iu += n
        else:
            out[name] = z[iz:iz + n].view(shape).clone()
            iz += n
    fgb = rnnt.get("forget_gate_bias")
    hhs = rnnt.get("hidden_hidden_bias_scale", 0.0)
    if fgb is not None:
        for name, t in out.items():
            if ".bias_ih_l" in name or ".bias_hh_l" in name:
                H = t.shape[0] // 4
                if ".bias_ih_l" in name:
                    t[H:2 * H] = fgb
                else:
                    t[H:2 * H] *= hhs
    return out


def lr_group(name: str) -> str:
    """The learning-rate group of a tensor (the model's five modules)."""
    head = name.split(".")[0]
    return "joint_fc" if head == "joint_net" else head
