"""The RNN-T: an LSTM encoder (pre-stack layers, frames stacked in pairs,
post-stack layers, a projection), an LSTM predictor over the labels with a
zero start vector, and the joint ``W relu(f + g) + b``; the transducer loss
over the (t, u) lattice. Gate order i, f, g, o; weights under the names of
``weights.py``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import Precision

NEG = -1.0e30
JOINT_BLOCK_ROWS = 32768  # lattice rows a block of the joint holds at once


def _dropout(x, rate: float, gen: Optional[torch.Generator]):
    if rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def lstm_stack(w: Dict[str, torch.Tensor], prefix: str, layers: int, x: torch.Tensor,
               pr: Precision, dropout: float = 0.0, gen=None,
               state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """x [T, B, I] through ``layers`` LSTM layers: dropout between layers and
    on the output. Returns (out [T, B, H], (h, c) [L, B, H] after the last
    step)."""
    hs, cs = [], []
    out = x
    for i in range(layers):
        if i:
            out = _dropout(out, dropout, gen)
        w_ih, w_hh = w[f"{prefix}.weight_ih_l{i}"], w[f"{prefix}.weight_hh_l{i}"]
        b = w[f"{prefix}.bias_ih_l{i}"] + w[f"{prefix}.bias_hh_l{i}"]
        T, B, _ = out.shape
        H = w_hh.shape[1]
        gx = pr.mm(out.reshape(T * B, -1), w_ih.t()).reshape(T, B, 4 * H) + b
        h = out.new_zeros((B, H)) if state is None else state[0][i]
        c = out.new_zeros((B, H)) if state is None else state[1][i]
        w_hh_q = pr.q(w_hh.t())
        ys = []
        for t in range(T):
            g = gx[t] + pr.q(h) @ w_hh_q
            i_, f_, g_, o_ = g.chunk(4, dim=1)
            c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
            h = torch.sigmoid(o_) * torch.tanh(c)
            ys.append(h)
        out = torch.stack(ys)
        hs.append(h)
        cs.append(c)
    return _dropout(out, dropout, gen), (torch.stack(hs), torch.stack(cs))


def encode(w, rnnt: dict, feats: torch.Tensor, pr: Precision, gen=None, train=False,
           state=None):
    """feats [T, B, 240] -> f [B, ceil(T / 2), Hj] and the encoder's state
    (pre, post)."""
    drop = rnnt["enc_dropout"] if train else 0.0
    pre, pre_st = lstm_stack(w, "encoder.pre_rnn.lstm", rnnt["enc_pre_rnn_layers"], feats, pr,
                             drop, gen, None if state is None else state[0])
    k = rnnt["enc_stack_time_factor"]
    T = pre.shape[0]
    pad = (-T) % k
    pre = torch.nn.functional.pad(pre, (0, 0, 0, 0, 0, pad))
    stacked = pre.reshape((T + pad) // k, k, *pre.shape[1:]).permute(0, 2, 1, 3)
    stacked = stacked.reshape(stacked.shape[0], stacked.shape[1], -1)
    post, post_st = lstm_stack(w, "encoder.post_rnn.lstm", rnnt["enc_post_rnn_layers"], stacked,
                               pr, drop, gen, None if state is None else state[1])
    f = pr.mm(post.transpose(0, 1).reshape(-1, post.shape[2]), w["joint_enc.weight"].t())
    f = f.reshape(post.shape[1], post.shape[0], -1) + w["joint_enc.bias"]
    return f, (pre_st, post_st)


def predict(w, rnnt: dict, labels: torch.Tensor, pr: Precision, gen=None, train=False):
    """labels [B, U] -> g [B, U + 1, Hj]: a zero start vector, then each
    label's embedding."""
    emb = w["prediction.embed.weight"][labels.long()]
    x = torch.cat([emb.new_zeros((emb.shape[0], 1, emb.shape[2])), emb], 1).transpose(0, 1)
    out, _ = lstm_stack(w, "prediction.dec_rnn.lstm", rnnt["pred_rnn_layers"], x, pr,
                        rnnt["pred_dropout"] if train else 0.0, gen)
    g = pr.mm(out.transpose(0, 1).reshape(-1, out.shape[2]), w["joint_pred.weight"].t())
    return g.reshape(out.shape[1], out.shape[0], -1) + w["joint_pred.bias"]


def pred_step(w, rnnt: dict, token: Optional[torch.Tensor], state, pr: Precision):
    """One predictor step: token [B] (None: the zero start vector) from
    state (h, c) [L, B, Hp] -> (g [B, Hj], new state)."""
    h, c = state
    if token is None:
        x = h.new_zeros((h.shape[1], rnnt["pred_n_hid"]))
    else:
        x = w["prediction.embed.weight"][token.long()]
    out, st = lstm_stack(w, "prediction.dec_rnn.lstm", rnnt["pred_rnn_layers"], x[None], pr,
                         state=(h, c))
    g = pr.mm(out[0], w["joint_pred.weight"].t()) + w["joint_pred.bias"]
    return g, st


def joint_logits(w, f: torch.Tensor, g: torch.Tensor, pr: Precision) -> torch.Tensor:
    """f, g [..., Hj] broadcast -> logits [..., K]."""
    h = torch.relu(f + g)
    return pr.mm(h.reshape(-1, h.shape[-1]), w["joint_net.2.weight"].t()).reshape(
        *h.shape[:-1], -1) + w["joint_net.2.bias"]


def _block_scores(w_fc, b_fc, f_rows, g_rows, keep, labels, blank: int, rate: float,
                  pr: Precision):
    h = torch.relu(f_rows + g_rows)
    if keep is not None:
        h = torch.where(keep, h / (1.0 - rate), 0.0)
    logits = pr.mm(h, w_fc.t()) + b_fc
    lse = torch.logsumexp(logits, dim=1)
    return (logits[:, blank] - lse,
            logits.gather(1, labels[:, None])[:, 0] - lse)


def lattice_scores(w, f, g, labels, f_lens, u_lens, blank: int, pr: Precision,
                   dropout: float = 0.0, gen=None, pack_to=None):
    """(blank, label) log-probs [B, T, U + 1] at the valid positions (0
    elsewhere), the joint run over blocks of valid rows, each recomputed in
    the backward. Joint dropout draws one [rows, Hj] uniform: ``pack_to``
    rows holding the valid positions in (b, t, u) order, or (pack_to None)
    all B * T * (U + 1) positions."""
    B, T, Hj = f.shape
    U1 = g.shape[1]
    dev = f.device
    lab = torch.cat([labels.long(), labels.new_zeros((B, 1)).long()], 1)
    sizes = [(int(f_lens[b]), int(u_lens[b]) + 1) for b in range(B)]
    keep_all = None
    if dropout > 0.0 and gen is not None:
        rows = pack_to if pack_to is not None else B * T * U1
        keep_all = torch.rand((rows, Hj), generator=gen, device=dev) < 1.0 - dropout
    starts = [0]
    for tl, ul in sizes:
        starts.append(starts[-1] + tl * ul)
    if pack_to is not None and starts[-1] > pack_to:
        raise ValueError(f"{starts[-1]} valid positions past the {pack_to} packed rows")
    blank_lp = f.new_zeros((B * T * U1,))
    label_lp = f.new_zeros((B * T * U1,))
    i = 0
    while i < B:
        j, n = i, 0
        while j < B and (n == 0 or n + sizes[j][0] * sizes[j][1] <= JOINT_BLOCK_ROWS):
            n += sizes[j][0] * sizes[j][1]
            j += 1
        bi, ti, ui = [], [], []
        for b in range(i, j):
            tl, ul = sizes[b]
            tt, uu = torch.meshgrid(torch.arange(tl, device=dev), torch.arange(ul, device=dev),
                                    indexing="ij")
            bi.append(torch.full((tl * ul,), b, device=dev))
            ti.append(tt.reshape(-1))
            ui.append(uu.reshape(-1))
        bi, ti, ui = torch.cat(bi), torch.cat(ti), torch.cat(ui)
        flat = (bi * T + ti) * U1 + ui
        keep = None
        if keep_all is not None:
            row = (torch.arange(starts[i], starts[j], device=dev) if pack_to is not None
                   else flat)
            keep = keep_all[row]
        args = (w["joint_net.2.weight"], w["joint_net.2.bias"], f[bi, ti], g[bi, ui], keep,
                lab[bi, ui], blank, dropout, pr)
        if torch.is_grad_enabled():
            lb, ll = checkpoint(_block_scores, *args, use_reentrant=False)
        else:
            lb, ll = _block_scores(*args)
        blank_lp = blank_lp.index_put((flat,), lb)
        label_lp = label_lp.index_put((flat,), ll)
        i = j
    return blank_lp.reshape(B, T, U1), label_lp.reshape(B, T, U1)


def transducer_nll(blank_lp, label_lp, f_lens, u_lens) -> torch.Tensor:
    """-log P(y | x) [B] over the lattice: alpha[t, u] = LSE(alpha[t-1, u] +
    blank[t-1, u], alpha[t, u-1] + label[t, u-1]), each row solved as a
    cumulative log-sum-exp."""
    B, T, U1 = blank_lp.shape
    dev = blank_lp.device
    a_in = torch.full((B, U1), NEG, device=dev)
    a_in[:, 0] = 0.0
    alphas = []
    for t in range(T):
        s = torch.cat([a_in.new_zeros((B, 1)), torch.cumsum(label_lp[:, t, :-1], 1)], 1)
        alpha = s + torch.logcumsumexp(a_in - s, dim=1)
        alphas.append(alpha)
        a_in = alpha + blank_lp[:, t]
    alpha = torch.stack(alphas, 1)  # [B, T, U1]
    bix = torch.arange(B, device=dev)
    t_last, u_last = f_lens.long() - 1, u_lens.long()
    return -(alpha[bix, t_last, u_last] + blank_lp[bix, t_last, u_last])
