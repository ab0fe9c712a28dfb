"""The pruned two-stage transducer loss (the port of
``caiman_asr_tpu/ops/pruned_loss.py``; Kuang et al., "Pruned RNN-T for fast,
memory-efficient ASR training", Interspeech 2022).

1. The simple loss: a factored joint ``z[t, u, k] = am[t, k] + lm[u, k]``
   from two training-only heads (``init_simple_params``). Its normaliser is
   one batched product::

       LSE_k(am[t] + lm[u]) = amax[t] + lmax[u]
                            + log(exp(am[t] - amax[t]) . exp(lm[u] - lmax[u]))

   (``simple_lattice_scores``); the per-cell scores feed the dense lattice
   of ``ops/transducer_loss.rnnt_lattice``. The scores are derived again
   in the backward (``SimpleScores``, the counterpart of
   ``jax.checkpoint``), so the [B, T, K] head outputs are not kept.
2. The bounds: the simple lattice's emit posteriors (``emit_posteriors``,
   or under a gradient the lattice's own backward, ``simple_ranges``)
   give, per frame, a window of S labels ``[s_t, s_t + S)``, monotone in t
   with steps of at most S - 1, pinned to 0 at t = 0 and covering u = U at
   the last valid frame (``prune_ranges``, integers).
3. The banded loss: the real joint on the B * T * S banded rows only
   (``pruned_transducer_loss_from_fg``), through the fused joint + LSE
   (``ops/joint_kernel.fused_joint_lse``: K5-store / K2 forward and the
   backward of its store plan) when ``Hj % 128 == 0`` or under a model group
   (``parallel/vocab_parallel.vp_joint_lse``), else through plain logits,
   as the JAX package routes it. The banded lattice
   (``banded_rnnt_lattice``) is the dense one in band coordinates, the
   blank edge shifting by ``d_t = s_t - s_{t-1}``; its backward is the
   closed-form edge posterior.

The objective is ``simple_scale * simple + pruned`` (icefall's). The three
lattices are plain code in the JAX package (``lax.scan``), so plain PyTorch
here: a Python loop over T each.

Under a model group (the JAX package's ``vocab_axis``) the heads, ``w_fc``
and ``b_fc`` are this rank's vocab shard; the simple normaliser's maxima are
max-reduced and its sums and gathered logits summed over the group
(``PsumKeepCt``), and f and g enter the simple stage through ``IdentPsumCt``
(``pruned_loss.py:82-111``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from caiman_asr_tpu_torch.ops.transducer_loss import (
    NEG_INF,
    LossModifiers,
    _joint_dropout,
    _joint_lse,
    _lab_padded,
    _lattice_alpha_beta,
    _masked_scores,
    _penalised_scores,
    _row_update_bwd,
    _row_update_fwd,
    rnnt_lattice,
)
from caiman_asr_tpu_torch.parallel.mesh import IdentPsumCt, PsumKeepCt
from caiman_asr_tpu_torch.parallel.vocab_parallel import shard_relative_ids

_psum_keep_ct = PsumKeepCt.apply
_ident_psum_ct = IdentPsumCt.apply


# ----------------------------------------------------------------- stage 1
def init_simple_params(generator: torch.Generator, joint_hid: int, n_classes: int):
    """The training-only heads ``simple_am`` / ``simple_lm``, each
    ``{"w": [K, Hj] uniform(+-1/sqrt(Hj)), "b": zeros [K]}`` fp32 on the
    generator's device, requiring gradients. They live in the train state's
    tree, not in the RNN-T module, and serving drops them."""
    scale = 1.0 / math.sqrt(joint_hid)
    dev = generator.device

    def head():
        w = torch.rand((n_classes, joint_hid), generator=generator, device=dev)
        return {"w": (w * (2 * scale) - scale).requires_grad_(),
                "b": torch.zeros((n_classes,), device=dev).requires_grad_()}

    return {"simple_am": head(), "simple_lm": head()}


def simple_lattice_scores(am, lm, labels, blank_idx: int, model_group=None):
    """(lp_blank, lp_label) [B, T, U+1] of the factored joint: am [B, T, K],
    lm [B, U+1, K], labels [B, U]. Under ``model_group`` am and lm are the
    local vocab shard and ``blank_idx`` / labels global ids."""
    am, lm = am.float(), lm.float()
    B, T, Kl = am.shape
    U1 = lm.shape[1]
    # the offsets are for stability only: no gradient through them
    amax = am.detach().amax(-1)
    lmax = lm.detach().amax(-1)
    if model_group is not None:
        both = torch.cat([amax.reshape(-1), lmax.reshape(-1)])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=model_group)
        amax, lmax = both[:amax.numel()].view_as(amax), both[amax.numel():].view_as(lmax)
    ea = torch.exp(am - amax[..., None])
    el = torch.exp(lm - lmax[..., None])
    ssum = torch.einsum("btk,buk->btu", ea, el)

    lab = _lab_padded(labels)  # [B, U+1]
    if model_group is None:
        am_y = am.gather(2, lab[:, None, :].expand(B, T, U1))
        lm_y = lm.gather(2, lab[:, :, None])[..., 0]
        am_b, lm_b = am[..., blank_idx], lm[..., blank_idx]
    else:
        k_off = dist.get_rank(model_group) * Kl
        lab_in, lab_c = shard_relative_ids(lab, k_off, Kl)
        am_y = torch.where(lab_in[:, None, :], am.gather(2, lab_c[:, None, :].expand(B, T, U1)),
                           0.0)
        lm_y = torch.where(lab_in, lm.gather(2, lab_c[:, :, None])[..., 0], 0.0)
        blank_in, blank_c = shard_relative_ids(blank_idx, k_off, Kl)
        am_b = am[..., blank_c] if blank_in else am.new_zeros((B, T))
        lm_b = lm[..., blank_c] if blank_in else lm.new_zeros((B, U1))
        ssum, am_y, lm_y, am_b, lm_b = _psum_keep_ct(model_group, ssum, am_y, lm_y, am_b,
                                                     lm_b)
    norm = torch.log(torch.clamp(ssum, min=1e-30)) + amax[:, :, None] + lmax[:, None, :]
    lp_label = am_y + lm_y[:, None, :] - norm
    lp_blank = am_b[:, :, None] + lm_b[:, None, :] - norm
    return lp_blank, lp_label


# ----------------------------------------------------------------- stage 2
@torch.no_grad()
def emit_posteriors(null, emit, t_lens, u_lens):
    """Emit-edge occupation probabilities [B, T, U+1] of the masked lattice:
    the dense backward's ``post_emit`` without a gradient."""
    nullm, emitm, seed = _masked_scores(null.float(), emit.float(), t_lens, u_lens)
    alpha, beta = _lattice_alpha_beta(nullm, emitm, seed)
    beta00 = beta[:, 0, 0][:, None, None]
    beta_right = torch.cat([beta[:, :, 1:], torch.full_like(beta[:, :, :1], NEG_INF)], dim=2)
    return torch.exp(torch.clamp(alpha + emitm + beta_right - beta00, NEG_INF, 0.0))


@torch.no_grad()
def prune_ranges(y_grad, t_lens, u_lens, S: int):
    """Monotone width-S label windows: the start s_t [B, T] int64 of each
    frame's window (``pruned_loss.py:232-276``). Each frame starts at the
    window holding the most emit-posterior mass, projected onto
    0 <= s_t <= max(0, u_len + 1 - S), s_0 = 0, steps of 0 to S - 1, and the
    last valid frame's window (and every later frame's) holding u = u_len."""
    B, T, U1 = y_grad.shape
    dev = y_grad.device
    y = torch.where(torch.isfinite(y_grad), y_grad, 0.0)
    cs = torch.cumsum(torch.nn.functional.pad(y, (1, S)), dim=2)
    ws = cs[:, :, S:S + U1] - cs[:, :, :U1]  # the mass of the window at s
    best = torch.argmax(ws, dim=2)  # the first of equal maxima, as jnp.argmax
    smax = torch.clamp(u_lens.long() + 1 - S, min=0)[:, None]  # [B, 1]
    best = torch.minimum(torch.clamp(best, min=0), smax)
    t_ix = torch.arange(T, device=dev)[None, :]
    last = torch.clamp(t_lens.long() - 1, min=0)[:, None]
    best = torch.where(t_ix >= last, smax, best)
    best = torch.where(t_ix == 0, 0, best)
    # forward projection: non-decreasing, steps of at most S - 1
    s_fwd = torch.empty_like(best)
    prev = torch.zeros((B,), dtype=best.dtype, device=dev)
    for t in range(T):
        prev = torch.minimum(torch.maximum(best[:, t], prev), prev + (S - 1))
        s_fwd[:, t] = prev
    # backward projection: the pinned end stays reachable
    s = torch.empty_like(best)
    nxt = s_fwd[:, T - 1]
    for t in reversed(range(T)):
        nxt = torch.minimum(torch.maximum(s_fwd[:, t], nxt - (S - 1)), nxt)
        s[:, t] = nxt
    s = torch.where(t_ix == 0, 0, s)
    return torch.minimum(torch.clamp(s, min=0), smax)


# ----------------------------------------------------------------- stage 3
def _band_shift(row, d):
    """out[..., j] = row[..., j + d] with out-of-range positions NEG_INF;
    row [..., S], d [...] integer (may be negative)."""
    S = row.shape[-1]
    src = torch.arange(S, device=row.device) + d[..., None]
    out = row.gather(-1, src.clamp(0, S - 1))
    return torch.where((src >= 0) & (src < S), out, NEG_INF)


def _banded_masked_scores(null, emit, ranges, t_lens, u_lens):
    """The masking of ``_masked_scores`` in band coordinates: null / emit
    [B, T, S] at u = ranges[b, t] + j. Valid rows (t < t_len) keep null where
    u <= u_len and emit where u < u_len; padded rows pass through (null 0,
    emit NEG_INF). Seed: 0 at the j with ranges[last] + j == u_len."""
    B, T, S = null.shape
    dev = null.device
    t_ix = torch.arange(T, device=dev)[None, :, None]
    u_ix = ranges[:, :, None] + torch.arange(S, device=dev)[None, None, :]
    F = t_lens.long()[:, None, None]
    UL = u_lens.long()[:, None, None]
    in_t = t_ix < F
    nullm = torch.where(in_t, torch.where(u_ix <= UL, null, NEG_INF), 0.0)
    emitm = torch.where(in_t & (u_ix < UL), emit, NEG_INF)
    last = torch.clamp(t_lens.long() - 1, min=0)
    s_last = ranges.gather(1, last[:, None])  # [B, 1]
    j_row = torch.arange(S, device=dev)[None, :]
    seed = torch.where(s_last + j_row == u_lens.long()[:, None], 0.0, NEG_INF)
    return nullm, emitm, seed


def _banded_alpha_beta(nullm, emitm, seed, d):
    """alpha and beta [B, T, S] fp32 of the banded lattice; d [B, T] the band
    shifts (d[:, 0] = 0)."""
    B, T, S = nullm.shape
    init = torch.full((B, S), NEG_INF, device=nullm.device)
    init[:, 0] = 0.0
    alphas = [_row_update_fwd(init, emitm[:, 0])]
    for t in range(1, T):
        # the blank edge (t-1, u) -> (t, u): band coordinates j <- j + d_t
        b = _band_shift(alphas[-1] + nullm[:, t - 1], d[:, t])
        alphas.append(_row_update_fwd(b, emitm[:, t]))
    betas = [None] * T
    b_next = seed  # the virtual row T, reached with d = 0
    zero = torch.zeros_like(d[:, 0])
    for t in reversed(range(T)):
        d_next = d[:, t + 1] if t + 1 < T else zero
        b_next = _row_update_bwd(nullm[:, t] + _band_shift(b_next, -d_next), emitm[:, t])
        betas[t] = b_next
    return torch.stack(alphas, 1), torch.stack(betas, 1)


class BandedRNNTLattice(torch.autograd.Function):
    """Per-sample NLL [B] of the banded lattice; the backward is the closed
    form edge posterior (``pruned_loss.py:366-422``)."""

    @staticmethod
    def forward(ctx, null, emit, ranges, t_lens, u_lens):
        nullm, emitm, seed = _banded_masked_scores(null.float(), emit.float(), ranges, t_lens,
                                                   u_lens)
        d = torch.diff(ranges, dim=1, prepend=ranges[:, :1])
        alpha, beta = _banded_alpha_beta(nullm, emitm, seed, d)
        ctx.save_for_backward(nullm, emitm, seed, alpha, beta, d, t_lens)
        return -beta[:, 0, 0]

    @staticmethod
    def backward(ctx, ct):
        nullm, emitm, seed, alpha, beta, d, t_lens = ctx.saved_tensors
        B, T, S = nullm.shape
        beta00 = beta[:, 0, 0][:, None, None]
        # beta at the blank edge's end (t+1, same u) in row t's coordinates;
        # the virtual row T is the seed
        d_next = torch.cat([d[:, 1:], torch.zeros_like(d[:, :1])], dim=1)
        beta_rows = torch.cat([beta[:, 1:], seed[:, None, :]], dim=1)
        beta_next = _band_shift(beta_rows, -d_next)
        beta_right = torch.cat([beta[:, :, 1:], torch.full_like(beta[:, :, :1], NEG_INF)], dim=2)
        post_null = torch.exp(torch.clamp(alpha + nullm + beta_next - beta00, NEG_INF, 0.0))
        post_emit = torch.exp(torch.clamp(alpha + emitm + beta_right - beta00, NEG_INF, 0.0))
        # padded (pass-through) rows take no gradient
        valid = torch.arange(T, device=nullm.device)[None, :, None] < t_lens.long()[:, None, None]
        ctb = ct[:, None, None]
        return (torch.where(valid, -ctb * post_null, 0.0),
                torch.where(valid, -ctb * post_emit, 0.0), None, None, None)


def banded_rnnt_lattice(null, emit, ranges, t_lens, u_lens):
    """-log P(the paths inside the band) [B]: null / emit [B, T, S] the blank
    and label log-probs at u = ranges[b, t] + j. A band over the whole
    lattice (S >= U + 1) gives ``rnnt_lattice``'s value."""
    return BandedRNNTLattice.apply(null, emit, ranges, t_lens, u_lens)


# ------------------------------------------------------------- the objective
def _head(x, w, b):
    """x [B, L, Hj] through a simple head (w [K, Hj], b [K]): bf16 operands,
    fp32 products (``preferred_element_type=float32``), the fp32 bias added."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t() + b.float()


def _simple_scores(f, g, am_w, am_b, lm_w, lm_b, labels, blank_idx: int, model_group=None):
    """The factored joint's (lp_blank, lp_label) [B, T, U+1] from f, g and
    the heads. Under ``model_group`` f and g take the sum of each shard's
    cotangent (``IdentPsumCt``)."""
    if model_group is not None:
        f = _ident_psum_ct(f, model_group)
        g = _ident_psum_ct(g, model_group)
    return simple_lattice_scores(_head(f, am_w, am_b), _head(g, lm_w, lm_b), labels, blank_idx,
                                 model_group)


class SimpleScores(torch.autograd.Function):
    """``_simple_scores`` whose backward derives them again from its inputs,
    as ``jax.checkpoint`` does: the [B, T, K] head outputs are not kept.
    (``torch.utils.checkpoint`` does the same, but imports ``torch._dynamo``
    at its first call, seconds of a process's first step.)"""

    @staticmethod
    def forward(ctx, f, g, am_w, am_b, lm_w, lm_b, labels, blank_idx: int, model_group):
        ctx.save_for_backward(f, g, am_w, am_b, lm_w, lm_b, labels)
        ctx.blank_idx, ctx.model_group = blank_idx, model_group
        with torch.no_grad():
            return _simple_scores(f, g, am_w, am_b, lm_w, lm_b, labels, blank_idx, model_group)

    @staticmethod
    def backward(ctx, ct_blank, ct_label):
        *floats, labels = ctx.saved_tensors
        floats = [t.detach().requires_grad_(need)
                  for t, need in zip(floats, ctx.needs_input_grad[:6])]
        with torch.enable_grad():
            outs = _simple_scores(*floats, labels, ctx.blank_idx, ctx.model_group)
        wanted = [t for t in floats if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, (ct_blank, ct_label), allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in floats), None, None, None)


def _simple_stage(f, g, am_w, am_b, lm_w, lm_b, labels, t_lens, u_lens, blank_idx: int,
                  mods: LossModifiers, model_group=None):
    """(simple loss [B], its null and emit scores). The scores are derived
    again in the backward (``SimpleScores``), not kept (JAX checkpoints the
    whole stage, its lattice too: here the lattice's loop over T is the
    cost, and it keeps only [B, T, U+1] residuals)."""
    lp_blank, lp_label = SimpleScores.apply(f, g, am_w, am_b, lm_w, lm_b, labels, blank_idx,
                                            model_group)
    null_s, emit_s = _penalised_scores(lp_blank, lp_label, labels, t_lens, mods)
    return rnnt_lattice(null_s, emit_s, t_lens, u_lens), null_s, emit_s


def simple_ranges(simple, null_s, emit_s, t_lens, u_lens, S: int):
    """The windows of ``prune_ranges`` from the simple stage. Under a
    gradient the emit posteriors are minus the simple loss's gradient in its
    emit scores, which the lattice's closed-form backward gives without a
    second pass over T; else ``emit_posteriors``. The two are the same
    expression of the same alpha and beta."""
    if simple.requires_grad:
        (g_emit,) = torch.autograd.grad(simple.sum(), emit_s, retain_graph=True)
        posteriors = -g_emit
    else:
        posteriors = emit_posteriors(null_s, emit_s, t_lens, u_lens)
    return prune_ranges(posteriors, t_lens, u_lens, S)


def pruned_transducer_loss_from_fg(
    f: torch.Tensor,
    g: torch.Tensor,
    w_fc: torch.Tensor,
    b_fc: torch.Tensor,
    simple_params,
    labels: torch.Tensor,
    t_lens: torch.Tensor,
    u_lens: torch.Tensor,
    blank_idx: int,
    mods: LossModifiers = LossModifiers(),
    prune_range: int = 5,
    simple_scale: float = 0.5,
    *,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    model_group=None,
) -> torch.Tensor:
    """The two-stage pruned loss, per utterance [B]:
    ``simple_scale * simple + pruned``.

    f [B, T, Hj], g [B, U+1, Hj]; ``w_fc`` [K, Hj] / ``b_fc`` [K] and
    ``simple_params`` (``{"simple_am": {"w", "b"}, "simple_lm": ...}``) this
    rank's vocab shard under ``model_group``, else whole. Joint dropout at
    ``dropout_rate`` is drawn from ``generator``.
    """
    B, T, H = f.shape
    U1 = g.shape[1]
    S = min(prune_range, U1)
    am, lm = simple_params["simple_am"], simple_params["simple_lm"]
    simple, null_s, emit_s = _simple_stage(f, g, am["w"], am["b"], lm["w"], lm["b"], labels,
                                           t_lens, u_lens, blank_idx, mods, model_group)
    # the bounds from the simple posteriors: integers, no gradient
    ranges = simple_ranges(simple, null_s, emit_s, t_lens, u_lens, S)

    # the banded joint: the fused joint + LSE on B * T * S rows
    dev = f.device
    lab = _lab_padded(labels)
    j_ix = torch.arange(S, device=dev)[None, None, :]
    u_band = torch.clamp(ranges[:, :, None] + j_ix, 0, U1 - 1)  # [B, T, S]
    lab_rows = lab[:, None, :].expand(B, T, U1)
    lab_band = lab_rows.gather(2, u_band)
    # the star rule's previous label: label[u-1] == star and u > 0
    prev_star = (u_band > 0) & (lab_rows.gather(2, torch.clamp(u_band - 1, min=0))
                                == mods.star_idx)
    row_ix = (torch.arange(B, device=dev)[:, None] * U1 + u_band.reshape(B, T * S)).reshape(-1)
    # the rows gathered in fp32, so that the gather's backward (a scatter-add
    # of T * S rows into U + 1) sums in fp32 and rounds once, as the dense
    # route's broadcast does; f + g rounds to the compute dtype as there
    g_band = g.float().reshape(B * U1, H)[row_ix].reshape(B, T, S, H)
    h = torch.relu(f[:, :, None, :].float() + g_band).to(f.dtype).reshape(B * T * S, H)
    h = _joint_dropout(generator, h, dropout_rate)
    if model_group is not None or H % 128 == 0:
        lp_b, lp_l = _joint_lse(h, w_fc.t(), b_fc, lab_band.reshape(-1), blank_idx, model_group)
    else:
        logits = h.float() @ w_fc.t().to(h.dtype).float() + b_fc.float()
        denom = torch.logsumexp(logits, dim=-1)
        lp_b = logits[:, blank_idx] - denom
        lp_l = logits.gather(1, lab_band.reshape(-1, 1))[:, 0] - denom
    lp_blank, lp_label = lp_b.reshape(B, T, S), lp_l.reshape(B, T, S)

    # the penalties in band coordinates (as _penalised_scores)
    t_ix = torch.arange(T, device=dev, dtype=torch.float32)[None, :, None]
    Fm1 = (t_lens.float() - 1.0)[:, None, None]
    dp = mods.delay_penalty * (Fm1 / 2.0 - t_ix)
    eos = torch.where(lab_band == mods.eos_idx, mods.eos_penalty * (Fm1 / 2.0 - t_ix), 0.0)
    emit = torch.where(lab_band == mods.star_idx, dp, lp_label + dp + eos)
    null = torch.where(prev_star, mods.star_penalty, lp_blank)
    pruned = banded_rnnt_lattice(null, emit, ranges, t_lens, u_lens)
    return simple_scale * simple + pruned
