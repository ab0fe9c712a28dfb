"""RNN-T (transducer) loss, mirroring ``caiman_asr_tpu/ops/transducer_loss.py``.

- The (t, u) lattice: per time row, ``alpha[t, u] = LSE(prev[u],
  alpha[t, u-1] + emit[t, u-1])`` is a first-order recurrence solved by a
  log-depth scan of (k, b) pairs with the JAX package's combine rule
  (``_linrec``), while a Python loop advances over T. Its backward is the
  closed-form edge-posterior gradient (``rnnt_lattice``). The lattice is
  plain XLA code in the JAX package, not a Pallas kernel, so it is plain
  PyTorch here.
- Loss modifiers (delay, EOS and star penalties) as ``LossModifiers``.
- ``transducer_loss_from_fg`` takes the fused route on every device: the
  joint hidden ``relu(f + g)`` (with joint dropout in training) goes through
  ``ops/joint_kernel.fused_joint_lse``, so the ``[B, T, U+1, K]`` logits are
  never materialised. On a CUDA tensor that runs the Hopper kernels; on a CPU
  tensor their plain versions. ``transducer_loss`` over dense logits is the
  plain reference.
- ``pack_to``: the packed joint runs those kernels over only the valid
  lattice positions, ``pack_to`` rows (``_packed_joint_scores``); a cap
  below the valid count makes both score tensors -inf, so the loss is not
  finite and the train step skips.
- ``model_group`` (the JAX package's ``vocab_axis``): ``w_fc`` / ``b_fc``
  are this rank's contiguous shard of the vocabulary and both the dense and
  the packed route go through the vocab-parallel joint
  (``parallel/vocab_parallel.vp_joint_lse``), as ``_joint_lse`` routes it
  in the JAX package.

The pruned loss (``ops/pruned_loss.py``) reuses the lattice pieces here:
``_masked_scores``, ``_lattice_alpha_beta``, ``_row_update_fwd`` /
``_row_update_bwd``, ``_penalised_scores``, ``rnnt_lattice``,
``_joint_dropout`` and ``_joint_lse``. Not ported: the T-chunked dense
route, which the fused route replaces on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from caiman_asr_tpu_torch.ops import joint_kernel

NEG_INF = -1.0e30  # instead of -inf, so that masked lanes never make inf - inf


@dataclass(frozen=True)
class LossModifiers:
    """Penalty configuration: delay_penalty / eos_penalty are the lambda
    factors of the fractional penalties; star_penalty is a constant log-prob
    for blank transitions out of an uncertain-label row. ``*_idx`` of -1
    disables the respective token."""

    delay_penalty: float = 0.0
    eos_penalty: float = 0.0
    eos_idx: int = -1
    star_penalty: float = 0.0
    star_idx: int = -1


def _linrec(b: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[j] = LSE(b[j], x[j-1] + k[j]) along the last axis, x[0] = b[0].

    In ordinary space X[j] = B[j] + K[j] X[j-1]; the affine maps compose as
    (k1, b1) then (k2, b2) -> (k1 + k2, LSE(b2, k2 + b1)), evaluated by a
    log-depth inclusive scan. The k sums stay finite with k = NEG_INF (a
    cumsum-of-k rewrite would overflow there)."""
    k = torch.cat([torch.full_like(k[..., :1], NEG_INF), k[..., 1:]], dim=-1)
    n = b.shape[-1]
    shift = 1
    while shift < n:
        k_prev, b_prev = k[..., :-shift], b[..., :-shift]
        k_cur, b_cur = k[..., shift:], b[..., shift:]
        k = torch.cat([k[..., :shift], k_prev + k_cur], dim=-1)
        b = torch.cat([b[..., :shift], torch.logaddexp(b_cur, k_cur + b_prev)], dim=-1)
        shift *= 2
    return b


def _row_update_fwd(prev: torch.Tensor, emit_row: torch.Tensor) -> torch.Tensor:
    """alpha row: x[u] = LSE(prev[u], x[u-1] + emit_row[u-1])."""
    k = torch.cat([torch.full_like(emit_row[..., :1], NEG_INF), emit_row[..., :-1]], dim=-1)
    return _linrec(prev, k)


def _row_update_bwd(nxt: torch.Tensor, emit_row: torch.Tensor) -> torch.Tensor:
    """beta row: x[u] = LSE(nxt[u], x[u+1] + emit_row[u]), the forward
    recurrence in reversed coordinates."""
    return _linrec(nxt.flip(-1), emit_row.flip(-1)).flip(-1)


def _masked_scores(null_scores, emit_scores, t_lens, u_lens):
    """Rows with t >= t_len become pass-through (null 0, emit -inf), so one
    static-shape loop handles ragged batches; returns (null, emit, seed)
    with seed the beta row at the virtual row t = T."""
    B, T, U1 = null_scores.shape
    dev = null_scores.device
    t_ix = torch.arange(T, device=dev)[None, :, None]
    u_ix = torch.arange(U1, device=dev)[None, None, :]
    F = t_lens.long()[:, None, None]
    G = (u_lens.long() + 1)[:, None, None]
    in_t = t_ix < F
    null = torch.where(in_t, torch.where(u_ix < G, null_scores, NEG_INF), 0.0)
    emit = torch.where(in_t & (u_ix < G - 1), emit_scores, NEG_INF)
    u_row = torch.arange(U1, device=dev)[None, :]
    seed = torch.where(u_row == u_lens.long()[:, None], 0.0, NEG_INF)
    return null, emit, seed


def _lattice_alpha_beta(null, emit, seed):
    """alpha and beta over the masked lattice, each [B, T, U1] fp32."""
    B, T, U1 = null.shape
    init = torch.full((B, U1), NEG_INF, device=null.device)
    init[:, 0] = 0.0
    alphas = [_row_update_fwd(init, emit[:, 0])]
    for t in range(1, T):
        alphas.append(_row_update_fwd(alphas[-1] + null[:, t - 1], emit[:, t]))
    betas = [None] * T
    b_next = seed
    for t in reversed(range(T)):
        b_next = _row_update_bwd(null[:, t] + b_next, emit[:, t])
        betas[t] = b_next
    return torch.stack(alphas, 1), torch.stack(betas, 1)


class RNNTLattice(torch.autograd.Function):
    """Per-sample ``-log P(y | x)`` [B] from null/emit edge scores
    [B, T, U+1]; the backward is the closed-form edge posterior
    (``transducer_loss.py:211-237``)."""

    @staticmethod
    def forward(ctx, null_scores, emit_scores, t_lens, u_lens):
        null, emit, seed = _masked_scores(null_scores.float(), emit_scores.float(), t_lens,
                                          u_lens)
        alpha, beta = _lattice_alpha_beta(null, emit, seed)
        ctx.save_for_backward(null, emit, seed, alpha, beta, t_lens, u_lens)
        return -beta[:, 0, 0]

    @staticmethod
    def backward(ctx, ct):
        null, emit, seed, alpha, beta, t_lens, u_lens = ctx.saved_tensors
        B, T, U1 = null.shape
        beta00 = beta[:, 0, 0][:, None, None]
        beta_next = torch.cat([beta[:, 1:], seed[:, None, :]], dim=1)
        beta_right = torch.cat([beta[:, :, 1:], torch.full_like(beta[:, :, :1], NEG_INF)], dim=2)
        dev = null.device
        t_ix = torch.arange(T, device=dev)[None, :, None]
        u_ix = torch.arange(U1, device=dev)[None, None, :]
        F = t_lens.long()[:, None, None]
        G = (u_lens.long() + 1)[:, None, None]
        post_null = torch.exp(torch.clamp(alpha + null + beta_next - beta00, NEG_INF, 0.0))
        post_emit = torch.exp(torch.clamp(alpha + emit + beta_right - beta00, NEG_INF, 0.0))
        ctb = ct[:, None, None]
        g_null = torch.where((t_ix < F) & (u_ix < G), -ctb * post_null, 0.0)
        g_emit = torch.where((t_ix < F) & (u_ix < G - 1), -ctb * post_emit, 0.0)
        return g_null, g_emit, None, None


def rnnt_lattice(null_scores, emit_scores, t_lens, u_lens) -> torch.Tensor:
    """Per-sample negative log-likelihood [B] (fp32) of the transducer
    lattice: null_scores / emit_scores [B, T, U+1] are the blank and label
    log-probs at (t, u) (emit at u = U is ignored)."""
    return RNNTLattice.apply(null_scores, emit_scores, t_lens, u_lens)


def _lab_padded(labels: torch.Tensor) -> torch.Tensor:
    """labels [B, U] -> [B, U+1] int64 with a dummy 0 at U."""
    lab = labels.long()
    return torch.cat([lab, lab.new_zeros((lab.shape[0], 1))], dim=1)


def _penalised_scores(lp_blank, lp_label, labels, t_lens, mods: LossModifiers):
    """Apply the delay / EOS / star penalties to gathered log-probs."""
    B, T, U1 = lp_blank.shape
    lab_padded = _lab_padded(labels)
    t_ix = torch.arange(T, device=lp_blank.device, dtype=torch.float32)[None, :, None]
    Fm1 = (t_lens.float() - 1.0)[:, None, None]
    dp = mods.delay_penalty * (Fm1 / 2.0 - t_ix)
    is_star_u = (lab_padded == mods.star_idx)[:, None, :]
    is_eos_u = (lab_padded == mods.eos_idx)[:, None, :]
    eos = torch.where(is_eos_u, mods.eos_penalty * (Fm1 / 2.0 - t_ix), 0.0)
    emit = torch.where(is_star_u, dp, lp_label + dp + eos)
    prev_star = torch.cat([torch.zeros_like(labels[:, :1], dtype=torch.bool),
                           labels.long() == mods.star_idx], dim=1)
    null = torch.where(prev_star[:, None, :], mods.star_penalty, lp_blank)
    return null, emit


def joint_lattice_scores(logits, labels, t_lens, u_lens, blank_idx: int,
                         mods: LossModifiers = LossModifiers()):
    """(null, emit) edge scores [B, T, U+1] fp32 from dense joint logits
    [B, T, U+1, K]."""
    logits32 = logits.float()
    denom = torch.logsumexp(logits32, dim=-1)
    lp_blank = logits32[..., blank_idx] - denom
    idx = _lab_padded(labels)[:, None, :, None].expand(*logits.shape[:3], 1)
    lp_label = torch.gather(logits32, -1, idx)[..., 0] - denom
    return _penalised_scores(lp_blank, lp_label, labels, t_lens, mods)


def transducer_loss(logits, labels, t_lens, u_lens, blank_idx: int,
                    mods: LossModifiers = LossModifiers()) -> torch.Tensor:
    """Dense-logits transducer loss; per-sample loss [B]. The plain
    reference of the fused route."""
    null, emit = joint_lattice_scores(logits, labels, t_lens, u_lens, blank_idx, mods)
    return rnnt_lattice(null, emit, t_lens, u_lens)


class JointDropout(torch.autograd.Function):
    """Inverted dropout on the (post-ReLU, so non-negative) joint hidden.
    The backward reads the mask off the output (kept and nonzero), as
    ``transducer_loss.py:310-333``: no saved mask, no replayed generator."""

    @staticmethod
    def forward(ctx, h, rate: float, generator: Optional[torch.Generator]):
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
        out = torch.where(keep, h / (1.0 - rate), 0.0).to(h.dtype)
        ctx.rate = rate
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, ct):
        (out,) = ctx.saved_tensors
        return torch.where(out != 0, ct / (1.0 - ctx.rate), 0.0).to(ct.dtype), None, None


def _joint_dropout(generator: Optional[torch.Generator], h, rate: float):
    """Joint dropout at ``rate`` drawn from ``generator`` (h unchanged at
    rate 0)."""
    if rate <= 0.0:
        return h
    if generator is None:
        raise ValueError("joint dropout requires a generator")
    return JointDropout.apply(h, rate, generator)


def _joint_lse(h, w_t, b, lab_flat, blank_idx: int, model_group=None):
    """The fused joint + LSE of one process, or under ``model_group`` the
    vocab-parallel one: ``w_t`` [Hj, K] / ``b`` the local vocab shard and
    ``blank_idx`` / ``lab_flat`` global ids (``transducer_loss.py:389-401``)."""
    if model_group is not None:
        from caiman_asr_tpu_torch.parallel.vocab_parallel import vp_joint_lse

        return vp_joint_lse(h, w_t, b, lab_flat, blank_idx, model_group)
    return joint_kernel.fused_joint_lse(h, w_t, b, lab_flat, blank_idx)


def _fused_joint_scores(f, g, w_fc, b_fc, labels, blank_idx: int,
                        generator: Optional[torch.Generator] = None,
                        dropout_rate: float = 0.0, model_group=None):
    """(lp_blank, lp_label) [B, T, U+1] without the logits slab."""
    B, T, H = f.shape
    U1 = g.shape[1]
    h = torch.relu(f[:, :, None, :] + g[:, None, :, :]).reshape(B * T * U1, H)
    h = _joint_dropout(generator, h, dropout_rate)
    lab_flat = _lab_padded(labels)[:, None, :].expand(B, T, U1).reshape(-1)
    lp_b, lp_l = _joint_lse(h, w_fc.t(), b_fc, lab_flat, blank_idx, model_group)
    return lp_b.reshape(B, T, U1), lp_l.reshape(B, T, U1)


def _packed_joint_scores(f, g, w_fc, b_fc, labels, t_lens, u_lens, blank_idx: int,
                         pack_to: int, generator: Optional[torch.Generator] = None,
                         dropout_rate: float = 0.0, model_group=None):
    """(lp_blank, lp_label) [B, T, U+1] with the joint run over ``pack_to``
    rows, the valid positions in (b, t, u) order
    (``caiman_asr_tpu/ops/transducer_loss.py:426-493``).

    A slot's (b, t, u) comes from ``searchsorted`` over the cumulative
    per-utterance lattice sizes ``t_len * (u_len + 1)``; the f and g rows
    are gathered, relu'd (and dropped out), and the joint's scores
    scattered back into a dense buffer of N + 1 slots whose last takes the
    slots past the valid count; invalid positions hold 0, which the lattice
    masks. Computed on the device throughout: when the valid count exceeds
    ``pack_to`` both outputs are -inf, never a truncated lattice."""
    B, T, H = f.shape
    U1 = g.shape[1]
    N = B * T * U1
    dev = f.device
    u1 = u_lens.long() + 1
    sizes = t_lens.long() * u1
    off = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    slots = torch.arange(pack_to, device=dev)
    b_i = torch.clamp(torch.searchsorted(off, slots, right=True) - 1, 0, B - 1)
    rem = slots - off[b_i]
    u1b = u1[b_i]
    t_i = torch.clamp(rem // u1b, max=T - 1)
    u_i = torch.clamp(rem % u1b, max=U1 - 1)
    valid = slots < off[B]
    g_rows = b_i * U1 + u_i
    h = torch.relu(f.reshape(B * T, H)[b_i * T + t_i] + g.reshape(B * U1, H)[g_rows])
    h = _joint_dropout(generator, h, dropout_rate)
    lab_flat = _lab_padded(labels).reshape(B * U1)[g_rows]
    lp_b, lp_l = _joint_lse(h, w_fc.t().to(h.dtype), b_fc, lab_flat, blank_idx, model_group)
    flat = torch.where(valid, (b_i * T + t_i) * U1 + u_i, N)
    overflow = off[B] > pack_to

    def scatter(v):
        dense = torch.zeros(N + 1, dtype=torch.float32, device=dev).scatter(0, flat, v.float())
        return torch.where(overflow, float("-inf"), dense[:N].reshape(B, T, U1))

    return scatter(lp_b), scatter(lp_l)


def transducer_loss_from_fg(
    f: torch.Tensor,
    g: torch.Tensor,
    w_fc: torch.Tensor,
    b_fc: torch.Tensor,
    labels: torch.Tensor,
    t_lens: torch.Tensor,
    u_lens: torch.Tensor,
    blank_idx: int,
    mods: LossModifiers = LossModifiers(),
    *,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    pack_to: Optional[int] = None,
    model_group=None,
) -> torch.Tensor:
    """Fused joint + transducer loss, per sample [B].

    f [B, T, Hj] and g [B, U+1, Hj] are the encoder and prediction
    projections, ``w_fc`` [K, Hj] and ``b_fc`` [K] the final joint linear.
    ``dropout_rate`` > 0 applies joint dropout drawn from ``generator``.
    ``pack_to`` runs the joint over that many rows, the valid lattice
    positions (``training/pack.pack_cap``), instead of all B * T * (U+1).
    ``model_group``: a ``torch.distributed`` group over which the vocabulary
    is sharded; ``w_fc`` / ``b_fc`` are then this rank's rows of it.
    """
    if pack_to is not None:
        lp_blank, lp_label = _packed_joint_scores(f, g, w_fc, b_fc, labels, t_lens, u_lens,
                                                  blank_idx, pack_to, generator, dropout_rate,
                                                  model_group)
    else:
        lp_blank, lp_label = _fused_joint_scores(f, g, w_fc, b_fc, labels, blank_idx,
                                                 generator, dropout_rate, model_group)
    null, emit = _penalised_scores(lp_blank, lp_label, labels, t_lens, mods)
    return rnnt_lattice(null, emit, t_lens, u_lens)
