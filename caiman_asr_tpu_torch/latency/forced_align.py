"""Forced alignment for ground-truth CTM generation (the port of
``caiman_asr_tpu/latency/forced_align.py``).

Viterbi alignment through the RNN-T lattice itself: the same (t, u)
recursion as the transducer loss with max-plus algebra instead of
log-sum-exp, plus a backtrace. Any trained RNN-T checkpoint aligns its own
data; no external CTC model is needed.

The encoder and predictor (``model.enc_pred``, whose LSTM layers run K1 on
the card), the dense joint ``[B, T', U+1, K]`` and its lattice scores
(``ops/transducer_loss.joint_lattice_scores``) run on the model's device;
the max-plus pass and the backtrace run on the host in float64.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.ops.transducer_loss import NEG_INF, joint_lattice_scores


def _viterbi_lattice(null: np.ndarray, emit: np.ndarray, T: int, U: int):
    """Max-plus forward + backtrace for one utterance.

    null, emit: [Tmax, Umax+1] masked scores. Returns frame index per token;
    where emitting and a blank tie, the path emits.
    """
    alpha = np.full((T, U + 1), NEG_INF, np.float64)
    # move[t, u]: 0 = came via blank from (t-1, u); 1 = via emit from (t, u-1)
    move = np.zeros((T, U + 1), np.int8)
    alpha[0, 0] = 0.0
    for u in range(1, U + 1):
        alpha[0, u] = alpha[0, u - 1] + emit[0, u - 1]
        move[0, u] = 1
    for t in range(1, T):
        alpha[t, 0] = alpha[t - 1, 0] + null[t - 1, 0]
        for u in range(1, U + 1):
            via_blank = alpha[t - 1, u] + null[t - 1, u]
            via_emit = alpha[t, u - 1] + emit[t, u - 1]
            if via_emit >= via_blank:
                alpha[t, u] = via_emit
                move[t, u] = 1
            else:
                alpha[t, u] = via_blank
    # backtrace from (T-1, U)
    frames = np.zeros(U, np.int64)
    t, u = T - 1, U
    while u > 0:
        if move[t, u] == 1:
            frames[u - 1] = t
            u -= 1
        else:
            t -= 1
    return frames


def path_score(null: np.ndarray, emit: np.ndarray, frames: np.ndarray, T: int) -> float:
    """The lattice score (float64) of the monotonic path that emits token u at
    ``frames[u]``: every emit on its frame, a blank ending every frame but
    the last. Two alignments that tie score the same."""
    total, t = 0.0, 0
    for u, f in enumerate(np.asarray(frames, np.int64)):
        for tt in range(t, int(f)):
            total += float(null[tt, u])
        t = int(f)
        total += float(emit[t, u])
    for tt in range(t, T - 1):
        total += float(null[tt, len(frames)])
    return total


def lattice_scores(model, f, f_lens, g, tokens, token_lens, blank_idx: int):
    """(null, emit) [B, T', U+1] fp32 on the model's device: the dense joint of
    encoder output ``f`` [B, T', Hj] and prediction output ``g`` [B, U+1, Hj],
    and its blank and label log-probabilities."""
    dev = f.device
    with torch.no_grad():
        logits = model.joint(f, g)  # [B, T', U+1, K]
        return joint_lattice_scores(logits, torch.as_tensor(np.asarray(tokens), device=dev),
                                    torch.as_tensor(f_lens, device=dev),
                                    torch.as_tensor(np.asarray(token_lens), device=dev),
                                    blank_idx)


def viterbi_from_scores(null, emit, f_lens, token_lens) -> List[np.ndarray]:
    """Frames per utterance from lattice scores, on the host in float64."""
    null = null.double().cpu().numpy()
    emit = emit.double().cpu().numpy()
    f_lens = np.asarray(torch.as_tensor(f_lens).cpu())
    token_lens = np.asarray(token_lens)
    return [_viterbi_lattice(null[b], emit[b], int(f_lens[b]), int(token_lens[b]))
            for b in range(null.shape[0])]


def viterbi_alignment(
    model,
    feats,
    feat_lens,
    tokens: np.ndarray,
    token_lens: np.ndarray,
    blank_idx: int,
) -> List[np.ndarray]:
    """Align target tokens to encoder frames via the RNN-T lattice.

    feats: [T, B, F] time-major features on the model's device; tokens
    [B, U]. Returns a list of per-utterance frame-index arrays (length =
    token_lens[b]).
    """
    dev = feats.device
    with torch.no_grad():
        (f, f_lens), (g, _), _ = model.enc_pred(
            feats, torch.as_tensor(feat_lens, device=dev),
            torch.as_tensor(np.asarray(tokens), device=dev),
            torch.as_tensor(np.asarray(token_lens), device=dev))
    return viterbi_alignment_from_enc(model, f, f_lens, g, tokens, token_lens, blank_idx)


def viterbi_alignment_from_enc(
    model,
    f,
    f_lens,
    g,
    tokens: np.ndarray,
    token_lens: np.ndarray,
    blank_idx: int,
) -> List[np.ndarray]:
    """Alignment from precomputed encoder output f [B, T', Hj] and
    prediction output g [B, U+1, Hj] (segment-wise encoding feeds this)."""
    null, emit = lattice_scores(model, f, f_lens, g, tokens, token_lens, blank_idx)
    return viterbi_from_scores(null, emit, f_lens, token_lens)


def alignment_to_ctm_entries(
    frames: np.ndarray,
    tokens: List[int],
    tokenizer,
    frame_width: float,
) -> List[Tuple[float, float, str]]:
    """Group aligned token frames into word-level (start, end, word) rows."""
    from caiman_asr_tpu_torch.latency.timestamp import Never, group_timestamps

    pieces = [tokenizer.id_to_piece(t).replace("▁", " ") for t in tokens]
    sentence = tokenizer.detokenize(tokens)
    seqs = group_timestamps([pieces], [list(map(int, frames))], [sentence], [Never()])
    rows = []
    for w in seqs[0].seqs:
        start = w.start_frame * frame_width
        end = (w.end_frame + 1) * frame_width
        rows.append((start, end, w.word))
    return rows
