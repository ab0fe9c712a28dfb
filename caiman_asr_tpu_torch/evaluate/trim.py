"""Offline EOS/VAD trimming + termination kinds for evaluation.

Mirrors the streaming endpointer's behaviour on offline decodes (reference
evaluate/trim.py:28-160): cut the hypothesis where a live system would have
terminated the utterance, and report HOW it terminated —

  ``Silence(t)``: ``eos_vad_threshold`` seconds of consecutive blank frames
      (mid-utterance: tokens after the gap are dropped; tail: nothing to
      drop but the termination time is the gap start + threshold).
  ``EOS(t)``: the model emitted the end-of-sentence user token. With
      ``eos_is_terminal`` the hyp is cut at the FIRST EOS; otherwise EOS is
      only reported when the last non-blank token is an EOS (no trimming of
      earlier ones).
  ``Never()``: the model never stopped — the offline decode consumed the
      whole utterance.

The termination times feed the SIL/EOS endpoint latencies in
latency/measure_latency.py and the user-perceived word timestamps.

Width conventions (reference utils/frame_width.py): ``pre_enc_width`` is the
stacked input-feature frame duration (window_stride * frame_stacking,
0.03 s default) — ``feat_lens`` are in these frames; ``post_enc_width`` is
the encoder output frame duration (* enc_stack_time_factor, 0.06 s default)
— token timestamps are in these frames.

The port's copy of ``caiman_asr_tpu/evaluate/trim.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from caiman_asr_tpu_torch.latency.timestamp import (
    EOS,
    Never,
    Silence,
    Termination,
    Timestamp,
    user_perceived_time,
)


@dataclass
class EOSTrimConfig:
    """EOS trimming inputs (reference evaluate/trim.py:16-24)."""

    eos_idx: int
    eos_is_terminal: bool
    blank_idx: int


def _find(val: int, lst: Sequence[int]) -> Optional[int]:
    try:
        return list(lst).index(val)
    except ValueError:
        return None


def trim_predictions(
    pred: List[List[int]],
    timestamps: List[List[Timestamp]],
    probs: Optional[List[List[float]]],
    pre_enc_width: float,
    post_enc_width: float,
    feat_lens: Sequence[int],
    eos_vad_threshold: float,
    eos_info: Optional[EOSTrimConfig] = None,
) -> Tuple[
    List[List[int]],
    List[List[Timestamp]],
    Optional[List[List[float]]],
    List[Termination],
]:
    """Apply VAD-silence and EOS cuts per utterance; returns the trimmed
    (pred, timestamps, probs, terminations). ``probs`` may be None (our
    greedy path doesn't carry per-token probabilities); when given it is
    trimmed in lockstep. Semantics match reference evaluate/trim.py:28-152:
    the silence check runs first but each check truncates everything after
    its cut point, so the reported termination is always the earliest one —
    exactly what a live endpointer would have done.
    """
    o_pred: List[List[int]] = []
    o_ts: List[List[Timestamp]] = []
    o_probs: Optional[List[List[float]]] = None if probs is None else []
    o_term: List[Termination] = []

    probs_in: List[Optional[List[float]]] = (
        [None] * len(pred) if probs is None else list(probs)
    )
    for y, t, p, worst in zip(pred, timestamps, probs_in, feat_lens):
        if p is not None:
            assert len(y) == len(t) == len(p), f"got {len(y)} {len(t)} {len(p)}"
        else:
            assert len(y) == len(t), f"got {len(y)} {len(t)}"
        # seconds of audio the encoder actually processed
        proc_end = float(worst) * pre_enc_width

        if not t:
            # no tokens = all blanks: a live VAD would have fired once the
            # threshold of silence elapsed (if the audio is long enough)
            o_pred.append(list(y))
            o_ts.append(list(t))
            if o_probs is not None:
                o_probs.append(list(p))
            o_term.append(
                Silence(eos_vad_threshold)
                if proc_end > eos_vad_threshold
                else Never()
            )
            continue

        y, t = list(y), list(t)
        p = None if p is None else list(p)
        term: Termination = Never()

        if eos_vad_threshold != float("inf"):
            last_tok = (user_perceived_time(t[-1]) + 1) * post_enc_width
            sil_frames = round(eos_vad_threshold / post_enc_width)

            # trailing silence: blanks from the last token to the end
            if proc_end - last_tok > eos_vad_threshold:
                term = Silence(last_tok + eos_vad_threshold)

            # mid-utterance silence: a frame gap between consecutive tokens
            # longer than the threshold cuts everything after it (never
            # before the FIRST token — the speaker isn't cut off before
            # saying anything, reference trim.py:96-99)
            for idx in range(1, len(t)):
                t_prev = user_perceived_time(t[idx - 1])
                t_idx = user_perceived_time(t[idx])
                if t_idx - t_prev > sil_frames:
                    frames = t_prev + 1 + sil_frames
                    y, t = y[:idx], t[:idx]
                    if p is not None:
                        p = p[:idx]
                    term = Silence(frames * post_enc_width)
                    break

        if eos_info is not None:
            if eos_info.eos_is_terminal:
                # live semantics: decoding stops at the first EOS
                idx = _find(eos_info.eos_idx, y)
            else:
                # only report EOS when the last non-blank token is an EOS
                # (scan back over trailing blanks/EOS, reference :119-131)
                idx = None
                for i in range(len(y) - 1, -1, -1):
                    if y[i] == eos_info.eos_idx:
                        idx = i
                    elif y[i] == eos_info.blank_idx:
                        continue
                    else:
                        break
            if idx is not None:
                term = EOS((user_perceived_time(t[idx]) + 1) * post_enc_width)
                assert y[idx] == eos_info.eos_idx
                idx += 1  # keep the EOS token itself
                y, t = y[:idx], t[:idx]
                if p is not None:
                    p = p[:idx]

        o_pred.append(y)
        o_ts.append(t)
        if o_probs is not None:
            o_probs.append(p)
        o_term.append(term)

    return o_pred, o_ts, o_probs, o_term
