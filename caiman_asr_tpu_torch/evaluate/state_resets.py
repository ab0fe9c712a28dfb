"""State resets with overlap: long-form inference segmentation.

Reference: evaluate/state_resets/{core.py:16-160, overlap_processing.py,
batch.py} + docs/src/training/state_resets.md. Utterances longer than
``--sr_segment`` seconds are split into overlapping segments which are
decoded **as extra batch lanes** (state reset at each segment start); the
per-segment token streams are then merged:

1. tokens whose decoder timestamp falls inside the overlap region are
   dropped (they were already decoded by the previous segment);
2. a ``lookahead``-token boundary scan removes duplicated tokens the
   previous segment emitted just before the cut (lookahead=3,
   overlap_processing.py:67-186);
3. timestamps are shifted by the net segment advance so the merged stream
   looks continuously decoded (overlap_processing.py:15-64).

This implementation is batched from the start (the reference's batch.py
generalisation): a [T, B, F] feature batch becomes a [S, N, F] segment
batch with a mapping back to source utterances.

The port's copy of ``caiman_asr_tpu/evaluate/state_resets.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from caiman_asr_tpu_torch.latency.timestamp import add_frames, user_perceived_time


@dataclass(frozen=True)
class StateResetsConfig:
    segment_frames: int
    overlap_frames: int
    enc_time_reduction: int
    lookahead: int = 3

    @classmethod
    def from_seconds(
        cls,
        sr_segment: float,
        sr_overlap: float,
        frame_duration: float,
        enc_time_reduction: int,
        lookahead: int = 3,
    ) -> "StateResetsConfig":
        if sr_segment <= 0 or sr_overlap < 0:
            raise ValueError("--sr_segment must be > 0 and --sr_overlap >= 0")
        if sr_segment <= sr_overlap:
            raise ValueError("--sr_segment must be greater than --sr_overlap")
        return cls(
            segment_frames=round(sr_segment / frame_duration),
            overlap_frames=round(sr_overlap / frame_duration),
            enc_time_reduction=enc_time_reduction,
            lookahead=lookahead,
        )


def segment_batch(
    feats: np.ndarray,
    feat_lens: np.ndarray,
    cfg: StateResetsConfig,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Split [T, B, F] features into overlapping segments.

    Returns (seg_feats [S, N, F], seg_lens [N], seg_counts[B]) where
    utterance b owns seg_counts[b] consecutive lanes of the segment batch.
    Utterances shorter than one segment stay whole (one lane).
    """
    T, B, F = feats.shape
    step = cfg.segment_frames - cfg.overlap_frames
    lanes: List[np.ndarray] = []
    lens: List[int] = []
    counts: List[int] = []
    for b in range(B):
        n = int(feat_lens[b])
        if n <= cfg.segment_frames:
            lanes.append(feats[: cfg.segment_frames, b])
            lens.append(n)
            counts.append(1)
            continue
        n_seg = 1 + math.ceil((n - cfg.segment_frames) / step)
        counts.append(n_seg)
        for s in range(n_seg):
            start = s * step
            chunk = feats[start : start + cfg.segment_frames, b]
            lens.append(min(cfg.segment_frames, max(n - start, 0)))
            lanes.append(chunk)
    S = cfg.segment_frames
    N = len(lanes)
    out = np.zeros((S, N, F), feats.dtype)
    for i, lane in enumerate(lanes):
        out[: lane.shape[0], i] = lane
    return out, np.asarray(lens, np.int32), counts


def merge_segments(
    seg_tokens: Sequence[List[int]],
    seg_timestamps: Sequence[List[int]],
    seg_probs: Optional[Sequence[List[float]]],
    cfg: StateResetsConfig,
) -> Tuple[List[int], List[int], Optional[List[float]]]:
    """Merge one utterance's per-segment decodes into a continuous stream."""
    overlap_dur = math.ceil(cfg.overlap_frames / cfg.enc_time_reduction)
    step_dur = (cfg.segment_frames - cfg.overlap_frames) // cfg.enc_time_reduction

    toks: List[int] = []
    ts: List[int] = []
    probs: List[float] = [] if seg_probs is not None else None
    prev_tail: List[int] = []
    for s, (p, t) in enumerate(zip(seg_tokens, seg_timestamps)):
        p, t = list(p), list(t)
        pr = list(seg_probs[s]) if seg_probs is not None else None
        if s > 0:
            # 1. drop tokens inside the overlap region
            omit = 0
            for time in t:
                if user_perceived_time(time) < overlap_dur:
                    omit += 1
                else:
                    break
            p, t = p[omit:], t[omit:]
            if pr is not None:
                pr = pr[omit:]
            # 2. boundary dedup against the previous segment's tail: each of
            # the first ``lookahead`` tokens that also appears in the tail is
            # dropped (overlap_processing.py:188-229)
            trusted = list(prev_tail)
            for token in list(p[: cfg.lookahead]):
                if token in trusted:
                    idx = p.index(token)
                    del t[idx]
                    if pr is not None:
                        del pr[idx]
                    p.remove(token)
                    trusted = trusted[trusted.index(token) + 1 :]
        prev_tail = (toks + p)[-cfg.lookahead :]
        # 3. shift timestamps onto the continuous timeline
        shift = s * step_dur
        toks.extend(p)
        ts.extend(add_frames(time, shift) for time in t)
        if pr is not None:
            probs.extend(pr)
    return toks, ts, probs


def group_segment_lanes(counts: List[int]) -> List[Tuple[int, int]]:
    """Lane ranges [(start, end), ...] per utterance from segment counts."""
    out = []
    start = 0
    for c in counts:
        out.append((start, start + c))
        start += c
    return out
