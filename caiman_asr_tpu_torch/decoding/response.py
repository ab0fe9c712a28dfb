"""Decoding response wire schema (own copy of
``caiman_asr_tpu/decoding/response.py``; the port imports nothing of the
JAX package).

This is the public contract shared with the streaming server / clients
(reference: rnnt/response.py and docs/src/inference/websocket_api.md).
Greedy decoding emits only finals; beam decoding emits partials each frame
plus finals once all beam hypotheses share a common prefix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HypothesisResponse:
    y_seq: List[int]
    timesteps: List[int]
    token_seq: List[str]
    confidence: List[float]


@dataclass
class DecodingResponse:
    start_frame_idx: int
    duration_frames: int
    is_provisional: bool
    alternatives: List[HypothesisResponse]


@dataclass
class FrameResponses:
    partials: Optional[DecodingResponse]
    final: Optional[DecodingResponse]


def frame_responses_to_tokens(responses: Dict[int, FrameResponses]) -> List[int]:
    """Concatenate final y_seqs in frame order (greedy transcript)."""
    out: List[int] = []
    for t in sorted(responses):
        fr = responses[t]
        if fr.final is not None and fr.final.alternatives:
            out.extend(fr.final.alternatives[0].y_seq)
    return out


def frame_responses_timesteps(responses: Dict[int, FrameResponses]) -> List[int]:
    out: List[int] = []
    for t in sorted(responses):
        fr = responses[t]
        if fr.final is not None and fr.final.alternatives:
            out.extend(fr.final.alternatives[0].timesteps)
    return out


def fuse_partials(responses: Dict[int, FrameResponses]) -> Dict[int, FrameResponses]:
    """Rewrite each final's timesteps to the USER-PERCEIVED clock: the frame
    from which every character of the token was continuously visible on
    screen (reference utils/responses.py:39-155).

    A final character's first-visible frame is the oldest partial in the
    unbroken newest->oldest agreement chain at that character position
    (short partials are skipped — they never overwrote that screen column;
    a disagreeing partial breaks the chain: the character flickered). A
    token's frame is the max over its characters; worst case is the frame
    the final itself arrived at. Partials longer than a final keep their
    uncommitted character tail for the next final. Decoders that emit no
    partials (greedy, fast_beam offline) come out with each token stamped
    at its final's arrival frame."""
    fused: Dict[int, FrameResponses] = {}
    partials: List[tuple] = []  # (chars, frame) oldest -> newest

    for frame in sorted(responses):
        fr = responses[frame]
        final = fr.final
        if final is not None and final.alternatives:
            hyp = final.alternatives[0]
            chars = [c for piece in hyp.token_seq for c in piece]
            char_seen = []
            for i, ch in enumerate(chars):
                seen = frame
                for p_chars, p_frame in reversed(partials):
                    if i >= len(p_chars):
                        continue
                    if p_chars[i] != ch:
                        break
                    seen = p_frame
                char_seen.append(seen)
            # reduce char frames to per-token frames (a token is readable
            # once its last-arriving character shows)
            tok_seen = []
            pos = 0
            for piece in hyp.token_seq:
                n = len(piece)
                tok_seen.append(
                    max(char_seen[pos:pos + n]) if n else frame
                )
                pos += n
            fused[frame] = FrameResponses(
                partials=None,
                final=DecodingResponse(
                    start_frame_idx=final.start_frame_idx,
                    duration_frames=final.duration_frames,
                    is_provisional=final.is_provisional,
                    alternatives=[HypothesisResponse(
                        y_seq=hyp.y_seq,
                        timesteps=tok_seen,
                        token_seq=hyp.token_seq,
                        confidence=hyp.confidence,
                    )],
                ),
            )
            n_final = len(chars)
            partials = [
                (p_chars[n_final:], p_frame)
                for p_chars, p_frame in partials
                if len(p_chars) > n_final
            ]
        else:
            fused[frame] = FrameResponses(partials=None, final=None)

        if fr.partials is not None and fr.partials.alternatives:
            best = fr.partials.alternatives[0]
            partials.append(
                ([c for piece in best.token_seq for c in piece], frame)
            )

    return fused
