"""Word-level timestamps from token-level decode output
(reference: latency/timestamp.py:9-160).

Tokens carry one decoder-frame index each; words span [min, max] of their
constituent tokens' frames. ``frame_to_time`` converts to seconds with the
reference's off-by-one convention: the user holds frame n after
``(n + 1) * frame_width`` of audio, so a word ending at frame n is *known*
at ``(n + 1) * frame_width`` while starting at ``start_frame * frame_width``.

The port's copy of ``caiman_asr_tpu/latency/timestamp.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Union


@dataclass
class FullStamp:
    """Two clocks for one token (reference
    evaluate/state_resets/timestamp.py:8-25): ``model`` is the decoder frame
    the token was emitted at; ``user_perceived`` is the frame from which the
    token was continuously visible to the user (a partial that later gets
    overwritten does not count — see fuse_partials)."""

    model: int
    user_perceived: int


Timestamp = Union[FullStamp, int]


def model_time(t: Timestamp) -> int:
    return t.model if isinstance(t, FullStamp) else t


def user_perceived_time(t: Timestamp) -> int:
    return t.user_perceived if isinstance(t, FullStamp) else t


def add_frames(t: Timestamp, n: int) -> Timestamp:
    if isinstance(t, FullStamp):
        return FullStamp(t.model + n, t.user_perceived + n)
    return t + n


@dataclass
class Silence:
    """Utterance terminated by VAD silence."""

    final_time: float


@dataclass
class EOS:
    """Utterance terminated by an end-of-sentence token."""

    final_time: float


@dataclass
class Never:
    """Utterance was not terminated early."""


Termination = Union[Silence, EOS, Never]


@dataclass
class PerWordTimestamp:
    word: str
    start_frame: int
    end_frame: int


@dataclass
class WordTimestamps:
    word: str
    start_time: float
    end_time: float


@dataclass
class SequenceTimestamp:
    seqs: List[PerWordTimestamp]
    eos: Termination


def frame_to_time(
    stamp: PerWordTimestamp,
    frame_width: float,
    head_offset: float = 0.0,
    tail_offset: float = 0.0,
) -> WordTimestamps:
    start_time = stamp.start_frame * frame_width
    duration = (stamp.end_frame - stamp.start_frame + 1) * frame_width
    return WordTimestamps(
        word=stamp.word,
        start_time=start_time - head_offset,
        end_time=start_time + duration - tail_offset,
    )


def group_timestamps(
    subwords_list: List[List[str]],
    timestamps_list: List[List[int]],
    sentences: List[str],
    last_emit_time: List[Termination],
) -> List[SequenceTimestamp]:
    """Match subword pieces to the words of the detokenized sentence and
    reduce each word's token frames to a [start, end] span."""
    assert (
        len(sentences)
        == len(subwords_list)
        == len(timestamps_list)
        == len(last_emit_time)
    )
    results = []
    for subwords, timestamps, sentence, term in zip(
        subwords_list, timestamps_list, sentences, last_emit_time
    ):
        words = []
        idx = 0
        for word in sentence.split():
            taken: List[str] = []
            while idx < len(subwords) and "".join(taken).strip() != word:
                if taken or subwords[idx].strip() != "":
                    taken.append(subwords[idx])
                idx += 1
            span = timestamps[idx - len(taken) : idx]
            if not span:
                span = [timestamps[idx - 1]] if idx > 0 and timestamps else [0]
            words.append(PerWordTimestamp(word, min(span), max(span)))
        results.append(SequenceTimestamp(words, term))
    return results
