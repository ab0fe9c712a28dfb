"""What to do with ``<unk>`` (id 0, the sentencepiece convention) in a
tokenized transcript (``caiman_asr_tpu/data/unk_handling.py``): fail, or
warn once per transcript and drop such transcripts."""

from __future__ import annotations

import warnings
from enum import Enum
from typing import List


class UnkHandling(Enum):
    FAIL = "FAIL"
    WARN = "WARN"


_warned = set()


def check_tokenized_transcript(tokens: List[int], transcript: str,
                               unk_handling: UnkHandling) -> None:
    if 0 not in tokens:
        return
    message = f"<unk> found during tokenization (OOV?): {transcript!r}"
    if unk_handling == UnkHandling.FAIL:
        raise ValueError(message + " — set unk_handling=WARN or fix the character set")
    if message not in _warned:
        _warned.add(message)
        warnings.warn(message)


def maybe_filter_transcripts(transcripts: List[List[int]],
                             unk_handling: UnkHandling) -> List[List[int]]:
    if unk_handling == UnkHandling.FAIL:
        return transcripts
    return [t for t in transcripts if 0 not in t]
