"""Word/char error rate (the port of ``caiman_asr_tpu/evaluate/wer.py``;
reference: evaluate/metrics.py, error_rates.py).

The edit distance is the native ``levenshtein`` (the port's copy of
``native/src/flac_decoder.cpp``'s ``levenshtein_i64``, the replacement for
the reference's levenshtein_rs package) over units interned to int ids. A
native build that fails raises. ``levenshtein_plain``, the numpy row DP, is
the plain version the tests hold it against.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Sequence

import numpy as np

from caiman_asr_tpu_torch.data.text.normalize import standardize_text


class ErrorRateKind(Enum):
    WORD = "word"
    CHAR = "char"
    MIXTURE = "mixture"  # per-word chunks of chars (for e.g. Mandarin mixes)


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences of hashable units (native)."""
    from caiman_asr_tpu_torch.native import levenshtein as native_levenshtein

    ids: dict = {}
    ea = [ids.setdefault(u, len(ids)) for u in a]
    return native_levenshtein(ea, [ids.setdefault(u, len(ids)) for u in b])


def levenshtein_plain(a: Sequence, b: Sequence) -> int:
    """The same distance by a numpy row DP."""
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    b_arr = np.array(b, dtype=object)
    prev = np.arange(len(b) + 1)
    idx = np.arange(len(b) + 1)
    for i, ca in enumerate(a, start=1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (b_arr != ca)
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        # Deletion chain cur[j] = min(cur[j], cur[j-1] + 1) is a prefix-min of
        # (cur[j] - j): min over k<=j of cur[k] + (j-k) = j + cummin(cur - idx).
        cur = np.minimum.accumulate(cur - idx) + idx
        prev = cur
    return int(prev[-1])


def _units(text: str, kind: ErrorRateKind) -> List[str]:
    if kind == ErrorRateKind.WORD:
        return text.split()
    if kind == ErrorRateKind.CHAR:
        return list(text)
    # mixture: split words, then alphanumeric words stay whole while CJK-ish
    # chars are separate units.
    units: List[str] = []
    for w in text.split():
        if w.isascii():
            units.append(w)
        else:
            units.extend(list(w))
    return units


@dataclass
class WERResult:
    wer: float
    scores: int  # total edit distance
    num_words: int


def word_error_rate(
    hypotheses: Sequence[str],
    references: Sequence[str],
    standardize: bool = False,
    kind: ErrorRateKind = ErrorRateKind.WORD,
) -> WERResult:
    """Corpus-level error rate (reference: evaluate/metrics.py:21-80)."""
    if len(hypotheses) != len(references):
        raise ValueError(f"{len(hypotheses)} hypotheses for {len(references)} references")
    dist = 0
    words = 0
    for hyp, ref in zip(hypotheses, references):
        if standardize:
            hyp, ref = standardize_text(hyp), standardize_text(ref)
        h, r = _units(hyp, kind), _units(ref, kind)
        dist += levenshtein(h, r)
        words += len(r)
    return WERResult(wer=dist / max(words, 1), scores=dist, num_words=words)
