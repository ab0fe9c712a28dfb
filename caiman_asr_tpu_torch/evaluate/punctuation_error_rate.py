"""Punctuation error rates (reference: evaluate/punctuation_error_rate.py,
OccurancePunctuationErrorRate / DatasetPunctuationErrorRate).

For each punctuation symbol, counts correct / deletion / insertion /
substitution occurrences by difflib-aligning the punctuation-bearing token
streams of reference vs hypothesis, then reports per-symbol rates and an
overall punctuation error rate:

  per-symbol rate = (del + ins + sub) / (correct + del + ins + sub)

The port's copy of ``caiman_asr_tpu/evaluate/punctuation_error_rate.py``.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

DEFAULT_PUNCTUATION = ".,?!"


def _tokenize_punct(text: str, puncts: str) -> List[str]:
    """Split text into words; punctuation marks become their own tokens."""
    out: List[str] = []
    for word in text.split():
        core = word
        trail: List[str] = []
        while core and core[-1] in puncts:
            trail.append(core[-1])
            core = core[:-1]
        if core:
            out.append(core.lower())
        out.extend(reversed(trail))
    return out


@dataclass
class PunctCounts:
    correct: int = 0
    deletions: int = 0
    insertions: int = 0
    substitutions: int = 0

    @property
    def total(self) -> int:
        return self.correct + self.deletions + self.insertions + self.substitutions

    @property
    def rate(self) -> float:
        t = self.total
        return (self.deletions + self.insertions + self.substitutions) / t if t else 0.0


def punctuation_error_rate(
    references: Sequence[str],
    hypotheses: Sequence[str],
    punctuation: str = DEFAULT_PUNCTUATION,
) -> Dict[str, PunctCounts]:
    """Per-symbol counts plus an 'overall' entry."""
    counts: Dict[str, PunctCounts] = {p: PunctCounts() for p in punctuation}
    for ref, hyp in zip(references, hypotheses):
        r = _tokenize_punct(ref, punctuation)
        h = _tokenize_punct(hyp, punctuation)
        sm = difflib.SequenceMatcher(a=r, b=h, autojunk=False)
        for op, a0, a1, b0, b1 in sm.get_opcodes():
            if op == "equal":
                for t in r[a0:a1]:
                    if t in counts:
                        counts[t].correct += 1
            elif op == "delete":
                for t in r[a0:a1]:
                    if t in counts:
                        counts[t].deletions += 1
            elif op == "insert":
                for t in h[b0:b1]:
                    if t in counts:
                        counts[t].insertions += 1
            else:  # replace
                rp = [t for t in r[a0:a1] if t in counts]
                hp = [t for t in h[b0:b1] if t in counts]
                for i in range(min(len(rp), len(hp))):
                    counts[rp[i]].substitutions += 1
                for t in rp[len(hp):]:
                    counts[t].deletions += 1
                for t in hp[len(rp):]:
                    counts[t].insertions += 1
    overall = PunctCounts(
        correct=sum(c.correct for c in counts.values()),
        deletions=sum(c.deletions for c in counts.values()),
        insertions=sum(c.insertions for c in counts.values()),
        substitutions=sum(c.substitutions for c in counts.values()),
    )
    counts["overall"] = overall
    return counts
