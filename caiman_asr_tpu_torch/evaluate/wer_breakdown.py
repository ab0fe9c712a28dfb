"""WER breakdown by character class (reference: evaluate/wer_breakdown.py).

Reports how much of the (unstandardized) WER is attributable to casing and
to each punctuation symbol, by recomputing WER with that class removed.

The port's copy of ``caiman_asr_tpu/evaluate/wer_breakdown.py``.
"""

from __future__ import annotations

from typing import Dict, List

from caiman_asr_tpu_torch.evaluate.wer import ErrorRateKind, word_error_rate

DEFAULT_BREAKDOWN_CHARS = ".,?"


def remove_all(text: str, chars: str) -> str:
    return "".join(c for c in text if c not in chars)


def relative_improvement_percent(original: float, better: float) -> float:
    if original == 0:
        return 0.0
    return 100.0 * (original - better) / original


def wer_breakdown(
    hypotheses: List[str],
    references: List[str],
    breakdown_chars: str = DEFAULT_BREAKDOWN_CHARS,
    kind: ErrorRateKind = ErrorRateKind.WORD,
) -> Dict[str, float]:
    """Returns {label: wer} for each transformation."""

    def wer_of(tr):
        return word_error_rate(
            [tr(h) for h in hypotheses], [tr(r) for r in references],
            standardize=False, kind=kind,
        ).wer

    out = {"unstandardized": wer_of(lambda x: x)}
    out["ignore_case"] = wer_of(lambda x: x.lower())
    for ch in breakdown_chars:
        out[f"ignore_{ch!r}"] = wer_of(lambda x, c=ch: x.replace(c, ""))
    out[f"ignore_all_{breakdown_chars!r}"] = wer_of(
        lambda x: remove_all(x, breakdown_chars)
    )
    return out


def print_wer_breakdown(
    hypotheses: List[str],
    references: List[str],
    breakdown_chars: str = DEFAULT_BREAKDOWN_CHARS,
    kind: ErrorRateKind = ErrorRateKind.WORD,
):
    res = wer_breakdown(hypotheses, references, breakdown_chars, kind)
    base = res["unstandardized"]
    print(f"\n{kind.value.upper()} ERROR RATE % (relative improvement %)")
    print("-" * 40)
    for label, wer in res.items():
        print(
            f"{label}: {wer * 100:5.3f}% "
            f"({relative_improvement_percent(base, wer):5.3f}%)"
        )
    return res
