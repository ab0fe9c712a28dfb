"""Sentence-segment manifest transcripts and insert EOS tokens (the port of
``caiman_asr_tpu/data/segment_manifest.py``; reference data/segment_manifest.py).

The reference segments transcripts with a wtpsplit SaT neural model; to
decide whether the *final* segment is a complete sentence (the segmenter
always ends a string at a segment boundary, complete or not), it re-segments
the transcript repeated twice and only trusts boundaries both passes agree
on. This module keeps that exact contract and agreement logic, with two
segmenter backends:

- ``wtpsplit`` SaT when the package is importable (reference behavior);
- a rule-based sentence splitter (terminal ``.!?`` punctuation) otherwise —
  deterministic, dependency-free, and subject to the same repeat-agreement
  test, so end-of-string incompleteness is handled identically.

Manifest entries gain an ``eos_count`` field and the transcript gains one
EOS token per agreed segment boundary.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

from caiman_asr_tpu_torch.utils.user_tokens import is_tag

# A sentence ends at terminal punctuation (plus trailing quotes/brackets),
# followed by whitespace or end of string.
_SENT_RE = re.compile(r".*?[.!?]+[\"')\]]*(?:\s+|$)", re.DOTALL)


def rule_based_segment(text: str) -> List[str]:
    """Split ``text`` into sentence segments, preserving every character
    (``"".join(segments) == text``) like the SaT segmenter does."""
    if not text:
        return [text]
    segments = _SENT_RE.findall(text)
    consumed = sum(len(s) for s in segments)
    if consumed < len(text):
        segments.append(text[consumed:])
    return segments or [text]


def merge_split_words(splits: List[str]) -> List[str]:
    """Fix segments that were split mid-word.

    >>> merge_split_words(["hello ", "wor", "ld"])
    ['hello ', 'world']
    """
    head = splits[:1]
    tail = splits[1:][::-1]
    while tail:
        nxt = tail.pop()
        if head[-1].endswith(" ") or nxt.startswith(" "):
            head.append(nxt)
        else:
            head[-1] += nxt
    return head


def make_eos_for(eos_token: str) -> Callable[[str], str]:
    """Return a function producing the EOS insertion text for a segment."""
    stripped = eos_token.strip()

    def eos_for(seg: str) -> str:
        if seg.endswith(" "):
            return f"{stripped} "
        return f" {stripped}"

    return eos_for


def build_transcript(
    splits: List[str], rep_splits: List[str], eos_for: Callable[[str], str]
) -> Tuple[int, str]:
    """Insert EOS tokens where the single and repeated segmentations agree
    (reference segment_manifest.py:105-146); returns (eos_count, transcript).
    """
    eos_count = sum(
        1 for a, b in zip(splits, rep_splits) if a.strip() == b.strip()
    )

    out: List[str] = []
    if eos_count == 0 and len(splits) > 1:
        # No agreement at all: empirically a transcript cut off mid-sentence.
        # Trust the non-repeated segmentation except for its final boundary.
        for a in splits[:-1]:
            out.append(a)
            out.append(eos_for(a))
            eos_count += 1
        out.append(splits[-1])
    else:
        for a, b in zip(splits, rep_splits):
            out.append(a)
            if a.strip() == b.strip():
                out.append(eos_for(a))
    return eos_count, "".join(out).strip()


def _make_segmenter(use_accel: bool) -> Callable[[List[str]], List[List[str]]]:
    """SaT batch segmenter when wtpsplit is available, else the rule-based
    splitter mapped over the batch."""
    try:  # pragma: no cover - absent in this environment
        from wtpsplit import SaT

        sat = SaT("sat-12l-sm")
        if use_accel:
            import torch

            if torch.cuda.is_available():
                sat.half().to("cuda")
        return lambda texts: list(sat.split(texts))
    except ImportError:
        return lambda texts: [rule_based_segment(t) for t in texts]


def add_eos_to_manifest(
    manifest: List[Dict], eos_token: str, use_accel: bool = False
) -> List[Dict]:
    """Manifest -> manifest: segment each transcript, add one EOS token per
    agreed sentence boundary, and record ``eos_count`` per utterance."""
    if not is_tag(eos_token):
        raise ValueError(f"EOS token must be a tag, got {eos_token!r}")

    segment = _make_segmenter(use_accel)
    single = [x["transcript"].strip() for x in manifest]
    # Also segment the transcript repeated twice: boundaries that survive in
    # the first half are real sentence ends, not end-of-string artifacts.
    repeat = [" ".join([x, x]) for x in single]

    split_single = segment(single)
    split_repeat = segment(repeat)
    eos_for = make_eos_for(eos_token)

    for s, r, m in zip(split_single, split_repeat, manifest):
        n, out = build_transcript(
            merge_split_words(s), merge_split_words(r), eos_for
        )
        m["transcript"] = out
        m["eos_count"] = n
    return manifest


def add_eos_to_manifest_avoid_empty(
    manifest: List[Dict], eos_token: str, use_accel: bool = False
) -> List[Dict]:
    """Whitespace-only transcripts pass through unmodified (the segmenter
    rejects empty input). Manifest order is preserved: entries are segmented
    in place, not moved to the end."""
    has_text = [u for u in manifest if u["transcript"].strip() != ""]
    add_eos_to_manifest(has_text, eos_token, use_accel)  # mutates in place
    return manifest
