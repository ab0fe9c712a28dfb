"""Transcript normalisation (the port's copy of
``caiman_asr_tpu/data/text/normalize.py``): ``normalize_transcript`` at a
``NormalizeLevel``, applied before tokenisation and to the references an
evaluation scores against, and ``standardize_text``, the Whisper-style pass
that makes WER comparable across punctuation and formatting.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Sequence

_TAG_RE = re.compile(r"<[^<>\s]+>")
_SPACE_RE = re.compile(r"\s+")


class NormalizeLevel(Enum):
    """Reference: data/text/normalizers.py NormalizeLevel options."""

    IDENTITY = 0
    SCRUB = 1       # remove tags / apply replacements only
    LOWERCASE = 2   # + lowercase
    UNICODE = 3     # + unicode -> ascii fold
    FULL = 4        # + restrict to charset, collapse whitespace


@dataclass(frozen=True)
class NormalizeConfig:
    level: NormalizeLevel = NormalizeLevel.FULL
    replacements: Sequence[dict] = field(default_factory=tuple)
    remove_tags: bool = True
    user_symbols: Sequence[str] = field(default_factory=tuple)
    verbalize_numbers: bool = True  # digits -> words (reference ito cleaners)


def _ascii_fold(text: str) -> str:
    out = unicodedata.normalize("NFKD", text)
    return "".join(c for c in out if not unicodedata.combining(c))


def normalize_transcript(
    text: str,
    charset: Sequence[str],
    config: NormalizeConfig = NormalizeConfig(),
) -> str:
    """Normalize one transcript for training/tokenization.

    ``user_symbols`` (e.g. "<EOS>") are shielded from normalization by
    temporary placeholders (reference: preprocess.py:28-47).
    """
    level = config.level
    if level == NormalizeLevel.IDENTITY:
        return text

    masks: Dict[str, str] = {}
    for i, sym in enumerate(config.user_symbols):
        # letters-only placeholder so it survives charset filtering
        placeholder = f"zqxmask{chr(ord('a') + i)}zqx"
        masks[placeholder] = sym
        text = text.replace(sym, f" {placeholder} ")

    for rep in config.replacements or ():
        text = re.sub(rep["old"], rep["new"], text)
    if config.remove_tags:
        text = _TAG_RE.sub(" ", text)

    if level.value >= NormalizeLevel.LOWERCASE.value:
        text = text.lower()
    if level.value >= NormalizeLevel.UNICODE.value:
        text = _ascii_fold(text)
    if level.value >= NormalizeLevel.FULL.value:
        if config.verbalize_numbers and any(c.isdigit() for c in text):
            from caiman_asr_tpu_torch.data.text.numbers import verbalize_numbers

            text = verbalize_numbers(text)
        allowed = set(charset)
        text = "".join(c if c in allowed or c == " " else " " for c in text)
    text = _SPACE_RE.sub(" ", text).strip()

    for placeholder, sym in masks.items():
        text = text.replace(placeholder, sym)
    return text


def standardize_text(text: str) -> str:
    """Standardize a transcript for WER comparison.

    A Whisper-BasicTextNormalizer-style pass (reference:
    data/text/whisper_basic_normalizer.py usage in evaluate/metrics.py):
    lowercase, strip bracketed asides, expand common contractions, drop
    punctuation (keeping intra-word apostrophes first for contraction
    matching), fold unicode, collapse whitespace.
    """
    from caiman_asr_tpu_torch.data.text.english_normalizer import english_normalizer

    text = _TAG_RE.sub(" ", text)
    return english_normalizer(text)
