"""WER standardisation (the port's copy of ``standardize_text`` in
``caiman_asr_tpu/data/text/normalize.py``, what ``evaluate/wer.py`` needs).

The training normalisation (``normalize_transcript``, ``NormalizeConfig``)
is not ported yet.
"""

from __future__ import annotations

import re

_TAG_RE = re.compile(r"<[^<>\s]+>")


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
