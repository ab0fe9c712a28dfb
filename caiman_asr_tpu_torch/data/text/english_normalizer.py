"""Whisper-style English text normalizer for WER standardization (the
port's copy of ``caiman_asr_tpu/data/text/english_normalizer.py``).

Functional equivalent of the normalizer the reference vendors from OpenAI
Whisper (data/text/whisper_text_normalizer.py): drop filler words, expand
contractions and spoken titles, normalize possessives, strip
symbols/diacritics, verbalize numbers, collapse whitespace. (Whisper's
67k-entry British→American spelling table is omitted; both hypothesis and
reference pass through the same transform, so WER comparisons stay fair.)
"""

from __future__ import annotations

import re
import unicodedata

_FILLERS = r"\b(hmm+|mm+|mhm+|uh+|um+|mmhmm|uhhuh|huh|erm?)\b"

_REPLACERS = {
    r"\bwon't\b": "will not",
    r"\bcan't\b": "can not",
    r"\blet's\b": "let us",
    r"\blemme\b": "let me",
    r"\bdunno\b": "do not know",
    r"\by'all\b": "you all",
    r"\bwanna\b": "want to",
    r"\bkinda\b": "kind of",
    r"\bgotta\b": "got to",
    r"\blotta\b": "lot of",
    r"\bsorta\b": "sort of",
    r"\bgonna\b": "going to",
    r"\bi'ma\b": "i am going to",
    r"\bimma\b": "i am going to",
    r"\bwoulda\b": "would have",
    r"\bcoulda\b": "could have",
    r"\bshoulda\b": "should have",
    r"\bma'am\b": "madam",
    r"\balright\b": "all right",
    r"\bmr\.?\b": "mister",
    r"\bmrs\.?\b": "missus",
    r"\bst\.?\b": "saint",
    r"\bdr\.?\b": "doctor",
    r"\bprof\.?\b": "professor",
    r"\bcapt\.?\b": "captain",
    r"\bgen\.?\b": "general",
    r"\bsen\.?\b": "senator",
    r"\brep\.?\b": "representative",
    r"\brev\.?\b": "reverend",
    r"\blt\.?\b": "lieutenant",
    r"\bsgt\.?\b": "sergeant",
    r"\bcol\.?\b": "colonel",
    r"\bjr\.?\b": "junior",
    r"\bsr\.?\b": "senior",
    # standard contraction suffixes
    r"n't\b": " not",
    r"'re\b": " are",
    r"'ve\b": " have",
    r"'ll\b": " will",
    r"'m\b": " am",
    r"'d\b": " would",
}

_BRACKETS = re.compile(r"[<\[][^>\]]*[>\]]|\([^)]*\)")
_SPACES = re.compile(r"\s+")


def _remove_symbols_and_diacritics(text: str) -> str:
    out = []
    for ch in unicodedata.normalize("NFKD", text):
        cat = unicodedata.category(ch)
        if cat == "Mn":  # combining marks (diacritics)
            continue
        if cat.startswith(("P", "S")) and ch != "'":
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


class EnglishSpellingNormalizer:
    """Word-level British→American mapping. The package ships OpenAI
    Whisper's MIT-licensed 1739-entry ``english.json`` table in-tree
    (``caiman_asr_tpu_torch/data/text/english.json``, a copy of the JAX
    package's) exactly as the reference vendors it (data/text/english.json, loaded at
    whisper_text_normalizer.py:144-160), so default WER standardization
    matches the reference and published Whisper-normalized numbers. A
    custom ``{british: american}`` JSON path overrides it; a missing file
    degrades to identity (both hypothesis and reference pass through the
    same transform, so relative WER comparisons stay fair)."""

    def __init__(self, mapping_path: "str | None" = None):
        import json
        import os

        if mapping_path is None:
            default = os.path.join(os.path.dirname(__file__), "english.json")
            mapping_path = default if os.path.exists(default) else None
        self.mapping = {}
        if mapping_path is not None:
            with open(mapping_path, encoding="utf-8") as fh:
                self.mapping = json.load(fh)

    def __call__(self, text: str) -> str:
        if not self.mapping:
            return text
        return " ".join(self.mapping.get(w, w) for w in text.split())


class EnglishTextNormalizer:
    def __init__(self, spelling_mapping_path: "str | None" = None):
        self.standardize_spellings = EnglishSpellingNormalizer(
            spelling_mapping_path
        )

    def __call__(self, text: str) -> str:
        text = text.lower()
        text = _BRACKETS.sub(" ", text)
        text = re.sub(_FILLERS, "", text)
        for pattern, repl in _REPLACERS.items():
            text = re.sub(pattern, repl, text)
        # possessives: keep the word, drop the 's marker
        text = re.sub(r"(\w)'s\b", r"\1s", text)
        text = re.sub(r"s'\b", "s", text)
        if any(c.isdigit() for c in text):
            from caiman_asr_tpu_torch.data.text.numbers import verbalize_numbers

            text = verbalize_numbers(text)
        text = _remove_symbols_and_diacritics(text)
        text = text.replace("'", "")
        text = self.standardize_spellings(text)
        return _SPACES.sub(" ", text).strip()


english_normalizer = EnglishTextNormalizer()
