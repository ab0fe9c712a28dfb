"""Keyword file loading (the port's own copy of
``caiman_asr_tpu/keywords/process.py``; reference: keywords/process.py).

Format: JSON ``{"keywords": {"some phrase": weight, ...}}``; spaces become
the sentencepiece ▁ marker so matching happens on detokenized pieces.
"""

from __future__ import annotations

import json

from caiman_asr_tpu_torch.keywords.trie import Keywords


def load_keywords(path: str) -> Keywords:
    with open(path) as fh:
        data = json.load(fh)
    if "keywords" not in data or not isinstance(data["keywords"], dict):
        raise ValueError('expected {"keywords": {str: number, ...}}')
    for k, v in data["keywords"].items():
        if not isinstance(k, str) or not isinstance(v, (int, float)):
            raise ValueError(f"bad keyword entry: {k!r}: {v!r}")
    vocab = [(k.replace(" ", "▁"), float(v)) for k, v in data["keywords"].items()]
    return Keywords(vocab)
