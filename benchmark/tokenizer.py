"""The streaming cells' piece table: a copy of
``caiman_asr_tpu_torch/bench_serving.bench_tokenizer`` (itself after
``bench.py:216-240``): 8,703 syllable-shaped pieces of ~4.5 characters,
~55% word-initial (with the ``▁`` marker), the shape of the reference's
LibriSpeech vocabulary, and an empty blank.

One change: every piece ends in an apostrophe, which no piece has
elsewhere, so that a served transcript splits back into its tokens without
ambiguity (the check reads the tokens out of the wire responses)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

END = "'"


class PieceTokenizer:
    """A piece table behind ``id_to_piece``, all the engine's responses read."""

    def __init__(self, pieces: List[str]):
        self._pieces = pieces
        # the serializer writes the word marker as a space
        self.ids: Dict[str, int] = {p.replace("▁", " "): i for i, p in enumerate(pieces) if p}

    def id_to_piece(self, i: int) -> str:
        return self._pieces[i]

    def split(self, text: str) -> List[int]:
        """A served transcript back into its token ids."""
        parts = text.split(END)
        if parts[-1]:
            raise ValueError(f"a transcript that does not end a piece: {text!r}")
        return [self.ids[p + END] for p in parts[:-1]]


def bench_tokenizer(n_classes: int) -> PieceTokenizer:
    rng = np.random.default_rng(8703)
    vowels, cons = "aeiou", "bcdfghjklmnprstvwz"
    pieces, seen = [], set()
    while len(pieces) < n_classes - 1:
        w = "".join(cons[int(rng.integers(len(cons)))] + vowels[int(rng.integers(len(vowels)))]
                    for _ in range(int(rng.integers(1, 4))))
        if rng.random() < 0.3:
            w += cons[int(rng.integers(len(cons)))]
        if rng.random() < 0.55:
            w = "▁" + w
        if w in seen:
            continue
        seen.add(w)
        pieces.append(w + END)
    pieces.append("")
    return PieceTokenizer(pieces)
