"""n-gram language model for shallow fusion (the port's own copy of
``caiman_asr_tpu/lm/ngram.py``; reference: lm/kenlm_ngram.py).

The reference wraps the kenlm C++ library; here a self-contained ARPA
n-gram scorer with Katz backoff. Scores are returned in natural log to
match the reference's ``lm_score_scale = 1/log10(e)`` conversion
(kenlm_ngram.py:19-31). Tokens are sentencepiece *pieces* (the LM is built
over tokenized text, lm/prep_kenlm_data.py).

Supports .arpa text files and a fast .npz cache (``NGramLM.save_binary``)
standing in for kenlm's .binary format. Reading kenlm's own binary format
(the JAX package's ``lm/kenlm_binary.py``) is not ported: ``NGramLM.load``
raises ``NotImplementedError`` on such a file.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

LN10 = math.log(10.0)
UNK = "<unk>"
BOS = "<s>"


class NgramScorerMixin:
    """Shared shallow-fusion scoring interface: ``score(word, state)`` over
    a tuple-of-pieces state. Implementors provide ``self.order`` and
    ``_logprob_pieces(ngram: tuple[str, ...]) -> float`` (natural log)."""

    def initial_state(self) -> Tuple[str, ...]:
        """Begin-sentence state (kenlm BeginSentenceWrite)."""
        return (BOS,)

    def score(
        self, word: str, state: Optional[Tuple[str, ...]]
    ) -> Tuple[float, Tuple[str, ...]]:
        """ln P(word | state); returns (score, new_state)."""
        state = state or ()
        ngram = (state + (word,))[-self.order:]
        lp = self._logprob_pieces(ngram)
        new_state = (state + (word,))[-(self.order - 1):] if self.order > 1 else ()
        return lp, new_state

    # reference-API alias (kenlm_ngram.py:23-31)
    score_ngram = score


class NGramLM(NgramScorerMixin):
    def __init__(
        self,
        probs: Dict[Tuple[str, ...], float],
        backoffs: Dict[Tuple[str, ...], float],
        order: int,
    ):
        self.probs = probs          # natural-log probabilities
        self.backoffs = backoffs    # natural-log backoff weights
        self.order = order
        self._unk = probs.get((UNK,), -99.0 * LN10)

    # ----------------------------------------------------------------- io
    # kenlm binary files open with this sentinel (kenlm util/file_piece +
    # lm/binary_format.cc); reference deployments ship such artifacts
    # (lm/kenlm_ngram.py:10-48 loads .arpa OR kenlm .binary).
    _KENLM_MAGIC = b"mmap lm http://kheafield.com/code"

    @classmethod
    def load(cls, path: str | Path):
        """Load .arpa text or our .npz cache (any suffix). The format is
        sniffed from magic bytes, not the suffix: a reference deployment's
        'ngram.binary' is kenlm wire format, while save_binary() writes an
        npz under the same conventional name. A kenlm binary raises
        ``NotImplementedError`` (its reader, ``lm/kenlm_binary.py`` in the
        JAX package, is not ported)."""
        path = Path(path)
        with open(path, "rb") as fh:
            head = fh.read(len(cls._KENLM_MAGIC))
        if head.startswith(cls._KENLM_MAGIC):
            raise NotImplementedError(
                f"{path} is a kenlm binary: its reader (lm/kenlm_binary.py) is not "
                "ported; pass the ARPA file or an npz written by NGramLM.save_binary")
        if head.startswith(b"PK"):  # zip container = numpy savez
            return cls._load_npz(path)
        return cls._load_arpa(path)

    @classmethod
    def _load_arpa(cls, path: Path) -> "NGramLM":
        probs: Dict[Tuple[str, ...], float] = {}
        backoffs: Dict[Tuple[str, ...], float] = {}
        order = 1
        cur_n = 0
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("\\data\\"):
                    continue
                if line.startswith("\\end\\"):
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    cur_n = int(line[1:].split("-")[0])
                    order = max(order, cur_n)
                    continue
                if line.startswith("ngram "):
                    continue
                if cur_n == 0:
                    continue
                parts = line.split("\t")
                if len(parts) == 1:
                    parts = line.split()
                    lp, words = parts[0], parts[1 : 1 + cur_n]
                    bo = parts[1 + cur_n] if len(parts) > 1 + cur_n else None
                else:
                    lp = parts[0]
                    words = tuple(parts[1].split())
                    bo = parts[2] if len(parts) > 2 else None
                ng = tuple(words)
                if len(ng) != cur_n:
                    continue
                probs[ng] = float(lp) * LN10
                if bo is not None:
                    backoffs[ng] = float(bo) * LN10
        return cls(probs, backoffs, order)

    @classmethod
    def _load_npz(cls, path: Path) -> "NGramLM":
        with np.load(path, allow_pickle=False) as z:
            order = int(z["order"])
            keys = [k.decode("utf-8") for k in z["keys"]]
            probs_v = z["probs"]
            backoff_v = z["backoffs"]  # NaN = no backoff
        probs, backoffs = {}, {}
        for k, p, b in zip(keys, probs_v, backoff_v):
            ng = tuple(k.split("\x1f"))
            probs[ng] = float(p)
            if not math.isnan(b):
                backoffs[ng] = float(b)
        return cls(probs, backoffs, order)

    def save_binary(self, path: str | Path):
        keys = ["\x1f".join(ng).encode("utf-8") for ng in self.probs]
        probs = np.asarray(list(self.probs.values()), np.float32)
        backoffs = np.asarray(
            [self.backoffs.get(ng, math.nan) for ng in self.probs], np.float32
        )
        with open(path, "wb") as fh:  # keep the exact name (.binary, no .npz)
            np.savez(
                fh,
                order=np.int32(self.order),
                keys=np.asarray(keys, dtype="S"),
                probs=probs,
                backoffs=backoffs,
            )

    # ------------------------------------------------------------- scoring
    def _logprob(self, ngram: Tuple[str, ...]) -> float:
        if ngram in self.probs:
            return self.probs[ngram]
        if len(ngram) == 1:
            return self._unk
        return self.backoffs.get(ngram[:-1], 0.0) + self._logprob(ngram[1:])

    _logprob_pieces = _logprob


def find_ngram_path(base_path: str) -> Optional[str]:
    """'ngram.binary' (npz cache) then 'ngram.arpa' in a directory
    (reference kenlm_ngram.py:40-48)."""
    for name in ("ngram.binary", "ngram.arpa"):
        p = os.path.join(base_path, name)
        if os.path.exists(p):
            return p
    return None
