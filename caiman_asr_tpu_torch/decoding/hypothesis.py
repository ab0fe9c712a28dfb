"""Beam-search hypotheses (the port's own copy of
``caiman_asr_tpu/decoding/hypothesis.py``; reference: rnnt/hypothesis.py:36-189).

A hypothesis is host-side bookkeeping: token ids/strings/times/probs, the
cumulative log-prob score, an int hash of the *emitted text* used for
duplicate merging, and per-hypothesis model states (prediction-net (h, c)
slices, optional n-gram / keyword-trie states).

Hash semantics match the reference: the hash folds in each character of the
detokenized piece, except that a piece-initial sentencepiece underscore is
skipped when the previous piece already ended in one (so "a_" + "_b" and
"a" + "_b" merge, hypothesis.py:97-107 + beam.py:_get_token_str).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

SPU = "▁"  # sentencepiece space marker
_MAX_UNICODE = 0x10FFFF
_HASHSIZE = 1_000_000_039  # prime modulus for the rolling hash
SOS_TOKEN = -1


@dataclass
class Hypothesis:
    score: float
    p_seq: List[float]
    y_seq: List[int]
    timesteps: List[int]
    s_seq: List[str]
    hashval: int
    pred_state: Optional[Tuple[Any, Any]]  # (h, c), [L, H] numpy slices
    y_len_t: int = 0          # non-blank tokens emitted at the current frame
    is_terminal: bool = False
    ngram_state: Any = None
    kws_state: Any = None
    prev_length: int = 0      # tokens already shipped as finals (truncated)

    @property
    def y_last(self) -> int:
        return self.y_seq[-1]

    @property
    def y_length_tot(self) -> int:
        return len(self.y_seq) + self.prev_length

    @property
    def transcript(self) -> str:
        return token_strs_to_transcript(self.s_seq[1:])

    def normalised_score(self) -> float:
        return self.score / self.y_length_tot

    def update_hash(self, text: str):
        h = self.hashval
        for ch in text:
            h = (h * _MAX_UNICODE + ord(ch)) % _HASHSIZE
        self.hashval = h

    def truncate(self, tkn_idx: int):
        """Drop tokens before ``tkn_idx`` (they were shipped as a final); the
        token at tkn_idx-1 is kept as the ignored head sentinel."""
        keep_from = tkn_idx - 1
        self.prev_length += keep_from
        self.p_seq = self.p_seq[keep_from:]
        self.s_seq = self.s_seq[keep_from:]
        self.y_seq = self.y_seq[keep_from:]
        self.timesteps = self.timesteps[keep_from:]

    def clone(self) -> "Hypothesis":
        return Hypothesis(
            score=self.score,
            p_seq=list(self.p_seq),
            y_seq=list(self.y_seq),
            timesteps=list(self.timesteps),
            s_seq=list(self.s_seq),
            hashval=self.hashval,
            pred_state=self.pred_state,  # shared (immutable slices)
            y_len_t=self.y_len_t,
            is_terminal=self.is_terminal,
            ngram_state=self.ngram_state,
            kws_state=copy.deepcopy(self.kws_state),
            prev_length=self.prev_length,
        )


def token_strs_to_transcript(tokens: List[str]) -> str:
    return "".join(tokens).replace(SPU, " ").strip()


def init_sos_hyp(ngram_lm=None, keywords=None) -> Hypothesis:
    return Hypothesis(
        score=0.0,
        p_seq=[1.0],
        y_seq=[SOS_TOKEN],
        timesteps=[-1],
        s_seq=[SPU],
        hashval=0,
        pred_state=None,
        y_len_t=1,
        ngram_state=ngram_lm.initial_state() if ngram_lm is not None else None,
        kws_state=keywords.init() if keywords is not None else None,
    )
