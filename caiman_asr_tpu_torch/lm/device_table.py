"""Dense device automaton for n-gram shallow fusion on the device (the
port's own copy of ``caiman_asr_tpu/lm/device_table.py``; the tables stay
numpy until a decoder moves them to its device).

The adaptive host beam scores the LM per expansion with Python dict lookups
(lm/ngram.py) — fine on the host, impossible inside a jitted device beam.
This module compiles an ``NGramLM`` into two dense device tables

  score[S, K]       natural-log P(token | state), backoff fully resolved
  next_state[S, K]  automaton transition

over S = reachable contexts and K = tokenizer vocab, so the jitted beam
(decoding/fast_beam.py) does LM fusion with two gathers per expansion.
The reference gets its beam WER gains exactly from this fusion
(rnnt/beam.py:496,629-642 via kenlm); here the lookup is a table gather
instead of a kenlm trie walk.

Correctness note (why dense truncation is exact): in a well-formed ARPA
model every n-gram's (n-1)-gram prefix is itself listed, so a context that
is not a listed key can never carry explicit continuations or a backoff
weight — scoring from the longest *listed* suffix is therefore identical
to scoring from the raw tuple state (the recursion in NGramLM._logprob
walks the same chain with zero-weight backoffs).

Table construction is vectorised per state row (one numpy row op per
state, not one dict lookup per (state, token) pair): row(s) is the
backoff-weighted parent row overwritten at explicit continuations.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from caiman_asr_tpu_torch.lm.ngram import BOS, NGramLM


class DeviceNgram(NamedTuple):
    score: np.ndarray       # [S, K] float32, natural log
    next_state: np.ndarray  # [S, K] int32
    init_state: int         # id of the begin-sentence state

    @property
    def n_states(self) -> int:
        return self.score.shape[0]

    def nbytes(self) -> int:
        return self.score.nbytes + self.next_state.nbytes


def build_device_tables(
    lm: NGramLM,
    pieces: Sequence[str],
    skip_ids: Sequence[int] = (),
) -> DeviceNgram:
    """Compile ``lm`` over a token vocabulary given by ``pieces`` (token id
    -> sentencepiece piece string; the LM is trained over pieces, reference
    lm/prep_kenlm_data.py).

    ``skip_ids``: token columns the LM must not score or advance on (blank,
    user/meta tokens — reference beam.py:494-497 skips fusion for them):
    score 0, state unchanged.
    """
    if not hasattr(lm, "probs"):
        raise TypeError("build_device_tables needs an NGramLM with explicit n-gram dicts")
    K = len(pieces)
    order = lm.order

    # ---- states: root + every listed ngram shorter than the model order,
    # sorted so suffix parents precede their extensions
    ctxs = sorted(
        (ng for ng in lm.probs if len(ng) < order), key=lambda t: (len(t), t)
    )
    states: List[Tuple[str, ...]] = [()] + ctxs
    sid: Dict[Tuple[str, ...], int] = {s: i for i, s in enumerate(states)}
    S = len(states)

    # ---- token id <-> LM word wiring
    word_col: Dict[str, List[int]] = {}
    for k, p in enumerate(pieces):
        word_col.setdefault(p, []).append(k)
    skip = np.zeros(K, bool)
    if len(skip_ids):
        skip[np.asarray(list(skip_ids), np.int64)] = True

    # ---- per-context explicit continuations (token-id indexed)
    cont_tok: Dict[int, List[int]] = {}
    cont_val: Dict[int, List[float]] = {}
    for ng, lp in lm.probs.items():
        if len(ng) == 1:
            continue  # unigrams live in the root row below
        ctx, w = ng[:-1], ng[-1]
        ci = sid.get(ctx)
        if ci is None:
            continue  # unreachable context (malformed ARPA); see module note
        for k in word_col.get(w, ()):
            cont_tok.setdefault(ci, []).append(k)
            cont_val.setdefault(ci, []).append(lp)

    score = np.empty((S, K), np.float32)
    # root row: unigrams, unk for out-of-LM pieces
    root = np.full(K, lm._unk, np.float32)
    for w, cols in word_col.items():
        lp = lm.probs.get((w,))
        if lp is not None:
            for k in cols:
                root[k] = lp
    root[skip] = 0.0
    score[0] = root

    # child rows in suffix order: backoff(s) + row(longest listed suffix of
    # s[1:]), overwritten at explicit continuations
    def parent_id(s: Tuple[str, ...]) -> int:
        t = s[1:]
        while t and t not in sid:
            t = t[1:]
        return sid.get(t, 0)

    for i in range(1, S):
        s = states[i]
        # `+` already allocates a fresh row — safe to mutate in place
        row = score[parent_id(s)] + np.float32(lm.backoffs.get(s, 0.0))
        ti = cont_tok.get(i)
        if ti is not None:
            row[np.asarray(ti, np.int64)] = np.asarray(cont_val[i], np.float32)
        row[skip] = 0.0
        score[i] = row

    # ---- transitions. D(p)[k] = id of p+(piece_k,) if listed else D(p[1:]);
    # full-length contexts transition through their suffix (the appended
    # (order)-tuple truncates its first word).
    ext_rows = np.empty((S, K), np.int32)  # D(p) for every state p
    # D(()): (w,) if listed
    d_root = np.zeros(K, np.int32)
    for w, cols in word_col.items():
        j = sid.get((w,))
        if j is not None:
            for k in cols:
                d_root[k] = j
    ext_rows[0] = d_root
    # children contributions: state c (len>=2) extends its prefix c[:-1]
    ext_explicit: Dict[int, List[Tuple[int, int]]] = {}
    for c, j in sid.items():
        if len(c) >= 2:
            pi = sid.get(c[:-1])
            if pi is not None:
                for k in word_col.get(c[-1], ()):
                    ext_explicit.setdefault(pi, []).append((k, j))
    for i in range(1, S):
        s = states[i]
        row = ext_rows[parent_id(s)].copy()
        for k, j in ext_explicit.get(i, ()):
            row[k] = j
        ext_rows[i] = row

    next_state = np.empty((S, K), np.int32)
    for i, s in enumerate(states):
        src = i if len(s) <= order - 2 else parent_id(s)
        row = ext_rows[src].copy()
        row[skip] = i
        next_state[i] = row

    init = sid.get((BOS,), 0)
    return DeviceNgram(score=score, next_state=next_state, init_state=init)
