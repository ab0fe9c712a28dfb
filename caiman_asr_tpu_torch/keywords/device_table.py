"""Dense device automaton for keyword boosting on the device (the port's own
copy of ``caiman_asr_tpu/keywords/device_table.py``; numpy tables).

The host adaptive beam boosts keywords by walking a weighted character trie
per expansion (keywords/trie.py, reference rnnt/beam.py:614-627) — Python
dict threads, impossible inside a jitted device beam. This module
determinizes that trie into two dense tables

  score[S, K]       boost delta for emitting token k from state s
                    (edge weights accrued - abandoned-match refunds,
                    completed keywords committed)
  next_state[S, K]  automaton transition

over S = trie nodes and K = tokenizer vocab, the same shape as the n-gram
automaton (lm/device_table.py), so the jitted beam (decoding/fast_beam.py)
boosts keywords with two gathers per expansion.

Why determinization is exact: the trie decode state is the set of live
match threads {node: uncommitted score}. A thread at node n exists after
consuming text s iff path(n) is a suffix of s (threads spawn at every
character and walk greedily), so the live set is fully determined by the
LONGEST matched node — the Aho-Corasick state — and each thread's
uncommitted score is a per-node constant (its path's edge weights minus
terms committed along the way). Tables are built by reconstructing every
state's live-thread dict and running the HOST trie (Keywords.steps) on it,
so device and host semantics are identical by construction.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from caiman_asr_tpu_torch.keywords.trie import Keywords


class DeviceKeywords(NamedTuple):
    score: np.ndarray       # [S, K] float32 boost deltas
    next_state: np.ndarray  # [S, K] int32
    init_state: int         # root

    @property
    def n_states(self) -> int:
        return self.score.shape[0]

    def nbytes(self) -> int:
        return self.score.nbytes + self.next_state.nbytes


def _paths(kw: Keywords) -> List[str]:
    """Root->node character path per trie node."""
    paths = [""] * len(kw.nodes)
    stack = [0]
    while stack:
        i = stack.pop()
        for ch, j in kw.nodes[i].edges.items():
            paths[j] = paths[i] + ch
            stack.append(j)
    return paths


def _sitting_scores(kw: Keywords) -> List[float]:
    """Uncommitted score of a thread sitting at each node: path edge
    weights minus terms committed at terminal nodes stepped THROUGH
    (a node's own term commits only when stepping onward — trie.py:65-68)."""
    acc = [0.0] * len(kw.nodes)
    stack = [0]
    while stack:
        i = stack.pop()
        node = kw.nodes[i]
        base = acc[i] - (node.term if node.term is not None else 0.0)
        for ch, j in node.edges.items():
            acc[j] = base + node.weights[ch]
            stack.append(j)
    return acc


def state_dict(kw: Keywords, state_id: int) -> Dict[int, float]:
    """Reconstruct the host-trie thread dict represented by ``state_id``
    (the longest live node): every node whose path is a suffix of
    path(state_id), with its sitting score."""
    paths = _paths(kw)
    acc = _sitting_scores(kw)
    s = paths[state_id]
    return {
        n: acc[n]
        for n, p in enumerate(paths)
        if s.endswith(p)  # "" (root) is a suffix of everything
    }


def build_keyword_tables(
    kw: Keywords, pieces: Sequence[str], skip_ids: Sequence[int] = ()
) -> DeviceKeywords:
    """Compile ``kw`` over a token vocabulary (token id -> sentencepiece
    piece string, ▁ as the word marker — the same text the host beam feeds
    ``Keywords.steps``). ``skip_ids``: columns that must be neutral (blank —
    it never emits, but its column rides the fused preselection): score 0,
    state unchanged."""
    S, K = len(kw.nodes), len(pieces)
    paths = _paths(kw)
    depth = [len(p) for p in paths]
    states = [state_dict(kw, s) for s in range(S)]

    # distinct pieces share one walk; duplicate ids share the column values
    piece_cols: Dict[str, List[int]] = {}
    for k, p in enumerate(pieces):
        piece_cols.setdefault(p, []).append(k)

    skip = set(int(i) for i in skip_ids)
    score = np.zeros((S, K), np.float32)
    next_state = np.zeros((S, K), np.int32)
    for s in range(S):
        for piece, cols in piece_cols.items():
            delta, new = kw.steps(piece, dict(states[s]))
            nxt = max(new, key=lambda n: depth[n])  # longest live node
            for k in cols:
                if k in skip:
                    continue
                score[s, k] = delta
                next_state[s, k] = nxt
        for k in skip:
            next_state[s, k] = s
    return DeviceKeywords(score=score, next_state=next_state, init_state=0)
