"""Keyword boosting via a weighted character trie (the port's own copy of
``caiman_asr_tpu/keywords/trie.py``)
(reference: keywords/trie.py:1-203).

Keywords (strings with ▁ as the space marker) are compiled into a trie whose
edges carry cumulative score deltas: walking a keyword accrues its weight per
character; abandoning a partial match refunds the accrued (uncommitted)
score; completing a keyword commits it. The decoding state is the set of
live trie positions with their accumulated scores — every step may also
start a new match from the root.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


class _Node:
    __slots__ = ("term", "edges", "weights")

    def __init__(self):
        self.term: Optional[float] = None   # committed score if keyword ends here
        self.edges: Dict[str, int] = {}     # char -> node index
        self.weights: Dict[str, float] = {}  # char -> score delta on edge


class Keywords:
    """State: dict[node_index, accumulated_uncommitted_score]."""

    State = Dict[int, float]

    def __init__(self, vocab: Iterable[Tuple[str, float]]):
        vocab = list(vocab)
        words = [w for w, _ in vocab]
        assert len(set(words)) == len(words), "Duplicate keywords"
        self.nodes: List[_Node] = [_Node()]
        for word, weight in vocab:
            self._insert(word, weight)

    def _insert(self, word: str, weight: float):
        idx = 0
        acc = 0.0
        for ch in word:
            node = self.nodes[idx]
            if ch not in node.edges:
                node.edges[ch] = len(self.nodes)
                node.weights[ch] = 0.0
                self.nodes.append(_Node())
            # edge deltas accumulate when keywords share prefixes
            node.weights[ch] += weight
            acc += weight
            idx = node.edges[ch]
        assert self.nodes[idx].term is None, "Duplicate keyword"
        self.nodes[idx].term = acc

    @classmethod
    def init(cls) -> "Keywords.State":
        return {0: 0.0}

    def step(self, ch: str, state: "Keywords.State") -> Tuple[float, "Keywords.State"]:
        assert 0 in state, "state must always contain the root"
        new_state = Keywords.init()
        delta = 0.0
        for idx, acc in state.items():
            node = self.nodes[idx]
            if node.term is not None:
                # completed keyword: commit its score (stop tracking it as
                # refundable)
                acc = acc - node.term
            nxt = node.edges.get(ch)
            if nxt is None:
                delta -= acc  # abandoned match: refund uncommitted score
            else:
                w = node.weights[ch]
                prev = new_state.get(node.edges[ch], None)
                cand = acc + w
                # keep the better-scoring thread if two converge
                if prev is None or cand > prev:
                    new_state[node.edges[ch]] = cand
                delta += w
        return delta, new_state

    def steps(self, text: str, state: "Keywords.State") -> Tuple[float, "Keywords.State"]:
        total = 0.0
        for ch in text:
            d, state = self.step(ch, state)
            total += d
        return total, state
