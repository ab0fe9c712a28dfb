"""Subword tokenizer (the port of ``caiman_asr_tpu/data/tokenizer.py``):
SentencePiece ``.model`` files (or their bytes, as a serving bundle carries
them) read and written by a minimal protobuf wire-format reader and writer,
unigram Viterbi encoding word by word, subword-regularisation sampling, the
``Tokenizer`` facade (``tokenize``, ``detokenize``, ``id_to_piece``), and a
unigram-style trainer (``train_tokenizer``) with the JSON and ``.model``
writers. No native dependency: the ``sentencepiece`` package is not
needed.

Conventions match SentencePiece's defaults: piece 0 is ``<unk>``,
word-initial pieces carry the U+2581 ``▁`` marker, and ``num_labels``
counts all pieces. The RNN-T blank is not a piece: the model appends it at
index ``num_labels``.
"""

from __future__ import annotations

import json
import math
import struct
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WORD_MARKER = "▁"  # ▁

# SentencePiece piece types.
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6


# --------------------------------------------------------------------------
# Protobuf wire format (just what ModelProto needs).
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    pos, piece, score, ptype = 0, "", 0.0, TYPE_NORMAL
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            piece = buf[pos : pos + ln].decode("utf-8")
            pos += ln
        elif field == 2 and wt == 5:
            (score,) = struct.unpack("<f", buf[pos : pos + 4])
            pos += 4
        elif field == 3 and wt == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wt)
    return piece, score, ptype


def load_sentencepiece_model(path: str | Path) -> List[Tuple[str, float, int]]:
    """Parse a SentencePiece .model file into [(piece, score, type), ...]."""
    return parse_sentencepiece_model(Path(path).read_bytes())


def parse_sentencepiece_model(buf: bytes) -> List[Tuple[str, float, int]]:
    """The piece table of a SentencePiece ``ModelProto`` held in memory (a
    serving bundle's ``sentencepiece`` bytes)."""
    pos = 0
    pieces = []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            pieces.append(_parse_piece(buf[pos : pos + ln]))
            pos += ln
        else:
            pos = _skip_field(buf, pos, wt)
    return pieces


def save_sentencepiece_model(
    path: str | Path, pieces: Sequence[Tuple[str, float, int]]
) -> None:
    """Write a minimal SentencePiece-compatible .model file."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _write_varint((1 << 3) | 2) + _write_varint(len(pb)) + pb
        body += _write_varint((2 << 3) | 5) + struct.pack("<f", score)
        body += _write_varint((3 << 3) | 0) + _write_varint(ptype)
        out += _write_varint((1 << 3) | 2) + _write_varint(len(body)) + bytes(body)
    Path(path).write_bytes(bytes(out))


# --------------------------------------------------------------------------
# Unigram model: Viterbi encode + lattice sampling.
# --------------------------------------------------------------------------


class UnigramModel:
    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        self.pieces = list(pieces)
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = np.array([s for _, s, _ in pieces], dtype=np.float64)
        self.max_len = max((len(p) for p, _, t in pieces if t != TYPE_UNKNOWN), default=1)
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == TYPE_UNKNOWN), 0
        )
        self.unk_score = -20.0

    def __len__(self):
        return len(self.pieces)

    def _lattice(self, text: str):
        """All piece matches: starts[i] = list of (end, piece_id, score)."""
        n = len(text)
        starts: List[List[Tuple[int, int, float]]] = [[] for _ in range(n)]
        for i in range(n):
            found = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                pid = self.piece_to_id.get(text[i:j])
                if pid is not None and pid != self.unk_id:
                    starts[i].append((j, pid, float(self.scores[pid])))
                    found = True
            if not found or all(e != i + 1 for e, _, _ in starts[i]):
                # single-char fallback to <unk> keeps the lattice connected
                if not any(e == i + 1 for e, _, _ in starts[i]):
                    starts[i].append((i + 1, self.unk_id, self.unk_score))
        return starts

    def encode(self, text: str) -> List[int]:
        """Viterbi best segmentation."""
        n = len(text)
        if n == 0:
            return []
        starts = self._lattice(text)
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        for i in range(n):
            if best[i] == -np.inf:
                continue
            for j, pid, sc in starts[i]:
                if best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, pid)
        ids = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            ids.append(pid)
            pos = i
        return ids[::-1]

    def sample_encode(self, text: str, rng: np.random.Generator, alpha: float = 0.1) -> List[int]:
        """Forward-filtering, backward-sampling segmentation (subword reg)."""
        n = len(text)
        if n == 0:
            return []
        starts = self._lattice(text)
        # ends[j] = list of (i, pid, sc) arriving at j
        ends: List[List[Tuple[int, int, float]]] = [[] for _ in range(n + 1)]
        logZ = np.full(n + 1, -np.inf)
        logZ[0] = 0.0
        for i in range(n):
            for j, pid, sc in starts[i]:
                ends[j].append((i, pid, sc))
        for j in range(1, n + 1):
            vals = [logZ[i] + alpha * sc for i, _, sc in ends[j]]
            if vals:
                m = max(vals)
                if m > -np.inf:
                    logZ[j] = m + math.log(sum(math.exp(v - m) for v in vals))
        ids = []
        pos = n
        while pos > 0:
            cands = [
                (i, pid, logZ[i] + alpha * sc) for i, pid, sc in ends[pos]
                if logZ[i] > -np.inf
            ]
            ws = np.array([c[2] for c in cands])
            p = np.exp(ws - ws.max())
            p /= p.sum()
            i, pid, _ = cands[rng.choice(len(cands), p=p)]
            ids.append(pid)
            pos = i
        return ids[::-1]


# --------------------------------------------------------------------------
# Tokenizer facade (reference API).
# --------------------------------------------------------------------------


class Tokenizer:
    """Text <-> token ids (reference: data/tokenizer.py:25-86)."""

    def __init__(
        self,
        labels: Sequence[str],
        sentpiece_model: str | Path | bytes,
        sampling: float = 0.0,
        seed: Optional[int] = None,
    ):
        """``sentpiece_model``: a ``.model`` or ``.json`` file, or the bytes
        of a ``.model`` (a serving bundle's ``sentencepiece`` entry)."""
        self.charset = list(labels)
        self.sampling = sampling
        path = None if isinstance(sentpiece_model, bytes) else Path(sentpiece_model)
        if path is None:
            pieces = parse_sentencepiece_model(sentpiece_model)
        elif path.suffix == ".json":
            data = json.loads(path.read_text())
            pieces = [(p, s, t) for p, s, t in data["pieces"]]
        else:
            pieces = load_sentencepiece_model(path)
        self.model = UnigramModel(pieces)
        self.num_labels = len(self.model)
        self._rng = np.random.default_rng(seed)

    def _tokenize_word(self, word: str) -> List[int]:
        text = WORD_MARKER + word
        if self.sampling > 0.0 and self._rng.random() < self.sampling:
            return self.model.sample_encode(text, self._rng)
        return self.model.encode(text)

    def tokenize(self, transcript: str) -> List[int]:
        out: List[int] = []
        for word in transcript.split():
            out.extend(self._tokenize_word(word))
        return out

    def detokenize(self, inds) -> str:
        if isinstance(inds, (int, np.integer)):
            inds = [int(inds)]
        text = "".join(
            self.model.pieces[i][0] if i != self.model.unk_id else "⁇"
            for i in inds
        )
        return text.replace(WORD_MARKER, " ").strip()

    def id_to_piece(self, i: int) -> str:
        return self.model.pieces[i][0]


# --------------------------------------------------------------------------
# Trainer (replacement for spm_train; reference builds vocabs with
# data/spm/spm_from_json.py calling sentencepiece's trainer).
# --------------------------------------------------------------------------


def train_tokenizer(
    corpus: Sequence[str],
    vocab_size: int,
    max_piece_len: int = 16,
    user_symbols: Sequence[str] = (),
    seed_mult: int = 20,
) -> List[Tuple[str, float, int]]:
    """Train a unigram piece table.

    Seeds with frequent substrings, then runs EM-style pruning (score = log
    expected frequency under Viterbi segmentation) down to ``vocab_size``.
    Returns a piece table usable with UnigramModel / save_sentencepiece_model.
    """
    words = Counter()
    for line in corpus:
        for w in line.split():
            words[WORD_MARKER + w] += 1

    # Seed candidates: all substrings up to max_piece_len weighted by freq.
    subs = Counter()
    chars = Counter()
    for w, c in words.items():
        for i in range(len(w)):
            chars[w[i]] += c
            for j in range(i + 1, min(len(w), i + max_piece_len) + 1):
                subs[w[i:j]] += c * (j - i)  # favour longer pieces

    n_seed = min(len(subs), max(vocab_size * seed_mult, vocab_size + 100))
    seed = dict(subs.most_common(n_seed))
    for ch, c in chars.items():
        seed.setdefault(ch, c)  # single chars must survive for coverage

    def normalize(freqs: Dict[str, float]) -> List[Tuple[str, float, int]]:
        total = sum(freqs.values()) or 1.0
        pieces = [("<unk>", 0.0, TYPE_UNKNOWN)]
        for s in user_symbols:
            pieces.append((s, 0.0, TYPE_USER_DEFINED))
        for p, f in sorted(freqs.items(), key=lambda kv: (-kv[1], kv[0])):
            pieces.append((p, math.log(f / total), TYPE_NORMAL))
        return pieces

    keep_budget = vocab_size - 1 - len(user_symbols)
    freqs = {p: float(c) for p, c in seed.items()}
    for _ in range(4):  # EM iterations with pruning
        model = UnigramModel(normalize(freqs))
        new = Counter()
        for w, c in words.items():
            for pid in model.encode(w):
                piece = model.pieces[pid][0]
                if model.pieces[pid][2] == TYPE_NORMAL:
                    new[piece] += c
        # Single characters always survive (full coverage, like SPM's
        # character_coverage=1.0); their floor frequency keeps them usable
        # as alternatives even when Viterbi never picks them.
        kept = {
            ch: max(float(new.get(ch, 0)), 0.5 * float(c))
            for ch, c in chars.items()
        }
        for p, c in new.most_common():
            if len(kept) >= keep_budget:
                break
            if p not in kept:
                kept[p] = float(c)
        freqs = kept

    return normalize(freqs)


def save_tokenizer_json(path: str | Path, pieces: List[Tuple[str, float, int]]):
    Path(path).write_text(json.dumps({"pieces": pieces}))


def piece_table(tokenizer, n_classes: int) -> List[str]:
    """Token id -> piece over every class: "" past the tokenizer's table
    (the blank, the last class, has no piece) and for every id when there
    is no tokenizer. What the serializer detokenises with and the n-gram
    and keyword tables are built over."""
    if tokenizer is None:
        return [""] * n_classes

    def piece(i):
        try:
            return tokenizer.id_to_piece(i)
        except (IndexError, KeyError):
            return ""

    return [piece(i) for i in range(n_classes)]
