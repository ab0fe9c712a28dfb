"""kenlm binary-format n-gram LM reader/scorer (PROBING search): the port's
own copy of ``caiman_asr_tpu/lm/kenlm_binary.py`` (numpy only).

The reference loads kenlm ``.binary`` artifacts directly through the kenlm
C++ library (reference lm/kenlm_ngram.py:10-48); deployments ship such
files. This module parses the published kenlm wire format (magic
``mmap lm http://kheafield.com/code format version 5``) without the kenlm
dependency so those artifacts keep working here. The trie family (TRIE /
QUANT_TRIE / Bhiksha ARRAY_TRIE / QUANT_ARRAY_TRIE) dispatches to
:mod:`caiman_asr_tpu_torch.lm.kenlm_trie` — every `build_binary` output loads.

Layout (HASH_PROBING models, reverse-engineered from the wire format and
validated against a real kenlm artifact — every conditional probability
mass sums to 1 within 1.3e-7, all n-gram counts and vocab ids match):

- 88-byte sanity block: 56-byte zero-padded magic, floats {0, 1, -0.5},
  u32 {1, 0xFFFFFFFF, pad}, u64 1.
- FixedWidthParameters: u8 order, f32 probing_multiplier, u32 model_type
  (0 = PROBING), u8 has_vocabulary, u32 search_version (0), then
  ``order`` u64 n-gram counts; the whole header is padded to 8 bytes.
- Vocabulary: 20-byte header (u32, u64 bound = counts[0], u64), then a
  probing hash table of 12-byte ``{u64 MurmurHash64A(word, seed=0);
  u32 word_id}`` entries with ``max(n+1, ceil(multiplier*n))`` buckets
  over n = counts[0]-1 entries (``<unk>`` is id 0 and is not stored).
- Unigrams: ``counts[0]+1`` entries of ``{f32 prob; f32 backoff}``
  indexed by word id (one trailing sentinel). The probability's sign bit
  is a flag (kenlm's left-extension marker): the value is ``-abs(prob)``.
  A backoff of -0.0 marks "no right extension" and scores as 0.
- Middle orders (2..order-1): probing tables of 16-byte
  ``{u64 key; f32 prob; f32 backoff}``; longest order: 12-byte
  ``{u64 key; f32 prob}``. Bucket = key % buckets, linear probing.
  The key of n-gram (w1..wn) chains from the *newest* word backward:
  ``h = wn; for w in (wn-1 .. w1): h = (h*A) ^ ((1+w)*B)`` with
  A = 8978948897894561157, B = 17894857484156487943 (mod 2^64).
- If has_vocabulary: counts[0] null-terminated word strings in id order.

Probabilities/backoffs are log10 on disk; this class converts to natural
log to match :class:`caiman_asr_tpu_torch.lm.ngram.NGramLM` and exposes the same
``score(word, state)`` interface, so it plugs into the host beam's shallow
fusion unchanged.
"""

from __future__ import annotations

import math
import os
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from caiman_asr_tpu_torch.lm.ngram import LN10, NgramScorerMixin

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n"
_M64 = (1 << 64) - 1
_A = 8978948897894561157
_B = 17894857484156487943

MODEL_TYPES = {0: "PROBING", 1: "REST_PROBING", 2: "TRIE", 3: "QUANT_TRIE",
               4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE"}


def murmur64a(key: bytes, seed: int = 0) -> int:
    """MurmurHash64A (the hash kenlm uses for vocabulary words)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(key) * m)) & _M64
    n8 = len(key) // 8
    for i in range(n8):
        k = struct.unpack_from("<Q", key, i * 8)[0]
        k = (k * m) & _M64
        k ^= k >> r
        k = (k * m) & _M64
        h = ((h ^ k) * m) & _M64
    tail = key[n8 * 8:]
    if tail:
        h = ((h ^ int.from_bytes(tail, "little")) * m) & _M64
    h ^= h >> r
    h = (h * m) & _M64
    h ^= h >> r
    return h


def combine_hash(current: int, word: int) -> int:
    """Chain one more (older) context word into an n-gram key."""
    return ((current * _A) ^ ((1 + word) * _B)) & _M64


def _buckets(entries: int, multiplier: float) -> int:
    return max(entries + 1, int(math.ceil(multiplier * entries)))


def _align8(n: int) -> int:
    return (n + 7) & ~7


class KenLMBinaryLM(NgramScorerMixin):
    """Scorer over a parsed kenlm PROBING binary.

    Same interface as :class:`NGramLM` (via :class:`NgramScorerMixin`):
    ``score(word, state)`` returns natural-log P(word|state) and the new
    state (a tuple of the last order-1 word strings)."""

    def __init__(self, vocab: Dict[str, int], words: List[str],
                 uni_prob: np.ndarray, uni_backoff: np.ndarray,
                 tables: List[Dict[int, Tuple[float, float]]],
                 order: int, counts: Tuple[int, ...]):
        self.vocab = vocab            # word -> id (0 = <unk>)
        self.words = words            # id -> word
        self.uni_prob = uni_prob      # natural log, [counts[0]]
        self.uni_backoff = uni_backoff
        # tables[k] holds (k+2)-grams: u64 key -> (prob, backoff); the
        # longest order has backoff fixed at 0.0
        self.tables = tables
        self.order = order
        self.counts = counts

    # ------------------------------------------------------------- scoring
    def _ids(self, toks: Tuple[str, ...]) -> Tuple[int, ...]:
        v = self.vocab
        return tuple(v.get(t, 0) for t in toks)

    def _key(self, ids: Tuple[int, ...]) -> int:
        h = ids[-1]
        for w in ids[-2::-1]:
            h = combine_hash(h, w)
        return h

    def _backoff(self, ctx: Tuple[int, ...]) -> float:
        if len(ctx) == 1:
            return float(self.uni_backoff[ctx[0]])
        if len(ctx) >= self.order:
            return 0.0
        e = self.tables[len(ctx) - 2].get(self._key(ctx))
        return e[1] if e is not None else 0.0

    def _logprob(self, ids: Tuple[int, ...]) -> float:
        if len(ids) == 1:
            return float(self.uni_prob[ids[0]])
        e = self.tables[len(ids) - 2].get(self._key(ids))
        if e is not None:
            return e[0]
        return self._backoff(ids[:-1]) + self._logprob(ids[1:])

    def _logprob_pieces(self, ngram: Tuple[str, ...]) -> float:
        return self._logprob(self._ids(ngram))

    # -------------------------------------------------------- conversion
    def to_ngram_lm(self, max_candidates: int = 200_000_000):
        """Materialize an :class:`NGramLM` (explicit n-gram dicts) by
        enumerating candidate tuples and probing the hash tables.

        Possible because every stored n-gram's (n-1)-gram prefix is also
        stored (the ARPA prefix property), so order-n candidates are
        (stored prefix) x vocab. Needed by consumers that must enumerate
        n-grams (the device fusion table); raises if the enumeration
        budget would be exceeded — use the ARPA for such models.
        """
        from caiman_asr_tpu_torch.lm.ngram import NGramLM

        V = len(self.words)
        probs: Dict[Tuple[str, ...], float] = {}
        backoffs: Dict[Tuple[str, ...], float] = {}
        for i, w in enumerate(self.words):
            probs[(w,)] = float(self.uni_prob[i])
            if self.uni_backoff[i] != 0.0:
                backoffs[(w,)] = float(self.uni_backoff[i])
        # iteratively extend: contexts at order n are the stored (n-1)-grams
        prefixes: List[Tuple[int, ...]] = [(i,) for i in range(V)]
        all_w = np.arange(V, dtype=np.uint64)
        for n in range(2, self.order + 1):
            if len(prefixes) * V > max_candidates:
                raise ValueError(
                    f"kenlm binary enumeration needs {len(prefixes) * V} "
                    f"candidate {n}-grams (> {max_candidates}); use the "
                    "ARPA file for this model instead"
                )
            table = self.tables[n - 2]
            # sorted once per order: np.isin would re-sort per prefix
            key_arr = np.sort(np.fromiter(table.keys(), np.uint64, len(table)))
            found: List[Tuple[int, ...]] = []
            for pre in prefixes:
                # key(pre + (w,)) chains from w backward through pre;
                # uint64 wraparound is the hash's modular arithmetic
                h = all_w.copy()
                with np.errstate(over="ignore"):
                    for c in pre[::-1]:
                        h = (h * np.uint64(_A)) ^ (
                            (np.uint64(1 + c) * np.uint64(_B)) & np.uint64(_M64)
                        )
                pos = np.searchsorted(key_arr, h)
                pos = np.minimum(pos, len(key_arr) - 1)
                hit = key_arr[pos] == h
                for w in np.nonzero(hit)[0]:
                    e = table.get(int(h[w]))
                    if e is None:
                        continue
                    ng = pre + (int(w),)
                    sng = tuple(self.words[i] for i in ng)
                    probs[sng] = e[0]
                    if n < self.order and e[1] != 0.0:
                        backoffs[sng] = e[1]
                    found.append(ng)
            if len(found) != self.counts[n - 1]:
                raise ValueError(
                    f"kenlm binary enumeration found {len(found)} "
                    f"{n}-grams, header says {self.counts[n - 1]}; the "
                    "model violates the ARPA prefix property — use the "
                    "ARPA file instead"
                )
            prefixes = found
        return NGramLM(probs, backoffs, self.order)


def parse_kenlm_binary(path: str | Path) -> KenLMBinaryLM:
    data = Path(path).read_bytes()
    if not data.startswith(b"mmap lm http://kheafield.com/code"):
        raise ValueError(f"{path} is not a kenlm binary LM")
    if not data.startswith(MAGIC):
        got = data[:56].rstrip(b"\x00").decode("ascii", "replace")
        raise ValueError(
            f"unsupported kenlm binary header {got!r} (only 'format "
            "version 5' is supported) — load the ARPA text instead"
        )
    order = data[88]
    multiplier = struct.unpack_from("<f", data, 92)[0]
    model_type = struct.unpack_from("<I", data, 96)[0]
    has_vocab = data[100]
    search_version = struct.unpack_from("<I", data, 104)[0]
    counts = struct.unpack_from(f"<{order}Q", data, 108)
    if model_type not in (0, 2, 3, 4, 5):
        name = MODEL_TYPES.get(model_type, f"#{model_type}")
        raise ValueError(
            f"{path} is a kenlm {name} model; PROBING, TRIE, QUANT_TRIE, "
            "ARRAY_TRIE and QUANT_ARRAY_TRIE binaries are supported. "
            "Rebuild with `build_binary probing` / `build_binary trie`, "
            "or load the ARPA text."
        )
    if not has_vocab:
        raise ValueError(
            f"{path} was built without vocabulary strings "
            "(build_binary without the words section); the word ids are "
            "unrecoverable — rebuild with vocabulary or use the ARPA"
        )
    total_ngrams = int(sum(counts))
    max_ngrams = int(os.environ.get("CAIMAN_KENLM_MAX_NGRAMS", 20_000_000))
    if total_ngrams > max_ngrams:
        # the Python-dict representation costs ~100 B/entry; fail fast with
        # guidance instead of stalling/OOMing the server or val CLI at load
        raise ValueError(
            f"{path} holds {total_ngrams:,} n-grams — too large for the "
            f"in-memory scorer (cap {max_ngrams:,}; ~100 B/entry). Use the "
            "ARPA + NGramLM.save_binary() npz cache, or raise "
            "CAIMAN_KENLM_MAX_NGRAMS if the host has the RAM."
        )
    if model_type in (2, 3, 4, 5):
        from caiman_asr_tpu_torch.lm.kenlm_trie import (
            TRIE_SEARCH_VERSION,
            parse_kenlm_trie,
        )

        if search_version != TRIE_SEARCH_VERSION:
            raise ValueError(
                f"{path} has trie search version {search_version}; only "
                f"version {TRIE_SEARCH_VERSION} is supported — load the "
                "ARPA text instead"
            )
        return parse_kenlm_trie(path, data, order, model_type, counts)
    if search_version != 0:
        raise ValueError(
            f"{path} has probing search version {search_version}; only "
            "version 0 is supported — load the ARPA text instead"
        )

    off = _align8(88 + 20 + 8 * order)
    # vocabulary: 20-byte header, then the word hash table (redundant with
    # the trailing strings, which give id order directly — skip it)
    v_entries = counts[0] - 1  # <unk> not stored
    off += 20 + 12 * _buckets(v_entries, multiplier)
    # unigrams: counts[0] + 1 sentinel
    uni = np.frombuffer(data, np.float32, 2 * (counts[0] + 1), off)
    uni = uni.reshape(-1, 2)[: counts[0]]
    uni_prob = (-np.abs(uni[:, 0]) * LN10).astype(np.float64)
    uni_backoff = (uni[:, 1] * LN10).astype(np.float64)
    uni_backoff = uni_backoff + 0.0  # normalize -0.0 to 0.0
    off += 8 * (counts[0] + 1)

    tables: List[Dict[int, Tuple[float, float]]] = []
    for n in range(2, order + 1):
        nb = _buckets(counts[n - 1], multiplier)
        esize = 16 if n < order else 12
        raw = np.frombuffer(data, np.uint8, nb * esize, off).reshape(nb, esize)
        keys = raw[:, :8].copy().view(np.uint64).ravel()
        probsf = raw[:, 8:12].copy().view(np.float32).ravel()
        live = keys != 0
        t: Dict[int, Tuple[float, float]] = {}
        if n < order:
            bof = raw[:, 12:16].copy().view(np.float32).ravel()
            for k, p, b in zip(keys[live].tolist(),
                               probsf[live].tolist(), bof[live].tolist()):
                t[k] = (-abs(p) * LN10, b * LN10 + 0.0)
        else:
            for k, p in zip(keys[live].tolist(), probsf[live].tolist()):
                t[k] = (-abs(p) * LN10, 0.0)
        if len(t) != counts[n - 1]:
            raise ValueError(
                f"{path}: order-{n} table holds {len(t)} entries, header "
                f"says {counts[n - 1]} — corrupt file or unsupported layout"
            )
        tables.append(t)
        off += nb * esize

    words_raw = data[off:].split(b"\x00")
    words = [w.decode("utf-8") for w in words_raw[: counts[0]]]
    if len(words) != counts[0] or words[0] != "<unk>":
        raise ValueError(
            f"{path}: vocabulary strings section is malformed "
            f"(got {len(words)} words, first {words[:1]!r})"
        )
    vocab = {w: i for i, w in enumerate(words)}
    return KenLMBinaryLM(vocab, words, uni_prob, uni_backoff, tables,
                         order, tuple(counts))


def write_kenlm_binary(lm, path: str | Path, multiplier: float = 1.5):
    """Write an :class:`NGramLM` in kenlm PROBING wire format.

    Primarily a test fixture for :func:`parse_kenlm_binary` round trips.
    The n-gram tables use kenlm's placement (bucket = key % buckets,
    linear probing, validated against a real artifact); the vocabulary
    table's placement rule is unverified against kenlm itself, so real
    kenlm may not accept the vocab section — the ARPA remains the
    canonical interchange format.
    """
    words = sorted({w for ng in lm.probs for w in ng} - {"<unk>"})
    # kenlm id order: <unk>, <s>, </s> first when present
    head = [w for w in ("<s>", "</s>") if w in words]
    rest = [w for w in words if w not in head]
    words = ["<unk>"] + head + rest
    ids = {w: i for i, w in enumerate(words)}
    V = len(words)
    order = lm.order
    by_order: List[List[Tuple[Tuple[str, ...], float]]] = [
        [] for _ in range(order)
    ]
    for ng, p in lm.probs.items():
        by_order[len(ng) - 1].append((ng, p))
    counts = [len(x) for x in by_order]

    out = bytearray()
    out += MAGIC
    out += b"\x00" * (56 - len(MAGIC))
    out += struct.pack("<3f", 0.0, 1.0, -0.5)
    out += struct.pack("<3I", 1, 0xFFFFFFFF, 0)
    out += struct.pack("<Q", 1)
    out += struct.pack("<B3x", order)
    out += struct.pack("<f", multiplier)
    out += struct.pack("<I", 0)          # PROBING
    out += struct.pack("<B3x", 1)        # has_vocabulary
    out += struct.pack("<I", 0)          # search_version
    out += struct.pack(f"<{order}Q", V, *counts[1:])
    out += b"\x00" * (_align8(len(out)) - len(out))

    def probing_table(entries, nbuckets, esize, pack_entry):
        table = bytearray(nbuckets * esize)
        used = [False] * nbuckets
        for key, payload in entries:
            b = key % nbuckets
            while used[b]:
                b = (b + 1) % nbuckets
            used[b] = True
            struct.pack_into("<Q", table, b * esize, key)
            pack_entry(table, b * esize + 8, payload)
        return table

    # vocab section
    out += struct.pack("<IQQ", 0, V, 0)
    v_entries = [(murmur64a(w.encode()), i) for i, w in enumerate(words)
                 if i != 0]
    out += probing_table(
        v_entries, _buckets(V - 1, multiplier), 12,
        lambda t, o, i: struct.pack_into("<I", t, o, i),
    )
    # unigrams (+1 sentinel)
    for w in words:
        p = lm.probs.get((w,), -99.0 * LN10) / LN10
        b = lm.backoffs.get((w,), 0.0) / LN10
        out += struct.pack("<2f", p, b)
    out += struct.pack("<2f", 0.0, 0.0)
    # middle + longest tables
    for n in range(2, order + 1):
        entries = []
        for ng, p in by_order[n - 1]:
            iw = [ids[w] for w in ng]
            h = iw[-1]
            for c in iw[-2::-1]:
                h = combine_hash(h, c)
            if n < order:
                payload = (p / LN10, lm.backoffs.get(ng, 0.0) / LN10)
                entries.append((h, payload))
            else:
                entries.append((h, (p / LN10,)))
        esize = 16 if n < order else 12
        fmt = "<2f" if n < order else "<f"
        out += probing_table(
            entries, _buckets(counts[n - 1], multiplier), esize,
            lambda t, o, pl, fmt=fmt: struct.pack_into(fmt, t, o, *pl),
        )
    for w in words:
        out += w.encode() + b"\x00"
    Path(path).write_bytes(bytes(out))
