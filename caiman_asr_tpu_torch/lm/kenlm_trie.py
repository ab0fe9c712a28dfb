"""kenlm binary-format n-gram reader: TRIE and QUANT_TRIE searches (the
port's own copy of ``caiman_asr_tpu/lm/kenlm_trie.py``, numpy only).

Extends the PROBING parser (lm/kenlm_binary.py — reverse-engineered and
validated against a real kenlm artifact) to the trie family, the smaller
format kenlm deployments commonly ship (reference lm/kenlm_ngram.py:10-48
loads any kenlm binary through the C++ lib).

Validation tier: no real kenlm TRIE artifact has been at hand (kenlm
itself is not a dependency), so this layout is reconstructed from the
published kenlm sources and validated by (a) write->parse round trips
and (b) cross-checking that a model written here scores identically to the same n-grams through the validated ARPA/PROBING
paths. The shared pieces (88-byte sanity block, FixedWidthParameters,
MurmurHash64A vocabulary hashing, log10 storage, the -0.0
no-right-extension backoff flag) ARE artifact-validated via PROBING.

Layout (reverse trie — kenlm lm/trie.hh, lm/search_trie.hh,
util/bit_packing.hh):

- Common header as PROBING; model_type 2 (TRIE) / 3 (QUANT_TRIE),
  search_version 1.
- SortedVocabulary: u64 entry count (= counts[0]-1; <unk> excluded), then
  that many MurmurHash64A word hashes sorted ascending. Ids: <unk>=0, then
  hash-sorted order 1..entries. Word strings trail the file in id order
  when has_vocabulary.
- QUANT_TRIE only: u8 prob_bits, u8 backoff_bits, 6 pad bytes; then per
  middle order a prob table (2^prob_bits f32 bin centers) followed by a
  backoff table (2^backoff_bits f32); then the longest order's prob table.
- Unigrams: (counts[0]+2) entries of {f32 prob, f32 backoff, u64 next}.
  Entry[id].next .. entry[id+1].next is the id's range in the first middle
  (bigram) layer.
- Middle layer i (order n=i+2): (counts[n-1]+1) bit-packed entries of
  [word: RequiredBits(counts[0])][prob][backoff][next:
  RequiredBits(counts[n])], LSB-first at increasing bit offsets, the array
  rounded up to bytes +8 spare. Non-quant: prob = 31-bit float with the
  sign bit stripped (probs are non-positive), backoff = full f32; quant:
  bin indices. The +1 entry carries the terminal next pointer.
- Longest layer: bit-packed [word][prob] entries, same conventions.
- REVERSE trie: an n-gram (w1..wn) is the path unigram[wn] -> middle-0
  entry with word w(n-1) -> ... ; each path node's payload is the
  probability of the gram read from that node outward, so enumerating all
  grams is a range walk. Entries within a range sort by word id.

ARRAY_TRIE (4) / QUANT_ARRAY_TRIE (5) — Bhiksha pointer compression
(kenlm lm/bhiksha.hh/.cc, `build_binary -a`): each middle layer stores
only the low ``inline_bits`` of its next pointers in the bit-packed
entries; the high parts ride a per-layer sorted u64 offsets array where
``offsets[h]`` = the first entry index whose next-pointer high part is
>= h (so ``high(i) = searchsorted(offsets, i, 'right') - 1``). Layer
block layout: 8-byte-aligned header u64 (byte 0: version 0, byte 1: the
configured ``-a`` bit limit), the offsets array, then the bit-packed
entries at ``layer_base + 8 * (1 + array_count) + 7`` (ArrayBhiksha::
Size's conservative alignment pad). ``inline_bits`` is recomputed at
load exactly as kenlm's ChopBits does — argmin over chop of
``(max_next >> (required - chop)) * 64 - (entries + 1) * chop`` bits,
chop capped by the configured limit — because the file stores the
configured cap, not the chosen chop.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from caiman_asr_tpu_torch.lm.ngram import LN10, NGramLM
from caiman_asr_tpu_torch.lm.kenlm_binary import MAGIC, _align8, murmur64a

TRIE_SEARCH_VERSION = 1


def _required_bits(max_value: int) -> int:
    """kenlm util::RequiredBits: bits to store values up to and including
    ``max_value``."""
    return max_value.bit_length() if max_value else 0


def _read_bits(data: np.ndarray, bit_off: np.ndarray, nbits: int) -> np.ndarray:
    """Vectorized LSB-first bit-field extraction (kenlm ReadInt57): for
    each offset, little-endian u64 at byte ``off>>3`` shifted by
    ``off & 7`` and masked. ``data``: uint8 array with >=8 spare bytes."""
    byte = (bit_off >> 3).astype(np.int64)
    val = np.zeros(len(byte), np.uint64)
    for i in range(8):
        val |= data[byte + i].astype(np.uint64) << np.uint64(8 * i)
    val >>= (bit_off & np.uint64(7))
    return val & np.uint64((1 << nbits) - 1)


def _f31(bits: np.ndarray) -> np.ndarray:
    """31-bit non-positive float: stored without the sign bit."""
    return -np.abs(
        (bits.astype(np.uint32) | np.uint32(0x80000000)).view(np.float32)
    )


BHIKSHA_VERSION = 0


def _chop_bits(max_offset: int, max_next: int, limit_bits: int) -> int:
    """kenlm ArrayBhiksha ChopBits (lm/bhiksha.cc): how many high bits of
    each next pointer to move into the per-layer offsets array. argmin of
    the net bit cost — each chopped high value costs a 64-bit array slot,
    each inline entry saves ``chop`` bits; first-wins on ties."""
    required = _required_bits(max_next)
    best_chop, lowest = 0, None
    for chop in range(min(required, limit_bits) + 1):
        change = (max_next >> (required - chop)) * 64 - max_offset * chop
        if lowest is None or change < lowest:
            lowest, best_chop = change, chop
    return best_chop


def _bhiksha_geometry(count: int, max_next: int, limit_bits: int):
    """(inline_bits, array_count, block_size_bytes) for a middle layer of
    ``count`` entries (+1 terminal next slot) extending into ``max_next``
    children."""
    required = _required_bits(max_next)
    chop = _chop_bits(count + 1, max_next, limit_bits)
    inline_bits = required - chop
    array_count = (max_next >> inline_bits) + 1
    return inline_bits, array_count, 8 * (1 + array_count) + 7


def parse_kenlm_trie(path: str | Path, data: bytes, order: int,
                     model_type: int, counts: Tuple[int, ...]) -> NGramLM:
    """Parse a TRIE/QUANT_TRIE/ARRAY_TRIE/QUANT_ARRAY_TRIE body (header
    already validated by parse_kenlm_binary, which dispatches here) into an
    explicit :class:`NGramLM`."""
    quantized = model_type in (3, 5)
    bhiksha = model_type in (4, 5)
    V = counts[0]

    off = _align8(88 + 20 + 8 * order)
    # SortedVocabulary: u64 count + sorted hashes (ids recovered from the
    # trailing strings section instead, as in the PROBING parser)
    (v_count,) = struct.unpack_from("<Q", data, off)
    if v_count != V - 1:
        raise ValueError(
            f"{path}: sorted vocabulary holds {v_count} hashes, header "
            f"says {V - 1} — corrupt file or unsupported layout"
        )
    off += 8 + 8 * (V - 1)

    prob_tables: List[np.ndarray] = []
    backoff_tables: List[np.ndarray] = []
    if quantized:
        prob_bits, backoff_bits = data[off], data[off + 1]
        off += 8
        for _ in range(order - 2):
            prob_tables.append(
                np.frombuffer(data, np.float32, 1 << prob_bits, off)
            )
            off += 4 << prob_bits
            backoff_tables.append(
                np.frombuffer(data, np.float32, 1 << backoff_bits, off)
            )
            off += 4 << backoff_bits
        prob_tables.append(
            np.frombuffer(data, np.float32, 1 << prob_bits, off)
        )
        off += 4 << prob_bits

    # unigrams: (V + 2) x {f32 prob, f32 backoff, u64 next}
    uni = np.frombuffer(data, np.uint8, 16 * (V + 2), off)
    uni_f = uni.reshape(-1, 16)[:, :8].copy().view(np.float32)
    uni_prob = -np.abs(uni_f[:V, 0])
    uni_backoff = uni_f[:V, 1] + 0.0
    uni_next = uni.reshape(-1, 16)[:, 8:].copy().view(np.uint64).ravel()[: V + 1]
    off += 16 * (V + 2)

    word_bits = _required_bits(V)
    raw = np.frombuffer(data, np.uint8)

    # middle layers: decode every entry's (word, prob, backoff, next)
    layers = []  # (words, probs, backoffs, nexts[count+1])
    for n in range(2, order):
        count = counts[n - 1]
        if bhiksha:
            aligned = _align8(off)
            version, limit_bits = data[aligned], data[aligned + 1]
            if version != BHIKSHA_VERSION:
                raise ValueError(
                    f"{path}: sorted-array compression version {version} "
                    f"(layer order {n}); only version {BHIKSHA_VERSION} is "
                    "supported — rebuild without -a or load the ARPA text"
                )
            next_bits, array_count, block = _bhiksha_geometry(
                count, counts[n], limit_bits
            )
            offsets = np.frombuffer(data, np.uint64, array_count, aligned + 8)
            if array_count and (
                offsets[0] != 0 or np.any(np.diff(offsets.astype(np.int64)) < 0)
            ):
                raise ValueError(
                    f"{path}: Bhiksha offsets array of layer order {n} is "
                    "not sorted from zero — corrupt file or unsupported "
                    "layout"
                )
            highs = (
                np.searchsorted(
                    offsets, np.arange(count + 1, dtype=np.uint64), "right"
                ).astype(np.uint64)
                - np.uint64(1)
            )
            off += block
        else:
            next_bits = _required_bits(counts[n])
        payload_bits = (
            (prob_bits + backoff_bits) if quantized else (31 + 32)
        )
        total_bits = word_bits + payload_bits + next_bits
        size = ((count + 1) * total_bits + 7) // 8 + 8
        base = np.uint64(off * 8)
        idx = np.arange(count, dtype=np.uint64) * np.uint64(total_bits) + base
        words = _read_bits(raw, idx, word_bits).astype(np.int64)
        if quantized:
            p_idx = _read_bits(raw, idx + np.uint64(word_bits), prob_bits)
            b_idx = _read_bits(
                raw, idx + np.uint64(word_bits + prob_bits), backoff_bits
            )
            probs = prob_tables[n - 2][p_idx.astype(np.int64)]
            backoffs = backoff_tables[n - 2][b_idx.astype(np.int64)]
        else:
            probs = _f31(_read_bits(raw, idx + np.uint64(word_bits), 31))
            backoffs = (
                _read_bits(raw, idx + np.uint64(word_bits + 31), 32)
                .astype(np.uint32).view(np.float32) + 0.0
            )
        idx1 = np.arange(count + 1, dtype=np.uint64) * np.uint64(total_bits) + base
        nexts = _read_bits(
            raw, idx1 + np.uint64(word_bits + payload_bits), next_bits
        )
        if bhiksha:
            nexts |= highs << np.uint64(next_bits)
        nexts = nexts.astype(np.int64)
        layers.append((words, probs, backoffs, nexts))
        off += size

    # longest layer
    count = counts[order - 1]
    payload_bits = prob_bits if quantized else 31
    total_bits = word_bits + payload_bits
    base = np.uint64(off * 8)
    idx = np.arange(count, dtype=np.uint64) * np.uint64(total_bits) + base
    l_words = _read_bits(raw, idx, word_bits).astype(np.int64)
    if quantized:
        l_probs = prob_tables[-1][
            _read_bits(raw, idx + np.uint64(word_bits), prob_bits).astype(np.int64)
        ]
    else:
        l_probs = _f31(_read_bits(raw, idx + np.uint64(word_bits), 31))
    size = ((count + 1) * total_bits + 7) // 8 + 8
    off += size

    words_raw = data[off:].split(b"\x00")
    words = [w.decode("utf-8") for w in words_raw[:V]]
    if len(words) != V or words[0] != "<unk>":
        raise ValueError(
            f"{path}: vocabulary strings section is malformed "
            f"(got {len(words)} words, first {words[:1]!r})"
        )

    # ---- walk the reverse trie into explicit dicts
    probs_d: Dict[Tuple[str, ...], float] = {}
    backoffs_d: Dict[Tuple[str, ...], float] = {}
    for i, w in enumerate(words):
        probs_d[(w,)] = float(uni_prob[i]) * LN10
        if uni_backoff[i] != 0.0:
            probs_bo = float(uni_backoff[i]) * LN10
            backoffs_d[(w,)] = probs_bo

    # frontier: (suffix tuple of ids, layer_index, lo, hi) — the range in
    # `layer_index` holding extensions of `suffix` one word further back
    frontier = [
        ((i,), 0, int(uni_next[i]), int(uni_next[i + 1])) for i in range(V)
    ]
    for li in range(order - 1):
        is_longest = li == order - 2
        if is_longest:
            l_w, l_p = l_words, l_probs
        else:
            l_w, l_p, l_b, l_nx = layers[li]
        new_frontier = []
        seen = 0
        for suffix, _, lo, hi in frontier:
            seen += hi - lo
            for e in range(lo, hi):
                gram_ids = (int(l_w[e]),) + suffix
                gram = tuple(words[i] for i in gram_ids)
                probs_d[gram] = float(l_p[e]) * LN10
                if not is_longest:
                    if l_b[e] != 0.0:
                        backoffs_d[gram] = float(l_b[e]) * LN10
                    new_frontier.append(
                        (gram_ids, li + 1, int(l_nx[e]), int(l_nx[e + 1]))
                    )
        expect = counts[li + 1]
        if seen != expect:
            raise ValueError(
                f"{path}: trie layer {li} walk visited {seen} entries, "
                f"header says {expect} — corrupt file or unsupported layout"
            )
        frontier = new_frontier
    return NGramLM(probs_d, backoffs_d, order)


# --------------------------------------------------------------------------
# Writer (round-trip fixture, mirroring write_kenlm_binary's role)
# --------------------------------------------------------------------------
class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.bit = 0

    def write(self, value: int, nbits: int):
        end = (self.bit + nbits + 7) // 8
        if len(self.buf) < end:
            self.buf.extend(b"\x00" * (end - len(self.buf)))
        v = int(value)
        off = self.bit
        for i in range(nbits):
            if (v >> i) & 1:
                self.buf[(off + i) >> 3] |= 1 << ((off + i) & 7)
        self.bit += nbits

    def bytes_padded(self, total_entries_bits: int) -> bytes:
        size = (total_entries_bits + 7) // 8 + 8
        return bytes(self.buf) + b"\x00" * (size - len(self.buf))


def write_kenlm_trie(lm: NGramLM, path: str | Path, quantized: bool = False,
                     prob_bits: int = 8, backoff_bits: int = 8,
                     bhiksha: bool = False, bhiksha_bits: int = 22):
    """Write an :class:`NGramLM` in kenlm TRIE/QUANT_TRIE wire format
    (test fixture for :func:`parse_kenlm_trie`). Quantized mode builds the
    bin tables from the model's distinct values and raises if they do not
    fit — round trips are then exact. ``bhiksha`` emits the ARRAY variants
    (Bhiksha-compressed next pointers, ``build_binary -a bhiksha_bits``)."""
    order = lm.order
    words = sorted({w for ng in lm.probs for w in ng} - {"<unk>"})
    words = ["<unk>"] + sorted(words, key=lambda w: murmur64a(w.encode()))
    ids = {w: i for i, w in enumerate(words)}
    V = len(words)

    by_order: List[Dict[Tuple[int, ...], Tuple[float, float]]] = [
        {} for _ in range(order)
    ]
    for ng, p in lm.probs.items():
        iw = tuple(ids[w] for w in ng)
        by_order[len(ng) - 1][iw] = (
            p / LN10, lm.backoffs.get(ng, 0.0) / LN10
        )
    counts = [len(x) for x in by_order]
    counts[0] = V  # unigram layer covers the whole vocab

    out = bytearray()
    out += MAGIC + b"\x00" * (56 - len(MAGIC))
    out += struct.pack("<3f", 0.0, 1.0, -0.5)
    out += struct.pack("<3I", 1, 0xFFFFFFFF, 0)
    out += struct.pack("<Q", 1)
    out += struct.pack("<B3x", order)
    out += struct.pack("<f", 1.5)
    out += struct.pack("<I", (3 if quantized else 2) + (2 if bhiksha else 0))
    out += struct.pack("<B3x", 1)
    out += struct.pack("<I", TRIE_SEARCH_VERSION)
    out += struct.pack(f"<{order}Q", *counts)
    out += b"\x00" * (_align8(len(out)) - len(out))

    out += struct.pack("<Q", V - 1)
    for w in words[1:]:
        out += struct.pack("<Q", murmur64a(w.encode()))

    # sort each layer as a reverse trie: key = (suffix words newest-first,
    # then extension word) — i.e. plain sort on reversed id tuples
    ordered = [sorted(by_order[n], key=lambda t: t[::-1])
               for n in range(order)]

    q_prob: List[Dict[float, int]] = []
    q_back: List[Dict[float, int]] = []
    if quantized:
        for n in range(2, order + 1):
            vals = sorted({by_order[n - 1][g][0] for g in ordered[n - 1]})
            if len(vals) > (1 << prob_bits):
                raise ValueError("too many distinct probs to quantize")
            q_prob.append({v: i for i, v in enumerate(vals)})
            if n < order:
                bvals = sorted(
                    {by_order[n - 1][g][1] for g in ordered[n - 1]}
                )
                if len(bvals) > (1 << backoff_bits):
                    raise ValueError("too many distinct backoffs")
                q_back.append({v: i for i, v in enumerate(bvals)})
        out += struct.pack("<BB6x", prob_bits, backoff_bits)
        for n in range(2, order + 1):
            table = sorted(q_prob[n - 2])
            out += np.asarray(
                table + [0.0] * ((1 << prob_bits) - len(table)), np.float32
            ).tobytes()
            if n < order:
                btable = sorted(q_back[n - 2])
                out += np.asarray(
                    btable + [0.0] * ((1 << backoff_bits) - len(btable)),
                    np.float32,
                ).tobytes()

    # next pointers: entry e of layer n extends into the block of layer
    # n+1 entries whose suffix (all but the first word) == e's gram
    def next_ranges(layer_grams, child_grams):
        starts = []
        pos = 0
        child_sfx = [g[1:] for g in child_grams]
        for g in layer_grams:
            starts.append(pos)
            while pos < len(child_sfx) and child_sfx[pos] == g:
                pos += 1
        assert pos == len(child_grams), "child grams without stored prefix"
        return starts + [len(child_grams)]

    word_bits = _required_bits(V)

    # unigrams
    uni_starts = next_ranges(
        [(i,) for i in range(V)], ordered[1] if order >= 2 else []
    )
    for i in range(V):
        p, b = by_order[0].get((i,), (-99.0, 0.0))
        out += struct.pack("<2fQ", -abs(p), b, uni_starts[i])
    out += struct.pack("<2fQ", 0.0, 0.0, uni_starts[V])
    out += struct.pack("<2fQ", 0.0, 0.0, uni_starts[V])

    def f31_bits(p: float) -> int:
        return int(
            np.float32(-abs(p)).view(np.uint32)
        ) & 0x7FFFFFFF

    for n in range(2, order + 1):
        grams = ordered[n - 1]
        is_longest = n == order
        bw = _BitWriter()
        if not is_longest:
            nexts = next_ranges(grams, ordered[n])
            next_bits = _required_bits(counts[n])
            if bhiksha:
                next_bits, array_count, block = _bhiksha_geometry(
                    len(grams), counts[n], bhiksha_bits
                )
                highs = [nv >> next_bits for nv in nexts]
                offsets = [
                    next(i for i, hv in enumerate(highs) if hv >= h)
                    for h in range(array_count)
                ]
                base = len(out)
                out += b"\x00" * (_align8(base) - base)
                out += struct.pack("<BB6x", BHIKSHA_VERSION, bhiksha_bits)
                out += np.asarray(offsets, np.uint64).tobytes()
                out += b"\x00" * (base + block - len(out))
                mask = (1 << next_bits) - 1
                nexts = [nv & mask for nv in nexts]
        for e, g in enumerate(grams):
            p, b = by_order[n - 1][g]
            bw.write(g[0], word_bits)
            if quantized:
                bw.write(q_prob[n - 2][p], prob_bits)
                if not is_longest:
                    bw.write(q_back[n - 2][b], backoff_bits)
            else:
                bw.write(f31_bits(p), 31)
                if not is_longest:
                    bw.write(
                        int(np.float32(b).view(np.uint32)), 32
                    )
            if not is_longest:
                bw.write(nexts[e], next_bits)
        # terminal entry: word 0 + zero payload + final next
        bw.write(0, word_bits)
        if quantized:
            bw.write(0, prob_bits)
            if not is_longest:
                bw.write(0, backoff_bits)
        else:
            bw.write(0, 31)
            if not is_longest:
                bw.write(0, 32)
        if not is_longest:
            bw.write(nexts[len(grams)], next_bits)
        total = bw.bit
        out += bw.bytes_padded(total)

    for w in words:
        out += w.encode() + b"\x00"
    Path(path).write_bytes(bytes(out))
