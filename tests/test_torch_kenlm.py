"""The port's kenlm binary readers and writers (caiman_asr_tpu_torch/lm/
kenlm_binary.py: PROBING; kenlm_trie.py: TRIE, QUANT_TRIE and the Bhiksha
ARRAY_TRIE, QUANT_ARRAY_TRIE) against the JAX package's.

Each file the port writes is byte-equal to the JAX writer's on the same
model; each package parses the other's files; every conditional score
equals the ARPA's within 1e-6 (within the quantization bins' error for the
quantized tries, which equal JAX's own parse to the bit); ``to_ngram_lm``
equals JAX's; malformed files raise ``ValueError`` through
``NGramLM.load`` too; the device tables from a binary equal those from its
ARPA, and the fast beam fused with either gives the same hypotheses. Also
mirrors tests/lm/test_kenlm_binary.py and tests/lm/test_kenlm_trie.py.
"""

import numpy as np
import pytest
import torch

from caiman_asr_tpu.lm import kenlm_binary as jkb
from caiman_asr_tpu.lm import kenlm_trie as jkt
from caiman_asr_tpu.lm.ngram import NGramLM as JaxNGramLM
from caiman_asr_tpu.lm.train_ngram import train_ngram_from_sentences as jax_train
from caiman_asr_tpu_torch.decoding import fast_beam as fb
from caiman_asr_tpu_torch.lm import kenlm_binary as kb
from caiman_asr_tpu_torch.lm import kenlm_trie as kt
from caiman_asr_tpu_torch.lm.device_table import build_device_tables
from caiman_asr_tpu_torch.lm.ngram import NGramLM
from tests.lm.test_kenlm_binary import ARPA2, ARPA3, REFERENCE_BINARY
from tests.lm.test_kenlm_trie import ARPA3 as TRIE_ARPA3
from tests.lm.test_kenlm_trie import _random_model
from tests.test_torch_fast_beam import BLANK, PIECES, _encs, _models

SCORE_TOL = 1e-6
# (name, port writer, JAX writer): the five layouts
FORMATS = {
    "probing": (kb.write_kenlm_binary, jkb.write_kenlm_binary, {}),
    "trie": (kt.write_kenlm_trie, jkt.write_kenlm_trie, {}),
    "quant_trie": (kt.write_kenlm_trie, jkt.write_kenlm_trie, dict(quantized=True)),
    "array_trie": (kt.write_kenlm_trie, jkt.write_kenlm_trie, dict(bhiksha=True)),
    "quant_array_trie": (kt.write_kenlm_trie, jkt.write_kenlm_trie,
                         dict(quantized=True, bhiksha=True)),
}
QUANTIZED = ("quant_trie", "quant_array_trie")


def _sentences(seed: int, n: int = 120):
    rng = np.random.default_rng(seed)
    words = [f"▁w{i}" for i in range(14)] + ["a", "b", "c"]
    return [[words[j] for j in rng.integers(0, len(words), rng.integers(2, 9))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    """ARPA files: the JAX tests' two hand-written models and a 3-gram that
    the JAX trainer estimated from random sentences."""
    d = tmp_path_factory.mktemp("arpas")
    (d / "a2.arpa").write_text(ARPA2)
    (d / "a3.arpa").write_text(ARPA3)
    trained = jax_train(_sentences(0), 3, d / "trained")
    return {"a2": d / "a2.arpa", "a3": d / "a3.arpa", "trained": trained}


def _contexts(lm):
    words = sorted({w for ng in lm.probs for w in ng})
    ctxs = [()] + [(w,) for w in words] + [ng for ng in lm.probs if len(ng) == 2][:60]
    return words + ["oov"], ctxs


def _write_both(fmt, arpa, tmp_path):
    port_w, jax_w, kw = FORMATS[fmt]
    lm, jlm = NGramLM.load(arpa), JaxNGramLM.load(arpa)
    if fmt in QUANTIZED and len({round(v, 9) for v in lm.probs.values()}) > 250:
        kw = dict(kw, prob_bits=10, backoff_bits=10)
    p_port, p_jax = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    port_w(lm, p_port, **kw)
    jax_w(jlm, p_jax, **kw)
    return lm, p_port, p_jax


def test_murmur64a_known_values():
    assert kb.murmur64a(b"<s>") == 0x758639BD217E70
    assert kb.murmur64a(b"</s>") == 0x6BE0737DF1F76C0A
    rng = np.random.default_rng(3)
    for n in range(0, 40):
        key = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert kb.murmur64a(key, seed=n) == jkb.murmur64a(key, seed=n)
        assert kb.combine_hash(n * 977, n) == jkb.combine_hash(n * 977, n)
    assert kb._buckets(1000, 1.5) == jkb._buckets(1000, 1.5)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("model", ["a2", "a3", "trained"])
def test_writers_byte_equal_and_readers_cross(arpas, fmt, model, tmp_path):
    lm, p_port, p_jax = _write_both(fmt, arpas[model], tmp_path)
    assert p_port.read_bytes() == p_jax.read_bytes()
    a = NGramLM.load(p_jax)            # the port reading JAX's file
    b = JaxNGramLM.load(p_port)        # JAX reading the port's file
    assert a.order == b.order == lm.order
    words, ctxs = _contexts(lm)
    for ctx in ctxs:
        for w in words:
            want, want_state = lm.score(w, ctx)
            got, state = a.score(w, ctx)
            jgot, jstate = b.score(w, ctx)
            assert state == want_state == jstate
            assert got == jgot, (ctx, w)  # the same numbers from the same bytes
            if fmt not in QUANTIZED:
                assert abs(got - want) <= SCORE_TOL, (ctx, w, got, want)


@pytest.mark.parametrize("fmt", QUANTIZED)
def test_quantized_tries_equal_jax_parse_to_the_bit(arpas, fmt, tmp_path):
    lm, p_port, _ = _write_both(fmt, arpas["a3"], tmp_path)
    a, b = NGramLM.load(p_port), JaxNGramLM.load(p_port)
    assert a.probs == b.probs and a.backoffs == b.backoffs
    for ng, v in lm.probs.items():  # few distinct values: the bins are exact
        assert abs(a.probs[ng] - v) <= 2e-5


@pytest.mark.parametrize("model", ["a3", "trained"])
def test_to_ngram_lm_equals_jax(arpas, model, tmp_path):
    lm, p_port, _ = _write_both("probing", arpas[model], tmp_path)
    got = kb.parse_kenlm_binary(p_port).to_ngram_lm()
    want = jkb.parse_kenlm_binary(p_port).to_ngram_lm()
    assert got.probs == want.probs and got.backoffs == want.backoffs
    assert set(got.probs) == set(lm.probs)
    for ng, v in lm.probs.items():
        assert abs(got.probs[ng] - v) <= SCORE_TOL


def test_no_right_extension_flag(arpas, tmp_path):
    """A backoff of -0.0 marks "no right extension" on disk: a unigram's
    backoff set to -0.0 parses, in both packages, to the same bits and
    scores as 0.0."""
    import struct

    lm, p_port, _ = _write_both("probing", arpas["a2"], tmp_path)
    raw = bytearray(p_port.read_bytes())
    order = raw[88]
    counts = struct.unpack_from(f"<{order}Q", raw, 108)
    off = kb._align8(88 + 20 + 8 * order) + 20 + 12 * kb._buckets(counts[0] - 1, 1.5)
    words = kb.parse_kenlm_binary(p_port).words
    c = words.index("c")
    assert struct.unpack_from("<f", raw, off + 8 * c + 4)[0] == 0.0
    struct.pack_into("<f", raw, off + 8 * c + 4, -0.0)
    (tmp_path / "flag.kenlm").write_bytes(bytes(raw))
    a, b = kb.parse_kenlm_binary(tmp_path / "flag.kenlm"), jkb.parse_kenlm_binary(
        tmp_path / "flag.kenlm")
    np.testing.assert_array_equal(a.uni_backoff.view(np.uint64), b.uni_backoff.view(np.uint64))
    assert not np.signbit(a.uni_backoff[c])
    for w in ("a", "b", "c", "oov"):
        assert a.score(w, ("c",)) == lm.score(w, ("c",)) or abs(
            a.score(w, ("c",))[0] - lm.score(w, ("c",))[0]) <= SCORE_TOL


def test_array_trie_chops_and_roundtrips(tmp_path):
    """A model large enough that ChopBits chops: the port's ARRAY file is
    JAX's byte for byte, smaller than the plain TRIE, and parses to the
    same model; inline_bits recomputed at load as _chop_bits does."""
    ref = _random_model(np.random.default_rng(7))
    inline, _, _ = kt._bhiksha_geometry(1201, 700, 22)
    assert (inline, kt._required_bits(700)) == (jkt._bhiksha_geometry(1201, 700, 22)[0],
                                                jkt._required_bits(700))
    assert inline < kt._required_bits(700)
    for max_off, max_next, limit in ((1201, 700, 22), (5000, 3, 22), (70000, 1 << 20, 8)):
        assert kt._chop_bits(max_off, max_next, limit) == jkt._chop_bits(max_off, max_next,
                                                                         limit)
    kt.write_kenlm_trie(ref, tmp_path / "lm.trie")
    kt.write_kenlm_trie(ref, tmp_path / "lm.atrie", bhiksha=True)
    jkt.write_kenlm_trie(ref, tmp_path / "jax.atrie", bhiksha=True)
    assert (tmp_path / "lm.atrie").read_bytes() == (tmp_path / "jax.atrie").read_bytes()
    assert (tmp_path / "lm.atrie").stat().st_size < (tmp_path / "lm.trie").stat().st_size
    a = kb.parse_kenlm_binary(tmp_path / "lm.trie")
    b = kb.parse_kenlm_binary(tmp_path / "lm.atrie")
    assert a.probs == b.probs and a.backoffs == b.backoffs
    assert set(b.probs) == set(ref.probs)


def _malformed(arpa, tmp_path):
    ref = NGramLM.load(arpa)
    kb.write_kenlm_binary(ref, tmp_path / "lm.kenlm")
    raw = bytearray((tmp_path / "lm.kenlm").read_bytes())
    out = {}
    raw[96] = 7  # an unknown model type
    out["#7"] = bytes(raw)
    raw[96] = 2  # TRIE with the probing search version 0
    out["search version"] = bytes(raw)
    raw[96], raw[100] = 0, 0  # no vocabulary strings
    out["vocabulary"] = bytes(raw)
    raw[100] = 1
    raw[50] = ord("4")  # "format version 4"
    out["only 'format version 5'"] = bytes(raw)
    return out


@pytest.mark.parametrize("what", ["#7", "search version", "vocabulary",
                                  "only 'format version 5'"])
def test_malformed_files_raise(arpas, what, tmp_path):
    path = tmp_path / "bad.binary"
    path.write_bytes(_malformed(arpas["a2"], tmp_path)[what])
    for load in (kb.parse_kenlm_binary, NGramLM.load):  # never the ARPA parser
        with pytest.raises(ValueError, match=what):
            load(path)
    with pytest.raises(ValueError, match=what):
        jkb.parse_kenlm_binary(path)


def test_array_trie_bad_version_errors(tmp_path):
    (tmp_path / "lm.arpa").write_text(TRIE_ARPA3)
    tp = tmp_path / "lm.atrie"
    kt.write_kenlm_trie(NGramLM.load(tmp_path / "lm.arpa"), tp, bhiksha=True)
    data = bytearray(tp.read_bytes())
    off = kb._align8(kb._align8(88 + 20 + 8 * 3) + 8 + 8 * 5 + 16 * 8)
    assert data[off] == kt.BHIKSHA_VERSION
    data[off] = 9
    tp.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="compression version 9"):
        NGramLM.load(tp)


def test_quantized_bins_must_fit(arpas, tmp_path):
    with pytest.raises(ValueError, match="quantize"):
        kt.write_kenlm_trie(NGramLM.load(arpas["a3"]), tmp_path / "t.qtrie", quantized=True,
                            prob_bits=1)


@pytest.mark.skipif(not REFERENCE_BINARY.exists(), reason="reference asset not available")
def test_real_kenlm_artifact_matches_jax():
    """The real kenlm artifact of tests/lm/test_kenlm_binary.py: the same
    counts, words, tables and device tables as JAX's parse."""
    from caiman_asr_tpu.lm.device_table import build_device_tables as jax_tables

    lm, jlm = kb.parse_kenlm_binary(REFERENCE_BINARY), jkb.parse_kenlm_binary(REFERENCE_BINARY)
    assert lm.counts == jlm.counts == (242, 534) and lm.words == jlm.words
    assert lm.tables == jlm.tables
    dense, jdense = lm.to_ngram_lm(), jlm.to_ngram_lm()
    assert dense.probs == jdense.probs
    got, want = build_device_tables(lm, lm.words[3:35]), jax_tables(jlm, jlm.words[3:35])
    np.testing.assert_array_equal(got.score, want.score)
    np.testing.assert_array_equal(got.next_state, want.next_state)


# --------------------------------------------------- the device tables
def _piece_arpa(tmp_path):
    from tests.test_torch_fast_beam import _arpa

    return _arpa(tmp_path)


@pytest.mark.parametrize("fmt", ["probing", "trie", "array_trie"])
def test_device_tables_from_binary_equal_arpa(fmt, tmp_path):
    """The same automaton as from the ARPA, its scores within 1e-6 (the
    binary stores log10 in fp32); equal to the bit to JAX's tables built
    from the same binary."""
    from caiman_asr_tpu.lm.device_table import build_device_tables as jax_tables

    arpa = _piece_arpa(tmp_path)
    lm, p_port, _ = _write_both(fmt, arpa, tmp_path)
    want = build_device_tables(lm, PIECES, skip_ids=[BLANK])
    got = build_device_tables(NGramLM.load(p_port), PIECES, skip_ids=[BLANK])
    np.testing.assert_array_equal(got.next_state, want.next_state)
    assert got.init_state == want.init_state
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)
    jgot = jax_tables(JaxNGramLM.load(p_port), PIECES, skip_ids=[BLANK])
    np.testing.assert_array_equal(got.score, jgot.score)
    np.testing.assert_array_equal(got.next_state, jgot.next_state)


def test_fast_beam_fusion_from_binary_equals_arpa(tmp_path):
    arpa = _piece_arpa(tmp_path)
    lm, p_port, _ = _write_both("probing", arpa, tmp_path)
    _, _, tm = _models()
    enc = _encs(1, 3, 14)
    outs = []
    for path in (arpa, p_port):
        tables = build_device_tables(NGramLM.load(path), PIECES, skip_ids=[BLANK])
        dec = fb.FastBeamDecoder(tm, BLANK, beam_width=4, max_symbols_per_step=3,
                                 temperature=1.0, ngram_lm=tables, ngram_alpha=0.6)
        outs.append(dec.decode_encs(torch.from_numpy(enc), torch.tensor([14, 9, 5])))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(outs[0][2]).sum() > 0  # tokens emitted
