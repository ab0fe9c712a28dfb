"""The port's n-gram scorer and its device tables (``lm/ngram.py``,
``lm/device_table.py``) against the JAX package's: the same scores (equal
floats, both parse the same text) and back-off chains, the npz cache, and
tables that are array-equal, on the ARPA models of ``tests/lm/`` and on a
random trigram made from a seed."""

import math

import numpy as np
import pytest

from caiman_asr_tpu.lm.device_table import build_device_tables as jax_tables
from caiman_asr_tpu.lm.ngram import NGramLM as JaxNGramLM
from caiman_asr_tpu.lm.ngram import find_ngram_path as jax_find
from caiman_asr_tpu_torch.lm import NGramLM, find_ngram_path
from caiman_asr_tpu_torch.lm.device_table import build_device_tables
from caiman_asr_tpu_torch.lm.ngram import LN10

SMALL = """\\data\\
ngram 1=5
ngram 2=3

\\1-grams:
-1.0\t<unk>
-0.5\t<s>\t-0.30103
-0.7\ta\t-0.2
-0.9\tb\t-0.1
-1.2\tc

\\2-grams:
-0.3\t<s> a
-0.4\ta b
-0.6\tb c

\\end\\
"""


def _random_arpa(seed: int, words) -> str:
    """A well-formed trigram: every listed n-gram's prefix listed too."""
    rng = np.random.default_rng(seed)
    uni = {(w,): (-rng.uniform(0.3, 3.0), -rng.uniform(0.05, 0.6)) for w in words + ["<s>"]}
    bi = {(a, b): (-rng.uniform(0.05, 1.5), -rng.uniform(0.05, 0.4))
          for a in words + ["<s>"] for b in words if rng.random() < 0.35}
    tri = {k + (c,): (-rng.uniform(0.01, 1.0), None) for k in bi for c in words
           if rng.random() < 0.25}
    out = ["\\data\\", f"ngram 1={len(uni) + 1}", f"ngram 2={len(bi)}", f"ngram 3={len(tri)}",
           "", "\\1-grams:", "-2.5\t<unk>"]
    for grams, head in ((uni, "\\2-grams:"), (bi, "\\3-grams:"), (tri, None)):
        for k, (p, b) in grams.items():
            out.append(f"{p:.4f}\t{' '.join(k)}" + (f"\t{b:.4f}" if b is not None else ""))
        out += [""] + ([head] if head else [])
    return "\n".join(out + ["\\end\\", ""])


WORDS = ["▁the", "▁a", "cat", "s", "▁on", "mat", "▁sat"]


@pytest.fixture(params=["small", "trigram"])
def arpa(request, tmp_path):
    p = tmp_path / "ngram.arpa"
    p.write_text(SMALL if request.param == "small" else _random_arpa(0, WORDS))
    return p


def test_scores_and_state_walks_match_jax(arpa):
    lm, jlm = NGramLM.load(arpa), JaxNGramLM.load(arpa)
    assert lm.order == jlm.order and lm.probs == jlm.probs and lm.backoffs == jlm.backoffs
    rng = np.random.default_rng(1)
    vocab = sorted({w for ng in lm.probs for w in ng}) + ["oov"]
    for _ in range(20):
        st, jst = lm.initial_state(), jlm.initial_state()
        for w in rng.choice(vocab, size=6):
            (s, st), (js, jst) = lm.score(str(w), st), jlm.score(str(w), jst)
            assert s == js and st == jst


def test_small_model_values(tmp_path):
    p = tmp_path / "ngram.arpa"
    p.write_text(SMALL)
    lm = NGramLM.load(p)
    s, st = lm.score("a", lm.initial_state())
    assert abs(s - (-0.3 * LN10)) < 1e-6
    s, _ = lm.score("c", st)  # a -> c backs off: bo(a) + p(c)
    assert abs(s - (-0.2 - 1.2) * LN10) < 1e-6
    assert lm.score("zzz", None)[0] == pytest.approx(-1.0 * LN10)


def test_binary_roundtrip_and_find(arpa, tmp_path):
    lm = NGramLM.load(arpa)
    out = tmp_path / "ngram.binary"
    lm.save_binary(out)
    back, jback = NGramLM.load(out), JaxNGramLM.load(out)
    assert back.order == lm.order and back.probs.keys() == lm.probs.keys()
    assert back.probs == jback.probs and back.backoffs == jback.backoffs
    assert find_ngram_path(str(tmp_path)) == jax_find(str(tmp_path)) == str(out)
    assert find_ngram_path(str(tmp_path / "none")) is None


def test_kenlm_binary_is_refused(tmp_path):
    p = tmp_path / "ngram.binary"
    p.write_bytes(NGramLM._KENLM_MAGIC + b"\0" * 64)
    with pytest.raises(NotImplementedError, match="kenlm_binary"):
        NGramLM.load(p)


@pytest.mark.parametrize("skip", [(), (4,)])
def test_device_tables_equal_jax(arpa, skip):
    pieces = WORDS + ["a", "b", "c", "zzz", ""]
    lm, jlm = NGramLM.load(arpa), JaxNGramLM.load(arpa)
    got = build_device_tables(lm, pieces, skip_ids=skip)
    want = jax_tables(jlm, pieces, skip_ids=skip)
    np.testing.assert_array_equal(got.score, want.score)
    np.testing.assert_array_equal(got.next_state, want.next_state)
    assert got.init_state == want.init_state and got.nbytes() == want.nbytes()
    assert got.score.dtype == np.float32 and got.next_state.dtype == np.int32


def test_device_tables_walk_the_dict_scorer(arpa):
    """Along random token walks, table scores equal the dict scorer's."""
    pieces = WORDS + ["a", "b", "c", "zzz", ""]
    lm = NGramLM.load(arpa)
    t = build_device_tables(lm, pieces, skip_ids=[len(pieces) - 1])
    rng = np.random.default_rng(2)
    for _ in range(20):
        s, st = t.init_state, lm.initial_state()
        for k in rng.integers(0, len(pieces) - 1, size=8):
            want, st = lm.score(pieces[k], st)
            assert math.isclose(t.score[s, k], want, rel_tol=1e-6, abs_tol=1e-5)
            s = t.next_state[s, k]
