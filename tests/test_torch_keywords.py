"""The port's keyword trie, loader and device tables (``keywords/``)
against the JAX package's: the same deltas and live-thread states along
text, and tables that are array-equal; the tables equal the host trie's
walk state by state."""

import json

import numpy as np
import pytest

from caiman_asr_tpu.keywords.device_table import build_keyword_tables as jax_tables
from caiman_asr_tpu.keywords.device_table import state_dict as jax_state_dict
from caiman_asr_tpu.keywords.process import load_keywords as jax_load
from caiman_asr_tpu.keywords.trie import Keywords as JaxKeywords
from caiman_asr_tpu_torch.keywords import Keywords, load_keywords
from caiman_asr_tpu_torch.keywords.device_table import build_keyword_tables, state_dict

VOCABS = {
    "one": [("▁cat", 2.0)],
    "shared": [("▁cat", 2.0), ("▁car", 1.0), ("at", 0.5), ("▁c", 3.0)],
}
PIECES = ["▁c", "at", "ar", "▁ca", "t", "r", "▁the", "▁", "c", ""]


@pytest.mark.parametrize("name", list(VOCABS))
def test_steps_match_jax(name):
    kw, jkw = Keywords(VOCABS[name]), JaxKeywords(VOCABS[name])
    rng = np.random.default_rng(0)
    for _ in range(20):
        st, jst = Keywords.init(), JaxKeywords.init()
        for p in rng.choice(PIECES[:-1], size=6):
            (d, st), (jd, jst) = kw.steps(str(p), st), jkw.steps(str(p), jst)
            assert d == jd and st == jst


def test_commit_and_refund():
    kw = Keywords([("▁cat", 2.0)])
    d1, st = kw.steps("▁ca", Keywords.init())
    d2, st = kw.steps("r", st)
    assert d1 == pytest.approx(6.0) and d2 == pytest.approx(-6.0)  # abandoned: refunded
    d3, st = kw.steps("▁cat", st)
    d4, _ = kw.steps("s", st)
    assert d3 == pytest.approx(8.0) and d4 == pytest.approx(0.0)  # completed: committed


@pytest.mark.parametrize("skip", [(), (9,)])
@pytest.mark.parametrize("name", list(VOCABS))
def test_tables_equal_jax_and_the_host_trie(name, skip):
    kw = Keywords(VOCABS[name])
    got = build_keyword_tables(kw, PIECES, skip_ids=skip)
    want = jax_tables(JaxKeywords(VOCABS[name]), PIECES, skip_ids=skip)
    np.testing.assert_array_equal(got.score, want.score)
    np.testing.assert_array_equal(got.next_state, want.next_state)
    assert got.init_state == want.init_state == 0 and got.n_states == len(kw.nodes)
    for s in range(got.n_states):
        assert state_dict(kw, s) == jax_state_dict(JaxKeywords(VOCABS[name]), s)
        for k, p in enumerate(PIECES):
            if k in skip:
                assert got.score[s, k] == 0 and got.next_state[s, k] == s
                continue
            delta, _ = kw.steps(p, state_dict(kw, s))
            assert got.score[s, k] == pytest.approx(delta, abs=1e-6)


def test_load_keywords_matches_jax(tmp_path):
    p = tmp_path / "kw.json"
    p.write_text(json.dumps({"keywords": {"the cat": 2, "dog": 1.5}}))
    kw, jkw = load_keywords(str(p)), jax_load(str(p))
    assert [n.edges for n in kw.nodes] == [n.edges for n in jkw.nodes]
    assert [n.term for n in kw.nodes] == [n.term for n in jkw.nodes]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"words": []}))
    with pytest.raises(ValueError):
        load_keywords(str(bad))
