"""The port's forced alignment (``caiman_asr_tpu_torch/latency/forced_align.py``)
against the JAX package's (``caiman_asr_tpu/latency/forced_align.py``), the
assertions of ``tests/latency/test_forced_align.py`` held on the port too.

Inputs come from numpy seeds; the model is JAX's ``RNNT.init`` carried over
by ``export/from_jax``. Tolerances: the max-plus pass is the same float64
code on the same scores, so its frames are equal; the lattice scores agree
within 1e-5 (fp32 sums in another order); the aligned frames of the two
packages are equal, and where they differ the two paths' float64 scores
(the port's lattice) agree within 1e-5, which only a tie allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.latency import forced_align as jfa
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.ops.transducer_loss import joint_lattice_scores as jax_lattice_scores
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.latency import forced_align as fa
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

SCORE_ATOL = 1e-5
N_CLASSES, BLANK = 10, 9
CFG = dict(in_feats=8, enc_n_hid=12, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=12,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxRNNT(JaxConfig(**CFG), N_CLASSES)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    port = load_jax_params(RNNT(RNNTModelConfig(**CFG), N_CLASSES, device="cpu"), params)
    return jmodel, params, port.eval()


def _batch(seed, T=(16, 12), U=(3, 2), B=2, T_max=16, U_max=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T_max, B, 8)).astype(np.float32)
    lens = np.asarray(T, np.int32)
    tokens = np.zeros((B, U_max), np.int32)
    for b, u in enumerate(U):
        tokens[b, :u] = rng.integers(0, BLANK, u)
    return feats, lens, tokens, np.asarray(U, np.int32)


def test_viterbi_simple_lattice():
    """Hand-built 3x(2+1) lattice where the best path is emit@0, emit@2."""
    T, U = 3, 2
    null = np.zeros((T, U + 1))
    emit = np.full((T, U + 1), -10.0)
    emit[0, 0] = -0.1
    emit[2, 1] = -0.1
    np.testing.assert_array_equal(fa._viterbi_lattice(null, emit, T, U), [0, 2])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_viterbi_equals_jax(seed, ties):
    """The same frames as JAX's on random lattices, and on lattices of few
    distinct values where emit and blank tie often (the emit wins)."""
    rng = np.random.default_rng(seed)
    T, U = 12 + seed, 3 + seed
    if ties:
        null = rng.integers(-2, 1, size=(T, U + 1)).astype(np.float64)
        emit = rng.integers(-2, 1, size=(T, U + 1)).astype(np.float64)
    else:
        null, emit = rng.normal(size=(T, U + 1)), rng.normal(size=(T, U + 1))
    got = fa._viterbi_lattice(null, emit, T, U)
    np.testing.assert_array_equal(got, jfa._viterbi_lattice(null, emit, T, U))
    assert len(got) == U and all(got[i] <= got[i + 1] for i in range(U - 1))
    assert 0 <= got[0] and got[-1] < T


def test_path_score_is_the_viterbi_maximum():
    """``path_score`` of the Viterbi path is the best score over every path
    (checked by brute force on a small lattice)."""
    import itertools

    rng = np.random.default_rng(3)
    T, U = 5, 3
    null, emit = rng.normal(size=(T, U + 1)), rng.normal(size=(T, U + 1))
    best = max(fa.path_score(null, emit, np.asarray(c), T)
               for c in itertools.combinations_with_replacement(range(T), U))
    frames = fa._viterbi_lattice(null, emit, T, U)
    np.testing.assert_allclose(fa.path_score(null, emit, frames, T), best, atol=1e-12)


@pytest.mark.parametrize("seed", [1, 2])
def test_model_alignment_equals_jax(models, seed):
    jmodel, params, port = models
    feats, lens, tokens, tok_lens = _batch(seed)
    want = jfa.viterbi_alignment(jmodel, params, jnp.asarray(feats), jnp.asarray(lens), tokens,
                                 tok_lens, BLANK)
    got = fa.viterbi_alignment(port, torch.from_numpy(feats), torch.from_numpy(lens), tokens,
                               tok_lens, BLANK)

    # the lattice scores of both packages
    (f, f_lens), (g, _), _ = jmodel.enc_pred(params, jnp.asarray(feats), jnp.asarray(lens),
                                             jnp.asarray(tokens), jnp.asarray(tok_lens),
                                             train=False)
    jn, je = jax_lattice_scores(jmodel.joint(params, f, g), jnp.asarray(tokens), f_lens,
                                jnp.asarray(tok_lens), BLANK)
    with torch.no_grad():
        (pf, pf_lens), (pg, _), _ = port.enc_pred(torch.from_numpy(feats),
                                                  torch.from_numpy(lens),
                                                  torch.from_numpy(tokens),
                                                  torch.from_numpy(tok_lens))
    pn, pe = fa.lattice_scores(port, pf, pf_lens, pg, tokens, tok_lens, BLANK)
    np.testing.assert_array_equal(pf_lens.numpy(), np.asarray(f_lens))
    for b in range(len(lens)):
        T, U = int(f_lens[b]), int(tok_lens[b])
        np.testing.assert_allclose(pn[b, :T, : U + 1].numpy(), np.asarray(jn)[b, :T, : U + 1],
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(pe[b, :T, :U].numpy(), np.asarray(je)[b, :T, :U],
                                   atol=SCORE_ATOL)
        assert len(got[b]) == U and all(0 <= x < T for x in got[b])
        if not np.array_equal(got[b], want[b]):  # a tie: the same best score
            nb, eb = pn[b].double().numpy(), pe[b].double().numpy()
            np.testing.assert_allclose(fa.path_score(nb, eb, got[b], T),
                                       fa.path_score(nb, eb, want[b], T), atol=SCORE_ATOL)


def test_segmented_encode_alignment_matches_full(models):
    """Segment-wise stateful encoding is exact: the alignment from the
    concatenated segments' encoder output equals the whole utterance's, and
    JAX's segmented alignment."""
    from types import SimpleNamespace

    from caiman_asr_tpu.latency.generate_gt_ctm import _segmented_alignment as jax_segmented
    from caiman_asr_tpu_torch.latency.generate_gt_ctm import _segmented_alignment

    jmodel, params, port = models
    rng = np.random.default_rng(2)
    T = 24
    feats = rng.normal(size=(T, 1, 8)).astype(np.float32)
    lens = np.asarray([T], np.int32)
    tokens = np.array([[1, 2, 3, 4]], np.int32)
    tok_lens = np.array([4], np.int32)
    batch = SimpleNamespace(tokens=tokens, token_lens=tok_lens)
    full = fa.viterbi_alignment(port, torch.from_numpy(feats), torch.from_numpy(lens), tokens,
                                tok_lens, BLANK)
    seg = _segmented_alignment(port, torch.from_numpy(feats), torch.from_numpy(lens), batch,
                               BLANK, seg_frames=8)
    np.testing.assert_array_equal(full[0], seg[0])
    want = jax_segmented(jmodel, params, jnp.asarray(feats), lens, batch, BLANK, seg_frames=8)
    np.testing.assert_array_equal(seg[0], want[0])


def test_alignment_to_ctm_entries_equals_jax(tmp_path):
    from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
    from caiman_asr_tpu.data.tokenizer import save_tokenizer_json, train_tokenizer
    from caiman_asr_tpu_torch.data.tokenizer import Tokenizer

    texts = ["the cat sat on the mat", "a dog barks at night"]
    save_tokenizer_json(tmp_path / "tok.json", train_tokenizer(texts * 4, vocab_size=30))
    labels = list(" abcdefghijklmnopqrstuvwxyz'")
    jtok = JaxTokenizer(labels=labels, sentpiece_model=tmp_path / "tok.json")
    ptok = Tokenizer(labels=labels, sentpiece_model=tmp_path / "tok.json")
    for text in texts:
        toks = ptok.tokenize(text)
        assert toks == jtok.tokenize(text)
        frames = np.cumsum(np.random.default_rng(len(text)).integers(0, 3, len(toks)))
        got = fa.alignment_to_ctm_entries(frames, toks, ptok, 0.06)
        assert got == jfa.alignment_to_ctm_entries(frames, toks, jtok, 0.06)
        assert [w for _, _, w in got] == text.split()
