"""The port's GreedyDecoder against the JAX package's on the same encoder
output and parameters: tokens, frame indices and counts must be equal
exactly (fp32); log-probabilities within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.decoding.eos import EOSBlank as JaxEOSBlank
from caiman_asr_tpu.decoding.eos import EOSIgnore as JaxEOSIgnore
from caiman_asr_tpu.decoding.eos import EOSPredict as JaxEOSPredict
from caiman_asr_tpu.decoding.fuzzy import get_topk_logits as jax_topk
from caiman_asr_tpu.decoding.greedy import GreedyDecoder as JaxGreedy
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.decoding import eos
from caiman_asr_tpu_torch.decoding.fuzzy import get_topk_logits
from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

K = 11
BLANK = K - 1
CFG = dict(
    in_feats=8, enc_n_hid=12, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
    enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=12,
)


@pytest.fixture(scope="module")
def models():
    jm = JaxRNNT(JaxConfig(**CFG), K)
    params = jm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG), K, device="cpu"),
                         jax.tree.map(np.asarray, params))
    return jm, params, tm


def _encs(seed, B, T, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, CFG["joint_n_hid"])) * scale).astype(np.float32)


def _compare(models, encs, lens, jax_kw=None, kw=None):
    jm, params, tm = models
    want = JaxGreedy(jm, BLANK, **(jax_kw or {})).decode_encs(
        params, jnp.asarray(encs), jnp.asarray(lens))
    got = GreedyDecoder(tm, BLANK, **(kw or jax_kw or {})).decode_encs(
        torch.from_numpy(encs), torch.from_numpy(lens))
    toks, ts, lps, counts = got
    np.testing.assert_array_equal(counts, want[3])
    for b in range(encs.shape[0]):
        n = int(counts[b])
        np.testing.assert_array_equal(toks[b, :n], want[0][b, :n])
        np.testing.assert_array_equal(ts[b, :n], want[1][b, :n])
        np.testing.assert_allclose(lps[b, :n], want[2][b, :n], atol=1e-5)
    return counts


@pytest.mark.parametrize("max_symbols", [2, 30])  # 2 overflows the per-frame cap
def test_decode_encs(models, max_symbols):
    encs = _encs(0, 4, 9)
    counts = _compare(models, encs, np.asarray([9, 7, 5, 0], np.int32),
                      {"max_symbols_per_step": max_symbols})
    assert counts[3] == 0 and counts[:3].sum() > 0


def test_max_symbol_per_sample(models):
    counts = _compare(models, _encs(1, 2, 8), np.asarray([8, 8], np.int32),
                      {"max_symbol_per_sample": 2})
    assert np.all(counts == 2)


@pytest.mark.parametrize("which", ["ignore", "blank", "predict"])
def test_eos_strategies(models, which):
    jax_s = {"ignore": JaxEOSIgnore(3), "blank": JaxEOSBlank(3),
             "predict": JaxEOSPredict(3, alpha=0.5, beta=0.2)}[which]
    s = {"ignore": eos.EOSIgnore(3), "blank": eos.EOSBlank(3),
         "predict": eos.EOSPredict(3, alpha=0.5, beta=0.2)}[which]
    _compare(models, _encs(2, 3, 6), np.asarray([6, 6, 4], np.int32),
             {"eos_strategy": jax_s}, {"eos_strategy": s})


def test_fuzzy_topk_logits():
    x = np.random.default_rng(5).normal(size=(2, 512)).astype(np.float32)
    np.testing.assert_array_equal(get_topk_logits(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_topk(jnp.asarray(x))))


def test_decode_builds_frame_responses(models):
    jm, params, tm = models
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(12, 2, CFG["in_feats"])).astype(np.float32)
    lens = np.asarray([12, 8], np.int32)
    want = JaxGreedy(jm, BLANK).decode(params, jnp.asarray(feats), jnp.asarray(lens))
    # a tiny encoder budget forces one-utterance slices (unbatch.py)
    got = GreedyDecoder(tm, BLANK, max_inputs_per_batch=12 * 8).decode(
        torch.from_numpy(feats), torch.from_numpy(lens))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for t in g:
            gh, wh = g[t].final.alternatives[0], w[t].final.alternatives[0]
            assert (gh.y_seq, gh.timesteps) == (wh.y_seq, wh.timesteps)
            np.testing.assert_allclose(gh.confidence, wh.confidence, atol=1e-5)
