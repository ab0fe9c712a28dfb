"""The port's fixed-expansion device beam (``decoding/fast_beam.py``) against
the JAX package's, on the same JAX parameters (carried over with
``export/from_jax``) and the same encoder output, made by numpy from a seed.

Offline (``FastBeamDecoder.decode_encs``): tokens, frames and lengths equal
exactly, every slot (the dead ones too); scores within 1e-5 (fp32 sums and
logs in another order). Streaming (``make_streaming_beam_step``): the state
after every frame, integer leaves exact, scores and the prediction-net
states within 1e-5. With fusion off and on (n-gram, keywords, both), merging
on and off, the pruning thresholds on and off, and every chunk size of the
offline loop. The helpers that carry the JAX semantics the port must keep
(``lax.top_k``'s tie order, the uint32 hash) are held against JAX directly.
The JAX approx_max_k is exact on the CPU, where these run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from caiman_asr_tpu.decoding import fast_beam as jfb
from caiman_asr_tpu.keywords.device_table import build_keyword_tables as jax_kw_tables
from caiman_asr_tpu.keywords.trie import Keywords as JaxKeywords
from caiman_asr_tpu.lm.device_table import build_device_tables as jax_lm_tables
from caiman_asr_tpu.lm.ngram import NGramLM as JaxNGramLM
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.decoding import fast_beam as fb
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.keywords.device_table import build_keyword_tables
from caiman_asr_tpu_torch.keywords.trie import Keywords
from caiman_asr_tpu_torch.lm.device_table import build_device_tables
from caiman_asr_tpu_torch.lm.ngram import NGramLM
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

K = 10
BLANK = K - 1
CFG = dict(in_feats=6, enc_n_hid=12, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=12,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
PIECES = ["▁" * (i % 3 == 0) + chr(ord("a") + i) for i in range(K - 1)] + [""]
SCORE_TOL = 1e-5
BLANK_DROP = np.float32(1.5)


@functools.cache
def _models():
    jm = JaxRNNT(JaxConfig(**CFG), K)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(42)))
    # the blank lowered so that hypotheses emit on most frames
    params["joint_fc"]["b"] = params["joint_fc"]["b"] - BLANK_DROP * (np.arange(K) == BLANK)
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG), K, device="cpu"), params)
    return jm, params, tm


def _encs(seed, B, T, scale=8.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, CFG["joint_n_hid"])) * scale).astype(np.float32)


def _arpa(tmp_path):
    """A bigram over the pieces: a few favoured continuations, back-off to
    unigrams."""
    rng = np.random.default_rng(7)
    words = PIECES[:-1]
    uni = [f"{-rng.uniform(0.5, 2.0):.4f}\t{w}\t{-rng.uniform(0.1, 0.5):.4f}" for w in words]
    bi = [f"{-rng.uniform(0.01, 0.5):.4f}\t{a} {b}" for a in words for b in words
          if rng.random() < 0.3]
    lines = ["\\data\\", f"ngram 1={len(uni) + 2}", f"ngram 2={len(bi)}", "", "\\1-grams:",
             "-1.5\t<unk>", "-99\t<s>\t-0.3", *uni, "", "\\2-grams:", *bi, "", "\\end\\", ""]
    p = tmp_path / "lm.arpa"
    p.write_text("\n".join(lines))
    return p


def _fusion(kind, tmp_path):
    """(JAX tables, port tables) for an n-gram and / or keyword list."""
    lm = kw = None
    if kind in ("lm", "both"):
        path = _arpa(tmp_path)
        lm = (jax_lm_tables(JaxNGramLM.load(path), PIECES, skip_ids=[BLANK]),
              build_device_tables(NGramLM.load(path), PIECES, skip_ids=[BLANK]))
    if kind in ("kw", "both"):
        vocab = [("▁ab", 2.0), ("cd", 1.5), ("▁gba", 3.0)]
        kw = (jax_kw_tables(JaxKeywords(vocab), PIECES, skip_ids=[BLANK]),
              build_keyword_tables(Keywords(vocab), PIECES, skip_ids=[BLANK]))
    return lm, kw


def _kw(lm, kw, i, alpha):
    out = {}
    if lm is not None:
        out.update(ngram_lm=lm[i], ngram_alpha=alpha)
    if kw is not None:
        out["keywords"] = kw[i]
    return out


# -------------------------------------------------------------- helpers
@pytest.mark.parametrize("shape,k", [((6, 8), 4), ((5, 20), 4), ((7, 9000), 5), ((3, 9), 9)])
def test_top_k_matches_lax_on_ties(shape, k):
    """Pools built to hold ties: NEG_INF runs, repeated values, -0.0."""
    rng = np.random.default_rng(shape[1])
    x = rng.choice(np.array([-1.0, -2.5, 0.0, 3.0, fb.NEG_INF], np.float32), size=shape)
    x[:, ::7] = rng.normal(size=x[:, ::7].shape)
    x[0] = fb.NEG_INF
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = fb.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_hash_matches_uint32_past_the_wrap():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 8704, size=(64, 3))
    hj = jnp.zeros(3, jnp.uint32)
    ht = torch.zeros(3, dtype=torch.int64)
    for t in toks:  # 1000003^64 wraps 2^32 many times over
        hj = jfb._hash_step(hj, jnp.asarray(t, jnp.int32))
        ht = fb._hash_step(ht, torch.from_numpy(t))
    assert np.asarray(hj).astype(np.int64).tolist() == ht.tolist()


def test_merged_scores_and_thresholds_match_jax():
    rng = np.random.default_rng(3)
    s = rng.normal(size=(5, 8)).astype(np.float32) * 3
    s[:, 6:] = fb.NEG_INF
    h = rng.integers(0, 3, size=(5, 8)).astype(np.uint32)
    ln = rng.integers(0, 2, size=(5, 8)).astype(np.int32)
    want = np.asarray(jfb._merged_scores(jnp.asarray(s), jnp.asarray(h), jnp.asarray(ln)))
    got = fb._merged_scores(torch.from_numpy(s), torch.from_numpy(h.astype(np.int64)),
                            torch.from_numpy(ln.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jfb._apply_score_thresh(jnp.asarray(s), jnp.asarray(ln), 0.7))
    got = fb._apply_score_thresh(torch.from_numpy(s), torch.from_numpy(ln.astype(np.int64)), 0.7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_final_emission_prune_matches_jax():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 3, size=(6, 3, 8)).astype(np.int32)
    toks[:, :, :2] = 1
    lens = rng.integers(0, 8, size=(6, 3)).astype(np.int32)
    scores = rng.normal(size=(6, 3)).astype(np.float32)
    scores[1, 1:] = fb.NEG_INF
    committed = rng.integers(0, 3, size=6).astype(np.int32)
    since = rng.integers(0, 5, size=6).astype(np.int32)
    want = jfb._final_emission_prune(*map(jnp.asarray, (scores, toks, lens, committed, since)),
                                     2)
    got = fb._final_emission_prune(
        torch.from_numpy(scores), torch.from_numpy(toks),
        *(torch.from_numpy(a.astype(np.int64)) for a in (lens, committed, since)), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ offline decoder
OFFLINE = {
    "plain": dict(),
    "no-merge": dict(merge=False),
    "thresholds": dict(score_thresh=0.4, topk_thresh=1.5, final_emission_frames=3),
    "w1": dict(beam_width=1),
    "e1": dict(max_symbols_per_step=1),
}


def _offline(models, enc, lens, kw_jax, kw_port, cap=None, **port):
    jm, params, tm = models
    want = jfb.FastBeamDecoder(jm, BLANK, **kw_jax).decode_encs(
        params, jnp.asarray(enc), jnp.asarray(lens), cap=cap)
    dec = fb.FastBeamDecoder(tm, BLANK, **kw_port, **port)
    got = dec.decode_encs(torch.from_numpy(enc), torch.tensor(lens), cap=cap)
    return got, want, dec


def _check(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[3], want[3], rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("fusion", ["none", "lm", "kw", "both"])
@pytest.mark.parametrize("name", list(OFFLINE))
def test_offline_matches_jax(name, fusion, tmp_path):
    lm, kw = _fusion(fusion, tmp_path)
    base = {**dict(beam_width=4, max_symbols_per_step=3, temperature=1.0), **OFFLINE[name]}
    enc = _encs(1, 3, 14)
    got, want, _ = _offline(_models(), enc, [14, 9, 5], dict(base, **_kw(lm, kw, 0, 0.6)),
                            dict(base, **_kw(lm, kw, 1, 0.6)), chunk_frames=4)
    _check(got, want)
    live = got[3] > fb.NEG_INF / 2
    assert live[:, 0].all() and (got[2][live].sum() > 0 or name == "w1")  # tokens emitted


@pytest.mark.parametrize("chunk", [1, 2, 5, 12, 20])
def test_every_chunk_size(chunk):
    """The loop in chunks of any size (one past T too), with the stop flag
    read once a chunk: the JAX scan's result, and the frames run."""
    enc = _encs(2, 2, 12)
    base = dict(beam_width=3, max_symbols_per_step=2, temperature=1.0, score_thresh=0.4,
                topk_thresh=1.5)
    got, want, dec = _offline(_models(), enc, [12, 7], base, base, chunk_frames=chunk)
    _check(got, want)
    assert dec.last_run["chunks"] == -(-12 // chunk) == dec.last_run["host_reads"]
    assert dec.last_run["frames"] == dec.last_run["chunks"] * chunk
    assert not dec.last_run["graph"]


def test_cap_saturation_matches_jax():
    """A cap smaller than the tokens emitted: the last slot is overwritten."""
    enc = _encs(3, 2, 16, scale=20.0)
    base = dict(beam_width=3, max_symbols_per_step=3, temperature=1.0)
    got, want, _ = _offline(_models(), enc, [16, 16], base, base, cap=5)
    _check(got, want)
    assert (got[2] == 5).any()


def test_build_responses_and_decode_match_jax():
    jm, params, tm = _models()
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(20, 2, CFG["in_feats"])).astype(np.float32)
    lens = np.array([20, 13], np.int32)

    class Tok:
        def id_to_piece(self, i):
            return PIECES[i]

    kw = dict(beam_width=3, max_symbols_per_step=2, temperature=1.0, tokenizer=Tok())
    want = jfb.FastBeamDecoder(jm, BLANK, **kw).decode(params, jnp.asarray(feats),
                                                       jnp.asarray(lens))
    got = fb.FastBeamDecoder(tm, BLANK, **kw).decode(torch.from_numpy(feats),
                                                    torch.from_numpy(lens))
    as_dicts = lambda out: [{t: dataclasses.asdict(r) for t, r in u.items()} for u in out]  # noqa: E731
    assert as_dicts(got) == as_dicts(want) and any(got)


class _HostReads(TorchFunctionMode):
    """Raises on any call that reads a device value on the host."""

    READS = {"item", "__bool__", "__int__", "__float__", "__index__", "tolist", "nonzero",
             "cpu", "numpy", "argwhere", "masked_select"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            raise AssertionError(f"host read in the loop body: {name}")
        if name in ("__getitem__", "__setitem__", "index_put_", "index_put"):
            idx = args[1] if len(args) > 1 else ()
            for t in idx if isinstance(idx, (tuple, list)) else (idx,):
                if isinstance(t, torch.Tensor) and t.dtype == torch.bool:
                    raise AssertionError(f"boolean-mask indexing in the loop body: {name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fusion", ["none", "both"])
def test_a_chunk_and_a_streaming_step_make_no_host_read(fusion, tmp_path):
    _, _, tm = _models()
    lm, kw = _fusion(fusion, tmp_path)
    extra = dict(score_thresh=0.4, topk_thresh=1.5, final_emission_frames=2)
    dec = fb.FastBeamDecoder(tm, BLANK, beam_width=3, max_symbols_per_step=3, chunk_frames=3,
                             **_kw(lm, kw, 1, 0.5), **extra)
    encs = torch.from_numpy(_encs(6, 3, 8))
    lens = torch.tensor([8, 5, 0])
    with torch.inference_mode():
        params = dec._params_for(encs.dtype, encs.device)
        state = fb._init_beam(tm, params, 3, 3, 16, BLANK, encs.dtype, encs.device,
                              dec._lm(encs.device), dec._kw(encs.device))
        zb = torch.zeros(3, dtype=torch.int64)
        state.update(committed=zb, since=zb.clone(), t=torch.zeros((), dtype=torch.int64))
        loop = fb._Loop(encs, lens, state)
        with _HostReads():
            dec._chunk(loop, params)
    assert int(loop.state["t"]) == 3
    init, step = fb.make_streaming_beam_step(tm, BLANK, beam_width=3, expansions=3, cap=16,
                                             **_kw(lm, kw, 1, 0.5), **extra)
    params = tm.param_tree()
    st = init(params, 3)
    with _HostReads():
        st = step(params, encs[:, 0], st)
    assert int(st["frame"][0]) == 1


# ------------------------------------------------------- streaming step
STREAMING = {
    "plain": dict(),
    "no-merge": dict(merge=False),
    "thresholds": dict(score_thresh=0.4, topk_thresh=1.5, final_emission_frames=3),
}
INT_KEYS = ("toks", "ts", "lens", "hash", "frame", "committed", "since_final", "lm", "kw")


@pytest.mark.parametrize("fusion", ["none", "lm", "kw", "both"])
@pytest.mark.parametrize("name", list(STREAMING))
def test_streaming_step_matches_jax(name, fusion, tmp_path):
    """Frame by frame over 16 frames, cap 12: the whole state."""
    jm, params, tm = _models()
    lm, kw = _fusion(fusion, tmp_path)
    base = dict(beam_width=3, expansions=3, temperature=1.0, cap=12, **STREAMING[name])
    j_init, j_step = jfb.make_streaming_beam_step(jm, BLANK, **base, **_kw(lm, kw, 0, 0.6))
    t_init, t_step = fb.make_streaming_beam_step(tm, BLANK, **base, **_kw(lm, kw, 1, 0.6))
    enc = _encs(8, 3, 16, scale=20.0)
    tparams = tm.param_tree()
    js, ts = j_init(params, 3), t_init(tparams, 3)
    j_step = jax.jit(j_step)
    for t in range(enc.shape[1]):
        js = j_step(params, jnp.asarray(enc[:, t]), js)
        ts = t_step(tparams, torch.from_numpy(enc[:, t]), ts)
        assert set(ts) == set(js)
        for k, v in ts.items():
            want = np.asarray(js[k])
            if k in INT_KEYS:
                np.testing.assert_array_equal(v.numpy(), want.astype(np.int64), err_msg=k)
            else:
                np.testing.assert_allclose(v.float().numpy(), want, rtol=SCORE_TOL,
                                           atol=SCORE_TOL, err_msg=k)
    assert int(ts["lens"].max()) > 0


def test_streaming_thresholds_match_offline():
    """The port's own streaming chain with thresholds equals its offline
    decoder frame for frame (``test_fast_beam_pruning.py``'s check)."""
    _, _, tm = _models()
    enc = _encs(9, 3, 12)
    thr = dict(score_thresh=0.4, topk_thresh=1.5, final_emission_frames=4, cap=64)
    toks, ts, lens_b, scores = fb.FastBeamDecoder(
        tm, BLANK, beam_width=3, max_symbols_per_step=3, temperature=1.0, **thr,
    ).decode_encs(torch.from_numpy(enc), torch.full((3,), 12), cap=64)
    init, step = fb.make_streaming_beam_step(tm, BLANK, beam_width=3, expansions=3,
                                             temperature=1.0, **thr)
    params = tm.param_tree()
    st = init(params, 3)
    for t in range(enc.shape[1]):
        st = step(params, torch.from_numpy(enc[:, t]), st)
    s, ln, tk = (st[k].numpy() for k in ("scores", "lens", "toks"))
    order = np.argsort(-(s / np.maximum(ln + 1, 1)), axis=1, kind="stable")
    for b in range(3):
        got = [(tk[b, w, :ln[b, w]].tolist(), s[b, w]) for w in order[b]
               if s[b, w] > fb.NEG_INF / 2]
        want = [(toks[b, w, :lens_b[b, w]].tolist(), scores[b, w]) for w in range(3)
                if scores[b, w] > fb.NEG_INF / 2]
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-4,
                                   atol=1e-4)


def test_streaming_cap_saturation_matches_jax():
    """Past the cap: the generations that clip to the last slot, the latest
    write winning, as the JAX step's in-loop scatters."""
    jm, params, tm = _models()
    base = dict(beam_width=3, expansions=3, temperature=1.0, cap=6)
    j_init, j_step = jfb.make_streaming_beam_step(jm, BLANK, **base)
    t_init, t_step = fb.make_streaming_beam_step(tm, BLANK, **base)
    enc = _encs(10, 2, 12, scale=20.0)
    tparams = tm.param_tree()
    js, ts = j_init(params, 2), t_init(tparams, 2)
    j_step = jax.jit(j_step)
    for t in range(enc.shape[1]):
        js = j_step(params, jnp.asarray(enc[:, t]), js)
        ts = t_step(tparams, torch.from_numpy(enc[:, t]), ts)
    for k in ("toks", "ts", "lens", "hash"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]).astype(np.int64))
    np.testing.assert_allclose(ts["scores"].numpy(), np.asarray(js["scores"]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert (ts["lens"] == 6).any()


@pytest.mark.parametrize("merge", [True, False])
def test_the_early_exit_gates_every_later_trip(monkeypatch, merge):
    """The JAX loop exits once ``_improvable`` is false; the port runs every
    trip with its updates gated off from there. Both packages' exit
    condition is replaced by one that turns false after the first trip of
    a frame (an active hypothesis longer than every finished one), while
    later trips would still change the finished beam: the port must still
    equal JAX, offline and streamed."""
    falses = []

    def first_trip(active, finished, W, merge):
        go = active["lens"].amax() <= finished["lens"].amax()
        falses.append(not bool(go))
        return go

    def first_trip_jax(active, finished, W, merge):
        return jnp.max(active["lens"]) <= jnp.max(finished["lens"])

    monkeypatch.setattr(fb, "_improvable", first_trip)
    monkeypatch.setattr(jfb, "_improvable", first_trip_jax)
    jm, params, tm = _models()
    enc = _encs(11, 3, 12)
    kw = dict(beam_width=3, temperature=1.0, merge=merge)
    got, want, _ = _offline(_models(), enc, [12, 12, 8], dict(kw, max_symbols_per_step=4),
                            dict(kw, max_symbols_per_step=4))
    _check(got, want)
    j_init, j_step = jfb.make_streaming_beam_step(jm, BLANK, expansions=4, **kw)
    t_init, t_step = fb.make_streaming_beam_step(tm, BLANK, expansions=4, **kw)
    tparams = tm.param_tree()
    js, ts = j_init(params, 3), t_init(tparams, 3)
    j_step = jax.jit(j_step)
    for t in range(enc.shape[1]):
        js = j_step(params, jnp.asarray(enc[:, t]), js)
        ts = t_step(tparams, torch.from_numpy(enc[:, t]), ts)
    for k in ("toks", "ts", "lens", "hash"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]).astype(np.int64))
    np.testing.assert_allclose(ts["scores"].numpy(), np.asarray(js["scores"]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert any(falses) and not all(falses)  # the exit came, mid-frame
