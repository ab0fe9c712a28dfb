"""The port's host-scheduled adaptive beam (``decoding/beam.py``), its
hypotheses and serializer against the JAX package's, on the same JAX
parameters (carried over with ``export/from_jax``) and encoder output made
by numpy from a seed: every frame's finals and partials carry the same
tokens, token strings and frames, their confidences within 1e-5 (fp32
soft-max in another order); with the pruning thresholds, the final-emission
budget, VAD termination, the per-frame cap, and n-gram and keyword fusion."""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from caiman_asr_tpu.decoding.beam import RNNTBeamDecoder as JaxBeam
from caiman_asr_tpu.decoding.hypothesis import init_sos_hyp as jax_sos
from caiman_asr_tpu.decoding.serialise import ResponseSerializer as JaxSerializer
from caiman_asr_tpu.keywords import load_keywords as jax_load_keywords
from caiman_asr_tpu.lm.ngram import NGramLM as JaxNGramLM
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.decoding.beam import RNNTBeamDecoder
from caiman_asr_tpu_torch.decoding.hypothesis import (
    Hypothesis,
    init_sos_hyp,
    token_strs_to_transcript,
)
from caiman_asr_tpu_torch.decoding.serialise import ResponseSerializer
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.keywords import load_keywords
from caiman_asr_tpu_torch.lm.ngram import NGramLM
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

K = 10
BLANK = K - 1
CFG = dict(in_feats=6, enc_n_hid=12, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=12,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
CONF_TOL = 1e-5


class PieceTokenizer:
    def id_to_piece(self, i):
        return "▁" * (i % 2) + chr(ord("a") + i)


@functools.cache
def _models():
    jm = JaxRNNT(JaxConfig(**CFG), K)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(42)))
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG), K, device="cpu"), params)
    return jm, params, tm


def _encs(seed, B, T, scale=6.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, CFG["joint_n_hid"])) * scale).astype(np.float32)


def _resp(fr):
    return None if fr is None else dataclasses.asdict(fr)


def assert_same_responses(got, want):
    """Tokens, token strings and frames equal, confidences within CONF_TOL."""
    assert len(got) == len(want)
    for g_utt, w_utt in zip(got, want):
        assert sorted(g_utt) == sorted(w_utt)
        for t in g_utt:
            for part in ("final", "partials"):
                g, w = _resp(getattr(g_utt[t], part)), _resp(getattr(w_utt[t], part))
                assert (g is None) == (w is None), (t, part)
                if g is None:
                    continue
                for ga, wa in zip(g.pop("alternatives"), w.pop("alternatives")):
                    conf = ga.pop("confidence"), wa.pop("confidence")
                    assert ga == wa
                    np.testing.assert_allclose(*conf, rtol=CONF_TOL, atol=CONF_TOL)
                assert g == w


def _fusion(tmp_path, jax_side: bool):
    arpa = tmp_path / "ngram.arpa"
    arpa.write_text("\\data\\\nngram 1=4\n\n\\1-grams:\n-0.5\t<unk>\n-0.4\t▁b\n-0.3\t▁f\n"
                    "-1.2\tc\n\n\\end\\\n")
    kwp = tmp_path / "kw.json"
    kwp.write_text(json.dumps({"keywords": {"bc": 3.0, "h": 1.0}}))
    if jax_side:
        return dict(ngram_lm=JaxNGramLM.load(arpa), ngram_alpha=0.5,
                    keywords=jax_load_keywords(str(kwp)))
    return dict(ngram_lm=NGramLM.load(arpa), ngram_alpha=0.5, keywords=load_keywords(str(kwp)))


CASES = {
    "default": dict(beam_width=3),
    "no-prune": dict(beam_width=4, beam_prune_score_thresh=-1, beam_prune_topk_thresh=-1),
    "final-emission": dict(beam_width=3, final_emission_thresh=0.12),
    "cap": dict(beam_width=2, max_symbols_per_step=1),
    "vad": dict(beam_width=2, eos_vad_threshold=0.12, frame_width=0.06),
    "no-partials": dict(beam_width=3, return_partials=False, temperature=1.0),
    "fusion": dict(beam_width=3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_decode_encs_matches_jax(name, tmp_path):
    jm, params, tm = _models()
    enc, lens = _encs(1, 3, 12), np.array([12, 9, 4])
    extra = (lambda j: _fusion(tmp_path, j)) if name == "fusion" else (lambda j: {})
    want = JaxBeam(jm, BLANK, PieceTokenizer(), **CASES[name], **extra(True)).decode_encs(
        params, enc, lens)
    got = RNNTBeamDecoder(tm, BLANK, PieceTokenizer(), **CASES[name], **extra(False)).decode_encs(
        torch.from_numpy(enc), torch.from_numpy(lens))
    assert_same_responses(got, want)
    assert any(fr.final is not None for utt in got for fr in utt.values())


def test_decode_through_the_encoder_matches_jax():
    jm, params, tm = _models()
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(20, 2, CFG["in_feats"])).astype(np.float32)
    lens = np.array([20, 11], np.int32)
    want = JaxBeam(jm, BLANK, PieceTokenizer(), beam_width=3).decode(params, feats, lens)
    got = RNNTBeamDecoder(tm, BLANK, PieceTokenizer(), beam_width=3).decode(
        torch.from_numpy(feats), torch.from_numpy(lens))
    assert_same_responses(got, want)


class _Transfers(TorchFunctionMode):
    """Counts the calls that move a tensor to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("cpu", "numpy", "item", "tolist"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_a_scheduling_round_is_one_transfer_each_way():
    _, _, tm = _models()
    dec = RNNTBeamDecoder(tm, BLANK, PieceTokenizer(), beam_width=3)
    dec._params_for(torch.float32)
    hyp = init_sos_hyp()
    work = [(hyp, _encs(3, 1, 1)[0, 0]) for _ in range(5)]
    with _Transfers() as mode:
        packets = dec._batched_step(dec._params_for(torch.float32), work)
    assert mode.n == 2  # the packed download: .cpu() then .numpy()
    assert len(packets) == 5 and packets[0][0].shape == (3,)


def test_hypothesis_and_serializer_match_jax():
    """Hash folding, truncation and the common-prefix final / partials."""
    def hyps(make):
        out = []
        for seq, score in (([2, 3, 5], -1.0), ([2, 3, 6], -1.5), ([2, 4], -2.0)):
            h = make()
            for t in seq:
                h.y_seq.append(t)
                h.s_seq.append(PieceTokenizer().id_to_piece(t))
                h.timesteps.append(t)
                h.p_seq.append(0.5)
                h.update_hash(PieceTokenizer().id_to_piece(t))
            h.score = score
            out.append(h)
        return {h.hashval: h for h in out}

    for drop in (False, True):
        got_h, want_h = hyps(init_sos_hyp), hyps(jax_sos)
        if drop:
            for d in (got_h, want_h):
                d.pop(max(d, key=lambda k: -d[k].score))
        assert sorted(got_h) == sorted(want_h)
        nbest = lambda hs: sorted(hs, key=lambda h: -h.score)  # noqa: E731
        got, got_kept = ResponseSerializer(nbest).frame_responses(got_h, 7)
        want, want_kept = JaxSerializer(nbest).frame_responses(want_h, 7)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [h.y_seq for h in got_kept.values()] == [h.y_seq for h in want_kept.values()]
        assert [h.prev_length for h in got_kept.values()] == [
            h.prev_length for h in want_kept.values()]
    assert token_strs_to_transcript(["▁a", "b", "▁c"]) == "ab c"
    assert isinstance(init_sos_hyp(), Hypothesis)


@pytest.mark.parametrize("decoder", ["beam", "fast_beam"])
def test_transcribe_with_the_beams_matches_jax(decoder, tmp_path):
    """offline.transcribe(decoder=...) with an n-gram and keywords, against
    the JAX decoders built as ``setup/builders.py`` builds them (the tables
    over the tokenizer's pieces, blank skipped) on the port's features."""
    from caiman_asr_tpu.decoding.fast_beam import FastBeamDecoder as JaxFast
    from caiman_asr_tpu.keywords.device_table import build_keyword_tables as jax_kw
    from caiman_asr_tpu.lm.device_table import build_device_tables as jax_lm
    from caiman_asr_tpu_torch import offline
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline

    cfg = dict(CFG, in_feats=240)
    jm = JaxRNNT(JaxConfig(**cfg), K)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = load_jax_params(RNNT(RNNTModelConfig(**cfg), K, device="cpu"), params)
    rng = np.random.default_rng(6)
    audio = (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32)
    lens = np.array([16000, 11000])
    fusion = _fusion(tmp_path, False)
    got = offline.transcribe(tm, audio, lens, device="cpu", tokenizer=PieceTokenizer(),
                             decoder=decoder, beam_width=3, ngram_lm=fusion["ngram_lm"],
                             ngram_scale_factor=0.5, keywords=fusion["keywords"])
    feats, feat_lens = FeaturePipeline(device="cpu")(torch.from_numpy(audio),
                                                    torch.from_numpy(lens))
    feats, feat_lens = feats.numpy(), feat_lens.numpy()
    jf = _fusion(tmp_path, True)
    if decoder == "beam":
        want = JaxBeam(jm, BLANK, PieceTokenizer(), beam_width=3, max_symbols_per_step=8,
                       temperature=1.4, ngram_lm=jf["ngram_lm"], ngram_alpha=0.5,
                       keywords=jf["keywords"]).decode(params, feats, feat_lens)
    else:
        pieces = [PieceTokenizer().id_to_piece(i) for i in range(K - 1)] + [""]
        want = JaxFast(jm, BLANK, beam_width=3, max_symbols_per_step=8, temperature=1.4,
                       tokenizer=PieceTokenizer(),
                       ngram_lm=jax_lm(jf["ngram_lm"], pieces, skip_ids=[BLANK]),
                       ngram_alpha=0.5,
                       keywords=jax_kw(jf["keywords"], pieces, skip_ids=[BLANK]),
                       score_thresh=0.4, topk_thresh=1.5).decode(params, feats, feat_lens)
    assert_same_responses(got, want)
    with pytest.raises(ValueError):
        offline.transcribe(tm, audio, lens, device="cpu", decoder="beam")  # no tokenizer
