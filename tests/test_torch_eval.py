"""The port's evaluation helpers against the JAX package's on the same
inputs: the offline endpointing (``evaluate/trim.py``), the state-reset
segmentation and merging (``evaluate/state_resets.py``), word timestamps
(``latency/timestamp.py``), the CTM and emission latency
(``latency/ctm.py``), the WER breakdown and punctuation error rates, and the
metric logger. The scripted cases of the JAX package's own tests
(``tests/evaluate/test_trim.py``, ``test_state_resets.py``,
``tests/latency/test_timestamps.py``, ``test_measure_latency.py``) and seeded
random ones; every result is equal (floats exactly: the same arithmetic)."""

import json
import math

import numpy as np
import pytest

from caiman_asr_tpu.evaluate import punctuation_error_rate as jax_per
from caiman_asr_tpu.evaluate import state_resets as jax_sr
from caiman_asr_tpu.evaluate import trim as jax_trim
from caiman_asr_tpu.evaluate import wer_breakdown as jax_wb
from caiman_asr_tpu.latency import ctm as jax_ctm
from caiman_asr_tpu.latency import timestamp as jax_ts
from caiman_asr_tpu.log import logger as jax_logger
from caiman_asr_tpu_torch.evaluate import punctuation_error_rate, state_resets, trim
from caiman_asr_tpu_torch.evaluate import wer_breakdown
from caiman_asr_tpu_torch.latency import ctm, timestamp
from caiman_asr_tpu_torch.log import logger

I_W, O_W = 0.03, 0.06
BLANK, EOS_ID = 100, 7


def _data(x):
    """A result of either package as comparable data: dataclass instances
    become (class name, fields)."""
    if isinstance(x, (list, tuple)):
        return [_data(v) for v in x]
    if isinstance(x, dict):
        return {k: _data(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__, _data(vars(x)))
    return x


def _stamp(mod, t):
    return mod.FullStamp(*t) if isinstance(t, tuple) else t


# (pred, timestamps, worst, threshold, eos terminal or None, probs): the JAX
# package's scripted trim cases
TRIM_CASES = [
    ([1, 2, 3], [0, 5, 9], 40, math.inf, None, None),
    ([], [], 40, 2.0, None, None),
    ([], [], 100, 2.0, None, None),
    ([1, 2], [4, 9], 100, 2.0, None, None),
    ([1, 2, 3, 4], [4, 9, 60, 61], 200, 2.0, None, None),
    ([1, 2], [90, 92], 200, 2.0, None, None),
    ([1, EOS_ID, 2, EOS_ID], [3, 5, 8, 9], 40, math.inf, True, None),
    ([1, EOS_ID, 2], [3, 5, 8], 40, math.inf, False, None),
    ([1, 2, EOS_ID], [3, 5, 8], 40, math.inf, False, None),
    ([1, EOS_ID, EOS_ID], [3, 5, 8], 40, math.inf, False, None),
    ([1, 2, EOS_ID], [4, 9, 60], 200, 2.0, True, None),
    ([1, EOS_ID, 2, 3], [4, 9, 60, 61], 200, 2.0, True, None),
    ([1, 2, 3], [4, 9, 60], 200, 2.0, None, [0.1, 0.2, 0.3]),
    ([1, 2], [(4, 4), (9, 60)], 200, 2.0, None, None),
]


def _random_trim_cases(n: int):
    rng = np.random.default_rng(0)
    for _ in range(n):
        k = int(rng.integers(0, 12))
        ts = np.sort(rng.integers(0, 120, size=k)).tolist()
        if rng.random() < 0.5:
            ts = [(t, t + int(rng.integers(0, 20))) for t in ts]
        y = rng.choice([1, 2, 3, EOS_ID, BLANK], size=k).tolist()
        yield (y, ts, int(rng.integers(1, 400)), float(rng.choice([math.inf, 0.5, 1.0, 2.0])),
               rng.choice([None, True, False]), rng.random(k).tolist() if rng.random() < 0.3
               else None)


@pytest.mark.parametrize("case", TRIM_CASES + list(_random_trim_cases(60)))
def test_trim_predictions_matches_jax(case):
    y, ts, worst, thresh, eos, probs = case
    out = []
    for mod, tmod in ((trim, timestamp), (jax_trim, jax_ts)):
        info = None if eos is None else mod.EOSTrimConfig(EOS_ID, bool(eos), BLANK)
        out.append(mod.trim_predictions(
            [list(y)], [[_stamp(tmod, t) for t in ts]], None if probs is None else [probs],
            I_W, O_W, [worst], eos_vad_threshold=thresh, eos_info=info))
    assert _data(out[0]) == _data(out[1])


def test_state_resets_config_matches_jax():
    for args in ((0.0, 0.0, 0.03, 2), (3.0, 3.0, 0.03, 2), (1.0, -1.0, 0.03, 2)):
        for mod in (state_resets, jax_sr):
            with pytest.raises(ValueError):
                mod.StateResetsConfig.from_seconds(*args)
    for args in ((15.0, 3.0, 0.03, 2), (0.6, 0.2, 0.03, 2), (2.0, 0.5, 0.03, 3, 2)):
        assert (vars(state_resets.StateResetsConfig.from_seconds(*args))
                == vars(jax_sr.StateResetsConfig.from_seconds(*args)))


@pytest.mark.parametrize("seed", range(4))
def test_segment_and_merge_match_jax(seed):
    rng = np.random.default_rng(seed)
    seg, ov, red = int(rng.integers(8, 30)), int(rng.integers(0, 6)), int(rng.integers(1, 3))
    T, B, F = int(rng.integers(10, 90)), int(rng.integers(1, 5)), 3
    feats = rng.normal(size=(T, B, F)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B).astype(np.int32)
    look = int(rng.integers(0, 4))
    cfgs = [m.StateResetsConfig(seg, ov, red, lookahead=look) for m in (state_resets, jax_sr)]
    got = state_resets.segment_batch(feats, lens, cfgs[0])
    want = jax_sr.segment_batch(feats, lens, cfgs[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert state_resets.group_segment_lanes(got[2]) == jax_sr.group_segment_lanes(want[2])
    for _ in range(20):
        n_seg = int(rng.integers(1, 5))
        toks = [rng.integers(0, 6, size=int(rng.integers(0, 8))).tolist() for _ in range(n_seg)]
        ts = [np.sort(rng.integers(0, seg, size=len(t))).tolist() for t in toks]
        two = [[(a, a + int(rng.integers(0, 3))) for a in t] for t in ts]
        probs = [rng.random(len(t)).tolist() for t in toks] if rng.random() < 0.5 else None
        for stamps in (ts, two):
            a = state_resets.merge_segments(
                toks, [[_stamp(timestamp, s) for s in t] for t in stamps], probs, cfgs[0])
            b = jax_sr.merge_segments(
                toks, [[_stamp(jax_ts, s) for s in t] for t in stamps], probs, cfgs[1])
            assert _data(a) == _data(b)


def test_the_merge_examples_of_the_jax_tests():
    for mod in (state_resets, jax_sr):
        cfg = mod.StateResetsConfig(segment_frames=6, overlap_frames=2, enc_time_reduction=1,
                                    lookahead=3)
        toks, t, _ = mod.merge_segments([[7, 2, 3, 6, 5], [2, 6, 5, 9, 7]],
                                        [[1, 2, 3, 4, 6], [1, 3, 4, 5, 6]], None, cfg)
        assert (toks, t) == ([7, 2, 3, 6, 5, 9, 7], [1, 2, 3, 4, 6, 9, 10])


@pytest.mark.parametrize("seed", range(3))
def test_group_timestamps_and_frame_to_time_match_jax(seed):
    rng = np.random.default_rng(seed)
    vocab = [" he", "llo", " wor", "ld", " a", "b", " ", " c"]
    subwords, stamps, sentences = [], [], []
    for i in range(6):
        ids = rng.integers(0, len(vocab), size=int(rng.integers(0, 10)))
        pieces = [vocab[j] for j in ids]
        subwords.append(pieces)
        stamps.append(np.sort(rng.integers(0, 50, size=len(pieces))).tolist())
        sentences.append("".join(pieces).strip())
    out = []
    for mod in (timestamp, jax_ts):
        term_list = [mod.Never(), mod.EOS(0.5), mod.Silence(1.0), mod.Never(), mod.EOS(2.0),
                     mod.Never()]
        seqs = mod.group_timestamps(subwords, stamps, sentences, term_list)
        out.append((_data(seqs), [_data(mod.frame_to_time(w, 0.06, 0.01, 0.02))
                                  for s in seqs for w in s.seqs]))
    assert out[0] == out[1]


def test_ctm_dump_load_and_emission_latency_match_jax(tmp_path):
    seqs = {}
    for name, mod in (("port", timestamp), ("jax", jax_ts)):
        seqs[name] = [
            mod.SequenceTimestamp([mod.PerWordTimestamp("hello", 2, 3),
                                   mod.PerWordTimestamp("world", 5, 7)], mod.EOS(0.5)),
            mod.SequenceTimestamp([mod.PerWordTimestamp("good", 1, 2),
                                   mod.PerWordTimestamp("morning", 4, 9)], mod.Silence(2.0)),
            mod.SequenceTimestamp([mod.PerWordTimestamp("yes", 0, 1)], mod.Never()),
        ]
    files = ["a.wav", "b.wav", "c.wav"]
    terms = {}
    for name, mod in (("port", ctm), ("jax", jax_ctm)):
        terms[name] = mod.dump_ctm(files, seqs[name], str(tmp_path / f"{name}.ctm"), 0.06)
    assert (tmp_path / "port.ctm").read_text() == (tmp_path / "jax.ctm").read_text()
    assert _data(terms["port"]) == _data(terms["jax"])
    gt = tmp_path / "gt.ctm"
    gt.write_text("a.wav 1 0.050 0.100 hello \na.wav 1 0.200 0.150 World, \n"
                  "b.wav 1 0.0 0.1 good \nb.wav 1 0.2 0.3 morning \nb.wav 1 0.5 0 <eos>\n"
                  "c.wav 1 0.0 0.2 no \nd.wav 1 0.0 0.5 missing \n")
    assert _data(ctm.load_ctm(str(gt))) == _data(jax_ctm.load_ctm(str(gt)))
    for subs in (False, True):
        for with_terms in (False, True):
            got = ctm.measure_emission_latency(
                str(gt), str(tmp_path / "port.ctm"), include_subs=subs, frame_width=0.06,
                last_emit_time=terms["port"] if with_terms else None)
            want = jax_ctm.measure_emission_latency(
                str(gt), str(tmp_path / "jax.ctm"), include_subs=subs, frame_width=0.06,
                last_emit_time=terms["jax"] if with_terms else None)
            assert got == want
    a = ctm.align_transcripts(ctm.load_ctm(str(gt)), ctm.load_ctm(str(tmp_path / "port.ctm")),
                              terms["port"], True, 0.1, 0.05)
    b = jax_ctm.align_transcripts(jax_ctm.load_ctm(str(gt)),
                                  jax_ctm.load_ctm(str(tmp_path / "jax.ctm")), terms["jax"],
                                  True, 0.1, 0.05)
    assert _data(a) == _data(b)
    for lat in ([], [0.1], list(np.random.default_rng(0).random(37))):
        assert ctm.latency_stats(lat, 0.06) == jax_ctm.latency_stats(lat, 0.06)


HYPS = ["Hello, world. How are you?", "the cat sat.", "Yes! no, maybe?", "", "a b c."]
REFS = ["hello world, how are you?", "The cat sat", "yes no maybe.", "empty", "A b, c."]


def test_wer_breakdown_and_punctuation_match_jax(capsys):
    assert wer_breakdown.wer_breakdown(HYPS, REFS) == jax_wb.wer_breakdown(HYPS, REFS)
    assert (wer_breakdown.print_wer_breakdown(HYPS, REFS, ".,")
            == jax_wb.print_wer_breakdown(HYPS, REFS, ".,"))
    printed = capsys.readouterr().out
    assert printed[: len(printed) // 2] == printed[len(printed) // 2:]
    got = punctuation_error_rate.punctuation_error_rate(REFS, HYPS)
    want = jax_per.punctuation_error_rate(REFS, HYPS)
    assert _data(got) == _data(want)
    assert [c.rate for c in got.values()] == [c.rate for c in want.values()]


def test_the_metric_logger_writes_what_the_jax_logger_writes(tmp_path, capsys):
    for name, mod in (("port", logger), ("jax", jax_logger)):
        lg = mod.MetricLogger(log_file=tmp_path / f"{name}.jsonl")
        lg.log((0, 3), {"wer": 12.5, "note": "x", "n": 2}, subset="dev")
        lg.accumulate({"loss": 1.0, "bad": "y"})
        lg.accumulate({"loss": 3.0})
        lg.flush_accumulated(4)
        lg.close()
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]
    strip = lambda p: [{k: v for k, v in json.loads(line).items() if k != "ts"}
                       for line in p.read_text().splitlines()]
    assert strip(tmp_path / "port.jsonl") == strip(tmp_path / "jax.jsonl")
    lg = logger.init_log(tmp_path / "out", timestamp="t0")
    lg.log(1, {"a": 1})
    lg.close()
    assert (tmp_path / "out" / "log_t0.jsonl").exists()


def test_evaluate_trims_a_scripted_decode():
    """The port's evaluate over a scripted decoder whose output has a long
    gap: a Silence termination and the token after the gap trimmed, as the
    JAX package's test of its evaluate finds."""
    import torch

    from caiman_asr_tpu_torch.decoding.response import (
        DecodingResponse,
        FrameResponses,
        HypothesisResponse,
    )
    from caiman_asr_tpu_torch.evaluate.core import evaluate

    class Tok:
        def detokenize(self, ids):
            return " ".join("w%d" % i for i in ids)

        def id_to_piece(self, i):
            return "▁w%d" % i

    class Batch:
        audio = np.zeros((1, 16000), np.float32)
        audio_lens = np.array([16000])
        tokens = np.zeros((1, 1), np.int32)
        token_lens = np.array([1])
        transcripts = ["w1 w2"]
        fnames = ["utt0"]

    class Loader:
        def epoch(self, _):
            yield Batch()

    class Pipeline:
        device = torch.device("cpu")

        def __call__(self, audio, audio_lens, dataset_to_utt_ratio=0.0):
            return torch.zeros((100, 1, 240)), torch.tensor([100])  # 3 s of stacked frames

    def fin(tok, frame):
        return FrameResponses(partials=None, final=DecodingResponse(
            start_frame_idx=frame, duration_frames=1, is_provisional=False,
            alternatives=[HypothesisResponse(y_seq=[tok], timesteps=[frame],
                                             token_seq=["▁w%d" % tok], confidence=[1.0])]))

    class ScriptedDecoder:
        def decode(self, feats, feat_lens):
            assert isinstance(feats, torch.Tensor)
            return [{4: fin(1, 4), 9: fin(2, 9), 60: fin(3, 60)}]

    res = evaluate(None, ScriptedDecoder(), Loader(), Pipeline(), Tok(),
                   eos_vad_threshold=2.0, pre_enc_width=0.03, frame_width=0.06)
    assert _data(res.terminations) == [("Silence", {"final_time": (9 + 1 + 33) * 0.06})]
    assert res.hyps == ["w1 w2"]
    assert _data(res.word_timestamps[0].eos) == ("Silence", {"final_time": (9 + 1 + 33) * 0.06})
