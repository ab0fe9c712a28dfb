"""The port's streaming engine with ``decoder="beam"`` against the JAX
package's (``tests/serving/test_beam_engine.py``'s cases, and parity).

Both engines get the same JAX parameters (carried over with
``export/from_jax``), the same int16 audio and the same lane events. In fp32
the packed tick outputs the serializer reads must be equal at every tick:
the token windows, lengths, bases and rebase echoes exactly, the scores
within 1e-5 (fp32 sums in another order); and so must the responses. The
JAX engine runs synchronously (its pipelined mode on the CPU backend parted
from its own synchronous mode on some runs). Dither is 0 in both. The
host-side cases (window slides, rebases, cap saturation) drive the port's
native serializer through scripted packed outputs, as the JAX tests drive
its Python path.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.keywords.device_table import build_keyword_tables as jax_kw_tables
from caiman_asr_tpu.keywords.trie import Keywords as JaxKeywords
from caiman_asr_tpu.lm.device_table import build_device_tables as jax_lm_tables
from caiman_asr_tpu.lm.ngram import NGramLM as JaxNGramLM
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.ops.logmel import LogMelConfig as JaxLogMelConfig
from caiman_asr_tpu.serving.engine import StreamingEngine as JaxEngine
from caiman_asr_tpu.serving.engine import WireTick as JaxWireTick
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.keywords.device_table import build_keyword_tables
from caiman_asr_tpu_torch.keywords.trie import Keywords
from caiman_asr_tpu_torch.lm.device_table import build_device_tables
from caiman_asr_tpu_torch.lm.ngram import NGramLM
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
from caiman_asr_tpu_torch.serving.engine import StreamingEngine, WireTick, _Fetch

N_CLASSES = 12
BLANK = N_CLASSES - 1
# the shape of tests/serving/test_beam_engine.py
CFG = dict(in_feats=240, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=16,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
W = 3
SCORE_TOL = 1e-5


class Tok:
    def detokenize(self, ids):
        return "".join(chr(97 + i) for i in ids)

    def id_to_piece(self, i):
        return chr(97 + i)


PIECES = [Tok().id_to_piece(i) for i in range(N_CLASSES)]


@functools.cache
def _models(emit_bias: float = 8.0, cfg: tuple = ()):
    """JAX and port models on one set of JAX parameters; class 2's bias
    raised so that emitting is nearly free (as the JAX tests' engine), so
    hypotheses grow and the window slides."""
    c = dict(CFG, **dict(cfg))
    jm = JaxRNNT(JaxConfig(**c), N_CLASSES)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    params["joint_fc"]["b"] = params["joint_fc"]["b"] + np.float32(emit_bias) * (
        np.arange(N_CLASSES) == 2)
    tm = load_jax_params(RNNT(RNNTModelConfig(**c), N_CLASSES, device="cpu"), params)
    rng = np.random.default_rng(0)
    mel_stats = (rng.normal(size=80).astype(np.float32) * 0.1 - 8.0,
                 np.abs(rng.normal(size=80)).astype(np.float32) + 0.5)
    return jm, params, tm, mel_stats


def _fusion(tmp_path):
    """(JAX, port) n-gram and keyword tables over the engine's pieces."""
    rng = np.random.default_rng(1)
    words = PIECES[:-1]
    lines = ["\\data\\", f"ngram 1={len(words) + 1}", "", "\\1-grams:", "-2.0\t<unk>",
             *(f"{-rng.uniform(0.3, 2.5):.3f}\t{w}" for w in words), "", "\\end\\", ""]
    arpa = tmp_path / "lm.arpa"
    arpa.write_text("\n".join(lines))
    vocab = [("cd", 3.0), ("fa", 2.0)]
    return ((jax_lm_tables(JaxNGramLM.load(arpa), PIECES, skip_ids=[BLANK]),
             build_device_tables(NGramLM.load(arpa), PIECES, skip_ids=[BLANK])),
            (jax_kw_tables(JaxKeywords(vocab), PIECES, skip_ids=[BLANK]),
             build_keyword_tables(Keywords(vocab), PIECES, skip_ids=[BLANK])))


def jax_engine(models, **kw):
    jm, params, _, mel_stats = models
    dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[kw.pop("dtype",
                                                                               torch.float32)]
    return JaxEngine(jm, params, BLANK, Tok(), mel_stats=mel_stats, decoder="beam",
                     beam_width=W, logmel=JaxLogMelConfig(dither=0.0), dtype=dtype,
                     native_serializer=True, **kw)


def port_engine(models, **kw):
    _, _, tm, mel_stats = models
    return StreamingEngine(tm, BLANK, Tok(), mel_stats=mel_stats, decoder="beam", beam_width=W,
                           logmel=LogMelConfig(dither=0.0), device="cpu", **kw)


class Recorder:
    """The engine's serializer, recording each packed output it is given."""

    def __init__(self, ser):
        self.ser, self.packed = ser, []

    def __getattr__(self, name):
        return getattr(self.ser, name)

    def beam_tick(self, packed, adv):
        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.beam_tick(packed, adv)

    def beam_tick_raw(self, packed, adv):
        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.beam_tick_raw(packed, adv)


def _normalise(out):
    if isinstance(out, (WireTick, JaxWireTick)):
        out = out.to_dict()
    return {lane: (msgs if isinstance(msgs, list) else [msgs]) for lane, msgs in out.items()}


def _per_lane(responses):
    out = {}
    for tick in responses:
        for lane, msgs in tick.items():
            out.setdefault(lane, []).extend(msgs)
    return out


def chunk_source(seed):
    rng = np.random.default_rng(seed)
    return lambda n: (rng.normal(size=n) * 3000 * np.exp(rng.normal() * 2.0)).clip(
        -32768, 32767).astype(np.int16)


def drive(eng, seed=5, n_ticks=24):
    """Lane events over ``n_ticks`` ticks: opens, an EOS with a partial chunk
    buffered, a reopen into a used lane, lanes that skip ticks, odd pushes.
    Returns every tick's responses and the packed outputs."""
    rec = eng._native_ser = Recorder(eng._native_ser)
    chunk = chunk_source(seed)
    lanes = [eng.open_stream() for _ in range(3)]
    responses = []
    for t in range(n_ticks):
        if t == 7:
            eng.close_stream(lanes[1])
        if t == 10:
            lanes[1] = eng.open_stream()
            lanes.append(eng.open_stream())
        if t == 16:
            eng.close_stream(lanes[0])
        if t == 19:
            lanes[0] = eng.open_stream()
        for i, lane in enumerate(lanes):
            if lane not in eng.streams or eng.streams[lane].closed:
                continue
            if (t + i) % 5 == 3:
                continue
            eng.push_audio(lane, chunk(500 if (t + i) % 7 == 0 else 960))
        responses.append(_normalise(eng.tick()))
    for lane in list(eng.streams):
        eng.close_stream(lane)
    while eng.streams:
        responses.append(_normalise(eng.tick()))
    eng.close()
    return responses, rec.packed


def assert_packed_equal(got, want, adv_only=False):
    """Integer columns exact, the W score columns within SCORE_TOL."""
    assert len(got) == len(want) > 0
    for (g, ga), (w, wa) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        if adv_only:
            g, w = g[ga], w[wa]
        np.testing.assert_array_equal(g[:, :-W], w[:, :-W])
        np.testing.assert_allclose(g[:, -W:].view(np.float32), w[:, -W:].view(np.float32),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("mode", ["sync", "pipelined", "wire"])
def test_beam_engine_matches_jax_fp32(mode):
    models = _models()
    kw = dict(max_streams=4, max_symbols_per_step=4, beam_cap=32, beam_win=16)
    want_resp, want_packed = drive(jax_engine(models, **kw))
    got_resp, got_packed = drive(port_engine(models, **kw, wire_responses=mode == "wire",
                                             pipeline_depth=2 if mode == "pipelined" else 0))
    # pipelined, the staging alternates between two slots, so a lane that did
    # not advance steps on another stale row than the synchronous engine's
    # (its output is read by neither): only the lanes that advanced compare
    assert_packed_equal(got_packed, want_packed, adv_only=mode == "pipelined")
    if mode == "pipelined":
        assert _per_lane(got_resp) == _per_lane(want_resp)
    else:
        assert got_resp == want_resp
    assert sum(int(p[:, W * 16:W * 16 + W].sum()) for p, _ in got_packed) > 0


@pytest.mark.parametrize("fusion", ["lm", "kw", "both"])
def test_beam_engine_with_fusion_and_thresholds_matches_jax(fusion, tmp_path):
    models = _models(emit_bias=3.0)
    lm, kwt = _fusion(tmp_path)
    kw = dict(max_streams=4, max_symbols_per_step=4, beam_cap=32, beam_win=16,
              beam_score_thresh=0.4, beam_topk_thresh=1.5, beam_final_emission_frames=3)

    def fused(i):
        out = {}
        if fusion in ("lm", "both"):
            out.update(ngram_lm=lm[i], ngram_alpha=0.5)
        if fusion in ("kw", "both"):
            out["keywords"] = kwt[i]
        return out

    want_resp, want_packed = drive(jax_engine(models, **kw, **fused(0)), seed=6)
    got_resp, got_packed = drive(port_engine(models, **kw, **fused(1)), seed=6)
    assert_packed_equal(got_packed, want_packed)
    assert got_resp == want_resp


def test_forced_rebase_matches_jax():
    """A cap of 24 and streams of 40 ticks: rebases fire through the real
    host schedule (the echo column shows them), and the outputs, the echo
    included, stay the JAX engine's."""
    models = _models()
    kw = dict(max_streams=2, max_symbols_per_step=2, beam_cap=24, beam_win=8)

    def run(eng):
        rec = eng._native_ser = Recorder(eng._native_ser)
        chunk = chunk_source(12)
        lanes = [eng.open_stream(), eng.open_stream()]
        resp = []
        for t in range(40):
            for lane in lanes:
                if t < 36 or lane == lanes[0]:
                    eng.push_audio(lane, chunk(960))
            if t == 36:
                eng.close_stream(lanes[1])
            resp.append(_normalise(eng.tick()))
        eng.close_stream(lanes[0])
        while eng.streams:
            resp.append(_normalise(eng.tick()))
        eng.close()
        return resp, rec.packed

    want_resp, want = run(jax_engine(models, **kw))
    got_resp, got = run(port_engine(models, **kw))
    assert_packed_equal(got, want)
    assert got_resp == want_resp
    echo = np.concatenate([p[:, W * 8 + W + 1] for p, _ in got])
    assert (echo > 0).sum() >= 2


def test_rebase_shift_equals_preshifted_state():
    """A tick with rebase r gives the packed output and state of the tick
    on the buffers shifted by hand (the echo aside)."""
    eng = port_engine(_models(), max_streams=2)
    for _ in range(2):
        eng.open_stream()
    cap = eng._beam_cap
    toks = torch.zeros((eng.B, W, cap), dtype=torch.int32)
    toks[:, :, :80] = torch.arange(80, dtype=torch.int32) % 11
    st0 = dict(eng.dec_state, toks=toks, ts=toks.clone(),
               lens=torch.full((eng.B, W), 80, dtype=torch.int64))
    r = 30
    shifted = dict(st0, toks=torch.roll(toks, -r, dims=2), lens=st0["lens"] - r)
    shifted["ts"] = shifted["toks"].clone()
    samples = torch.from_numpy(chunk_source(3)((eng.B, eng.hop_samples)))
    carry = torch.zeros((eng.B, eng.carry_samples), dtype=torch.int16)

    def meta(rebase):
        m = torch.zeros(3 * eng.B + 1, dtype=torch.int32)
        m[:eng.B] = 1
        m[eng.B:2 * eng.B] = rebase
        m[-1] = 9
        return m

    with torch.no_grad():
        out_a, _, _, dec_a = eng._tick_impl(samples, carry, eng.enc_state, st0, eng._init_dec,
                                            meta(r))
        out_b, _, _, dec_b = eng._tick_impl(samples, carry, eng.enc_state, shifted,
                                            eng._init_dec, meta(0))
    echo = W * eng._beam_win // 2 + W + 1
    assert (out_a[:, echo] == r).all() and (out_b[:, echo] == 0).all()
    out_a[:, echo] = 0
    assert torch.equal(out_a, out_b)
    for k in dec_a:
        assert torch.equal(dec_a[k], dec_b[k]), k
    eng.close()


def test_lanes_as_many_as_layers_are_gated_by_lane():
    """max_streams equal to the predictor's layer count (2): a lane with no
    chunk keeps every leaf of its beam state. The JAX ``_gate_state`` tells
    [L, B, H] from [B, W, cap] by L != B and mis-gates here."""
    models = _models(cfg=(("pred_rnn_layers", 2),))
    eng = port_engine(models, max_streams=2)
    a, b = eng.open_stream(), eng.open_stream()
    chunk = chunk_source(4)
    for lane in (a, b):
        eng.push_audio(lane, chunk(960))
    eng.tick()
    before = {k: v.clone() for k, v in eng.dec_state.items()}
    enc_before = [t.clone() for hc in eng.enc_state for t in hc]
    eng.push_audio(a, chunk(960))
    eng.tick()
    for k, v in eng.dec_state.items():
        ax = 1 if k in ("h", "c") else 0
        assert torch.equal(v.select(ax, b), before[k].select(ax, b)), k
    assert all(torch.equal(x[:, b], y[:, b])
               for x, y in zip(enc_before, [t for hc in eng.enc_state for t in hc]))
    assert not torch.equal(eng.dec_state["h"][:, a], before["h"][:, a])
    eng.close()


def test_bf16_state_within_jax_bf16_distance():
    """bf16: over 12 ticks the port's beam scores and prediction-net states
    are no further from the JAX fp32 engine's than twice the JAX bf16
    engine's, leaf by leaf (the port rounds dot products before the bias,
    the JAX package after it)."""
    models = _models()
    kw = dict(max_streams=2, max_symbols_per_step=2)
    engines = (jax_engine(models, **kw), jax_engine(models, dtype=torch.bfloat16, **kw),
               port_engine(models, dtype=torch.bfloat16, **kw))
    lanes = [[e.open_stream() for e in engines] for _ in range(2)]
    chunk = chunk_source(9)
    err = np.zeros((2, 3))
    keys = ("h", "c", "g")
    for _ in range(12):
        for row in lanes:
            x = chunk(960)
            for e, lane in zip(engines, row):
                e.push_audio(lane, x)
        for e in engines:
            e.tick()
        ref = [np.asarray(engines[0].dec_state[k], np.float32) for k in keys]
        jbf = [np.asarray(engines[1].dec_state[k], np.float32) for k in keys]
        pbf = [engines[2].dec_state[k].float().numpy() for k in keys]
        err[0] = np.maximum(err[0], [np.abs(a - b).max() for a, b in zip(jbf, ref)])
        err[1] = np.maximum(err[1], [np.abs(a - b).max() for a, b in zip(pbf, ref)])
    for e in engines:
        e.close()
    assert (err[0] > 0).all()
    assert (err[1] <= 2 * err[0] + 1e-3).all(), err


def test_greedy_refuses_fusion():
    with pytest.raises(ValueError):
        StreamingEngine(_models()[2], BLANK, Tok(), device="cpu", keywords=object())
    with pytest.raises(ValueError):
        StreamingEngine(_models()[2], BLANK, Tok(), device="cpu", decoder="other")


# --------------------------------------------- the reference's own cases
def collect(eng, lane, audio):
    eng.push_audio(lane, audio)
    eng.close_stream(lane)
    finals, partials = [], 0
    while lane in eng.streams:
        out = _normalise(eng.tick())
        for m in out.get(lane, []):
            m = m if isinstance(m, dict) else json.loads(m)
            if m.get("eos"):
                continue
            if m["is_provisional"]:
                partials += 1
            else:
                finals.append(m["alternatives"][0]["transcript"])
    return finals, partials


def test_beam_streaming_lifecycle_and_prefix():
    """Responses flow, finals are a monotonic prefix of the best hypothesis
    (the same audio twice gives the same finals), lanes are recycled."""
    eng = port_engine(_models(), max_streams=2)
    audio = (np.random.default_rng(1).normal(size=960 * 6) * 0.1).astype(np.float32)
    a, pa = collect(eng, eng.open_stream(), audio)
    b, pb = collect(eng, eng.open_stream(), audio)
    assert a == b and "".join(a) and pa > 0
    assert not eng.streams
    eng.close()


def _packed(toks_full, lens, scores, win):
    """The wire array of one lane from full [W, cap] buffers: the window as
    int16 pairs in W*win/2 int32 lanes."""
    base = max(0, int(lens.max()) - win)
    window = toks_full[:, base:base + win].astype(np.int16)
    return np.concatenate([window.reshape(1, -1).view(np.int32),
                           lens.astype(np.int32)[None, :], np.array([[base]], np.int32),
                           np.array([[0]], np.int32),
                           scores.astype(np.float32).view(np.int32)[None, :]], axis=1)


def _consume(eng, lane, pk):
    adv = np.zeros(eng.B, bool)
    adv[lane] = True
    full = np.zeros((eng.B, pk.shape[1]), np.int32)
    full[lane] = pk[0]
    out = {}
    eng._consume([_Fetch(torch.from_numpy(full)), adv, None], out)
    return [json.loads(m) for m in out.get(lane, [])]


def _script(stall=True):
    cap = 64
    S = np.arange(45) % 10
    script = []
    for t in range(15):
        L = 3 * (t + 1)
        toks = np.zeros((W, cap), np.int64)
        for w in range(W):
            toks[w, :L] = S[:L]
            if t < 14:
                if stall and 5 <= t < 10:
                    toks[w, 10:L] = S[10:L] if w == 0 else 100 + w
                else:
                    toks[w, L - 2:L] = 100 + w
        script.append((toks, np.full(W, L), np.array([-1.0, -2.0, -3.0], np.float32)))
    return script, Tok().detokenize(list(S[:45]))


def test_window_slide_force_commit_matches_wide_window():
    script, want = _script()

    def drive_windowed(win):
        eng = port_engine(_models(), max_streams=2, beam_win=win)
        lane = eng.open_stream()
        finals = [m["alternatives"][0]["transcript"] for toks, lens, scores in script
                  for m in _consume(eng, lane, _packed(toks, lens, scores, win))
                  if not m["is_provisional"]]
        eng.close()
        return "".join(finals)

    assert drive_windowed(8) == drive_windowed(64) == want


def test_long_form_rebase_host_bookkeeping():
    """An echoed rebase shifts the serializer's committed and history
    coordinates: the final stream stays the never-rebased run's."""
    script, want = _script(stall=False)

    def run(with_rebase):
        eng = port_engine(_models(), max_streams=2, beam_win=16)
        lane = eng.open_stream()
        finals, shift = [], 0
        for t, (toks, lens, scores) in enumerate(script):
            r = 0
            if with_rebase and t == 8 and shift == 0:
                r = shift = eng._native_ser.committed(lane)
            tk = np.roll(toks, -shift, axis=1) if shift else toks
            pk = _packed(tk, lens - shift, scores, 16)
            pk[0, W * 16 // 2 + W + 1] = r
            finals += [m["alternatives"][0]["transcript"] for m in _consume(eng, lane, pk)
                       if not m["is_provisional"]]
        eng.close()
        return "".join(finals)

    assert run(True) == run(False) == want


def test_cap_saturation_force_commit_preserves_stream():
    """A step that appends 2 tokens a tick to every hypothesis with no
    agreement (hypothesis w emits w + 1; hypothesis 0 stays best): over 100
    ticks, 3x the cap, the stream ships all of hypothesis 0's tokens,
    window slides and rebases keep the buffers under the cap, and a lane
    reused after a close starts clean."""
    eng = port_engine(_models(), max_streams=2, beam_cap=64, beam_win=16,
                      max_symbols_per_step=4)
    cap = eng._beam_cap

    def fake_step(params, f_t, state):
        B = f_t.shape[0]
        st = dict(state)
        wix = torch.arange(W)[None].expand(B, W)
        for _ in range(2):
            pos = torch.clamp(st["lens"], 0, cap - 1)[:, :, None]
            st["toks"] = st["toks"].scatter(2, pos, (wix + 1).to(torch.int32)[:, :, None])
            st["ts"] = st["ts"].scatter(2, pos, st["frame"][:, None, None].expand(B, W, 1)
                                        .to(torch.int32))
            st["lens"] = torch.clamp(st["lens"] + 1, max=cap)
        st["scores"] = -torch.arange(1, W + 1, dtype=torch.float32)[None].expand(B, W)
        st["frame"] = st["frame"] + 1
        return st

    eng._beam.step = fake_step
    rng = np.random.default_rng(0)

    def stream(lane, ticks):
        finals, longest = [], 0
        for _ in range(ticks):
            eng.push_audio(lane, rng.normal(size=eng.hop_samples).astype(np.float32) * 0.05)
            out = _normalise(eng.tick())
            longest = max(longest, int(eng.dec_state["lens"].max()))
            assert longest < cap, "the device beam buffer saturated"
            finals += [m for m in out.get(lane, [])]
        eng.close_stream(lane)
        while lane in eng.streams:
            finals += _normalise(eng.tick()).get(lane, [])
        msgs = [m if isinstance(m, dict) else json.loads(m) for m in finals]
        return "".join(m["alternatives"][0]["transcript"] for m in msgs
                       if not m.get("eos") and not m["is_provisional"]), longest

    text, longest = stream(eng.open_stream(), 100)
    assert text == "b" * 200 and longest > cap // 2
    lane2, lane3 = eng.open_stream(), eng.open_stream()
    assert {lane2, lane3} == {0, 1}
    eng.close_stream(lane3)
    while lane3 in eng.streams:
        eng.tick()
    assert stream(lane2, 30)[0] == "b" * 60
    eng.close()


def test_pipeline_depth_preserves_final_stream():
    audio = (np.random.default_rng(8).normal(size=960 * 8) * 0.1).astype(np.float32)
    runs = []
    for depth in (0, 3):
        eng = port_engine(_models(), max_streams=2, pipeline_depth=depth)
        runs.append(collect(eng, eng.open_stream(), audio)[0])
        eng.close()
    assert runs[0] == runs[1] and "".join(runs[0])


def test_keyword_boost_end_to_end():
    """A heavily boosted keyword shows up in the served transcript where it
    did not without boosting."""
    models = _models(emit_bias=0.0)
    audio = (np.random.default_rng(11).normal(size=960 * 6) * 0.1).astype(np.float32)

    def run(keywords):
        eng = port_engine(models, max_streams=1, keywords=keywords)
        text = "".join(collect(eng, eng.open_stream(), audio)[0])
        eng.close()
        return text

    base = run(None)
    boosted = next(ch for ch in PIECES[:-1] if ch not in base)
    assert boosted in run(build_keyword_tables(Keywords([(boosted, 50.0)]), PIECES))


def test_beam_engine_with_pruning_thresholds_resets_the_watermark():
    eng = port_engine(_models(), max_streams=2, beam_score_thresh=0.4, beam_topk_thresh=1.5,
                      beam_final_emission_frames=3)
    assert "committed" in eng.dec_state and "since_final" in eng.dec_state
    audio = (np.random.default_rng(5).normal(size=960 * 6) * 0.1).astype(np.float32)
    texts = ["".join(collect(eng, eng.open_stream(), audio)[0]) for _ in range(2)]
    assert texts[0] == texts[1] and not eng.streams
    eng.close()
