"""The port's streaming engine against the JAX package's, and against the
port's own offline transcription.

Both engines get the same JAX parameters (carried over with
``export/from_jax``), the same int16 audio and the same lane events: opens,
closes, a reopen into a used lane, lanes that do not advance on some ticks,
pushes of odd sizes. In fp32 the packed int32 tick outputs (tokens and
counts) must be equal at every tick, and so must the responses; in
synchronous, pipelined and wire modes (a lane that did not advance has
count 0 and its token slots are read by neither). Dither is 0 in both (the
JAX dither is a ``jax.random`` key, the port's a counter hash).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.decoding.greedy import init_decode_state as jax_init_decode_state
from caiman_asr_tpu.decoding.greedy import make_streaming_step as jax_streaming_step
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.ops.logmel import LogMelConfig as JaxLogMelConfig
from caiman_asr_tpu.serving.engine import StreamingEngine as JaxEngine
from caiman_asr_tpu.serving.engine import WireTick as JaxWireTick
from caiman_asr_tpu_torch import offline
from caiman_asr_tpu_torch.decoding.greedy import init_decode_state, make_streaming_step
from caiman_asr_tpu_torch.decoding.response import frame_responses_to_tokens
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import PipelineConfig, RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
from caiman_asr_tpu_torch.serving.engine import StreamingEngine, WireTick, dither_noise

N_CLASSES = 12
BLANK = N_CLASSES - 1
# the shape of tests/serving/test_engine.py:33-45
CFG = dict(in_feats=240, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=16,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
N_TICKS = 32
BLANK_RAISE = 0.3


def chunk_source(seed):
    """int16 noise chunks whose loudness varies chunk to chunk (log-normal),
    so that the features, and the decisions, vary."""
    rng = np.random.default_rng(seed)
    return lambda n: (rng.normal(size=n) * 3000 * np.exp(rng.normal() * 2.0)).clip(
        -32768, 32767).astype(np.int16)


class Tok:
    def detokenize(self, ids):
        return "".join(chr(97 + i) for i in ids)

    def id_to_piece(self, i):
        return chr(97 + i)


@pytest.fixture(scope="module")
def models():
    jm = JaxRNNT(JaxConfig(**CFG), N_CLASSES)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    # a blank bias raised so that lanes emit 0 to 4 symbols a tick, not
    # always the most
    params["joint_fc"]["b"] = params["joint_fc"]["b"] + np.eye(N_CLASSES, dtype=np.float32)[
        BLANK] * BLANK_RAISE
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG), N_CLASSES, device="cpu"), params)
    rng = np.random.default_rng(0)
    mel_stats = (rng.normal(size=80).astype(np.float32) * 0.1 - 8.0,
                 np.abs(rng.normal(size=80)).astype(np.float32) + 0.5)
    return jm, params, tm, mel_stats


def jax_engine(models, **kw):
    jm, params, _, mel_stats = models
    dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[kw.pop("dtype",
                                                                               torch.float32)]
    return JaxEngine(jm, params, BLANK, Tok(), mel_stats=mel_stats,
                     logmel=JaxLogMelConfig(dither=0.0), dtype=dtype, **kw)


def port_engine(models, **kw):
    _, _, tm, mel_stats = models
    return StreamingEngine(tm, BLANK, Tok(), mel_stats=mel_stats,
                           logmel=LogMelConfig(dither=0.0), device="cpu", **kw)


class Recorder:
    """The engine's serializer, recording each packed tick output it is given."""

    def __init__(self, ser):
        self.ser, self.packed = ser, []

    def __getattr__(self, name):
        return getattr(self.ser, name)

    def greedy_tick(self, packed, adv):
        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.greedy_tick(packed, adv)

    def greedy_tick_raw(self, packed, adv):
        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.greedy_tick_raw(packed, adv)


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


def drive(eng, seed=5, n_ticks=N_TICKS):
    """One script of lane events over ``n_ticks`` ticks: returns the
    responses of every tick and the packed outputs the serializer saw."""
    rec = eng._native_ser = Recorder(eng._native_ser)
    chunk = chunk_source(seed)
    lanes = [eng.open_stream() for _ in range(3)]
    responses = []
    for t in range(n_ticks):
        if t == 9:
            eng.close_stream(lanes[1])        # EOS with a partial chunk buffered
        if t == 12:
            lanes[1] = eng.open_stream()      # lane 3, the never-used one
            lanes.append(eng.open_stream())   # the lane closed at tick 9
        if t == 20:
            eng.close_stream(lanes[0])
        if t == 24:
            lanes[0] = eng.open_stream()      # reopen the lane closed at 20
        for i, lane in enumerate(lanes):
            if lane not in eng.streams or eng.streams[lane].closed:
                continue
            if (t + i) % 5 == 3:
                continue                      # this lane does not advance
            eng.push_audio(lane, chunk(500 if (t + i) % 7 == 0 else 960))
        responses.append(_normalise(eng.tick()))
    for lane in list(eng.streams):
        eng.close_stream(lane)
    while eng.streams:
        responses.append(_normalise(eng.tick()))
    eng.close()
    return responses, rec.packed


@pytest.mark.parametrize("mode", ["sync", "pipelined", "wire"])
def test_engine_matches_jax_fp32(models, mode):
    kw = dict(max_streams=4, max_symbols_per_step=4,
              pipeline_depth=2 if mode == "pipelined" else 0,
              wire_responses=mode == "wire")
    # the JAX reference runs synchronously: its pipelined mode on the CPU
    # backend hands the staging slot back while the device copy may still
    # read it, and parted from its own synchronous mode on some runs
    want_resp, want_packed = drive(jax_engine(models, **dict(kw, pipeline_depth=0)))
    got_resp, got_packed = drive(port_engine(models, **kw))
    assert len(got_packed) == len(want_packed) >= 30
    for (g, ga), (w, wa) in zip(got_packed, want_packed):
        np.testing.assert_array_equal(ga, wa)
        # every lane's count; the tokens of the lanes that advanced (a lane
        # that did not advance has count 0, and both packages leave its
        # token slots to whatever its stale staging row decoded to)
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
        np.testing.assert_array_equal(g[ga], w[wa])
    if mode == "pipelined":  # the same messages, each lane's in order, ticks later
        assert _per_lane(got_resp) == _per_lane(want_resp)
    else:
        assert got_resp == want_resp
    assert sum(int(p[:, -1].sum()) for p, _ in got_packed) > 0  # tokens were emitted


def test_engine_bf16_within_tolerance(models):
    """bf16: the JAX tick (T=2, below its Pallas gate) runs the plain scan,
    which keeps the input projection in fp32; the port rounds it to bf16,
    as K1 takes it. So both bf16 engines are held against the JAX fp32
    engine on the same audio: over 16 ticks the port's encoder states may
    be no further from it than twice the JAX bf16 engine's, leaf by leaf."""
    kw = dict(max_streams=4, max_symbols_per_step=4)
    engines = (jax_engine(models, **kw), jax_engine(models, dtype=torch.bfloat16, **kw),
               port_engine(models, dtype=torch.bfloat16, **kw))
    lanes = [[e.open_stream() for e in engines] for _ in range(3)]
    chunk = chunk_source(9)
    err_jax, err_port = np.zeros(4), np.zeros(4)
    for _ in range(16):
        for row in lanes:
            x = chunk(960)
            for e, lane in zip(engines, row):
                e.push_audio(lane, x)
        for e in engines:
            e.tick()
        ref, jbf = ([np.asarray(a, np.float32) for a in jax.tree.leaves(e.enc_state)]
                    for e in engines[:2])
        pbf = [t.float().numpy() for hc in engines[2].enc_state for t in hc]
        err_jax = np.maximum(err_jax, [np.abs(a - r).max() for a, r in zip(jbf, ref)])
        err_port = np.maximum(err_port, [np.abs(a - r).max() for a, r in zip(pbf, ref)])
    assert np.all(err_port <= 2 * err_jax + 1e-3), (err_port, err_jax)
    for e in engines:
        e.close()


def test_streaming_matches_offline(models):
    """The port's engine, fed 60 ms at a time, emits the tokens of the
    port's offline transcription of the same audio (as
    tests/serving/test_engine.py::test_streaming_matches_offline). Both at
    one symbol a frame: past one, the two decoders count differently (the
    streaming step up to ``max_symbols_per_step`` a frame; the offline loop,
    the reference's batched greedy, until a count kept across frames
    reaches it), and this model emits on most frames."""
    _, _, tm, mel_stats = models
    chunk = chunk_source(7)
    n_ticks = 16
    audio = np.concatenate([chunk(960) for _ in range(n_ticks)]).astype(np.float32) / 32768
    resp = offline.transcribe(tm, audio[None], np.asarray([len(audio)]), mel_stats,
                              device="cpu", pipeline=PipelineConfig(LogMelConfig(dither=0.0)),
                              max_symbols_per_step=1)
    offline_tokens = frame_responses_to_tokens(resp[0])
    assert len(offline_tokens) >= n_ticks // 2

    eng = port_engine(models, max_streams=4, max_symbols_per_step=1)
    rec = eng._native_ser = Recorder(eng._native_ser)
    lane = eng.open_stream()
    for i in range(n_ticks):
        eng.push_audio(lane, audio[i * 960:(i + 1) * 960])
        eng.tick()
    eng.close_stream(lane)
    assert eng.tick()[lane] == {"eos": True}
    streamed = [int(t) for p, adv in rec.packed for t in p[lane, :p[lane, -1]]]
    assert streamed == offline_tokens


@pytest.mark.parametrize("max_symbols,eos", [(1, False), (4, False), (8, False), (4, True)])
def test_streaming_step_matches_jax(models, max_symbols, eos):
    """``make_streaming_step`` against the JAX function on the same frames
    and state: tokens and counts equal, the state within 1e-5 (as
    tests/decoding/test_greedy.py:135); with an EOS strategy, through the
    normalised log-probabilities instead of the argmax of the logits."""
    from caiman_asr_tpu.decoding.eos import EOSPredict as JaxEOSPredict
    from caiman_asr_tpu_torch.decoding.eos import EOSPredict

    jm, params, tm, _ = models
    rng = np.random.default_rng(max_symbols)
    B = 6
    f = (rng.normal(size=(B, CFG["joint_n_hid"])) * 2).astype(np.float32)
    jstep = jax.jit(jax_streaming_step(
        jm, BLANK, max_symbols_per_step=max_symbols,
        eos_strategy=JaxEOSPredict(3, alpha=0.5, beta=0.2) if eos else None))
    tstep = make_streaming_step(tm, BLANK, max_symbols_per_step=max_symbols,
                                eos_strategy=EOSPredict(3, alpha=0.5, beta=0.2) if eos else None)
    jstate = jax_init_decode_state(jm, params, B)
    tstate = init_decode_state(tm, B)
    for a, b in zip(jstate, tstate):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    for _ in range(3):  # the state carried over three frames
        jt, jn, jstate = jstep(params, jnp.asarray(f), jstate)
        tt, tn, tstate = tstep(tm.param_tree(), torch.from_numpy(f), tstate)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for a, b in zip(jstate, tstate):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
        f = np.roll(f, 1, axis=0)
    assert int(tn.sum()) > 0


def test_lane_lifecycle_and_capacity(models):
    eng = port_engine(models, max_streams=2)
    a, b = eng.open_stream(), eng.open_stream()
    assert eng.open_stream() is None  # full
    eng.close_stream(a)
    assert eng.tick()[a]["eos"]
    assert eng.open_stream() == a     # lane recycled
    eng.push_audio(b, np.zeros(960, np.float32))
    eng.tick()
    assert eng.lane_frames(b) == 1
    eng.close()


def test_unported_options_raise(models):
    """The beam is ported (tests/test_torch_beam_engine.py); n-gram fusion
    and keyword boosting need it, and an unknown decoder is refused."""
    for kw in (dict(decoder="nbest"), dict(ngram_lm=object()), dict(keywords=object())):
        with pytest.raises(ValueError):
            port_engine(models, **kw)


def test_cuda_engine_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, tm, _ = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEngine(tm, BLANK, Tok())


def test_dither_noise():
    """The dither is a function of (seed, tick, element): the same call
    gives the same bits, another tick other bits, and its moments are a
    standard normal's."""
    t = torch.tensor(5, dtype=torch.int32)
    a = dither_noise((64, 1201), t, 4242)
    assert torch.equal(a, dither_noise((64, 1201), t, 4242))
    assert not torch.equal(a, dither_noise((64, 1201), t + 1, 4242))
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1.0) < 0.02


def test_a_lane_that_does_not_advance_keeps_its_state():
    """With as many lanes as an LSTM stack has layers (2 here, as
    base-85M's pre-stack and predictor), a lane with no chunk keeps every
    layer's state. The JAX package's ``_gate_state`` tells a stack [L, B, H]
    from a [B, W, cap] buffer by L != B, so there it gates the layers by the
    lanes' flags."""
    cfg = dict(CFG, enc_pre_rnn_layers=2, enc_post_rnn_layers=2, pred_rnn_layers=2)
    model = RNNT(RNNTModelConfig(**cfg), N_CLASSES, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    eng = StreamingEngine(model, BLANK, Tok(), max_streams=2, device="cpu",
                          logmel=LogMelConfig(dither=0.0))
    a, b = eng.open_stream(), eng.open_stream()
    chunk = chunk_source(4)
    eng.push_audio(a, chunk(960))
    eng.push_audio(b, chunk(960))
    eng.tick()
    state = lambda: [t.clone() for hc in eng.enc_state for t in hc] + list(  # noqa: E731
        t.clone() for t in eng.dec_state)
    before = state()
    eng.push_audio(a, chunk(960))
    eng.tick()
    after = state()
    lane_b = lambda t: t[:, b] if t.dim() == 3 else t[b]  # noqa: E731
    assert all(torch.equal(lane_b(x), lane_b(y)) for x, y in zip(before, after))
    assert not torch.equal(before[0][:, a], after[0][:, a])
    eng.close()


def test_dropped_pipelined_engine_is_collected(models):
    """The uploader and fetcher threads hold no reference to the engine: a
    pipelined engine dropped without close() is garbage collected and its
    threads exit (as tests/serving/test_engine.py's JAX test)."""
    import gc
    import weakref

    eng = port_engine(models, max_streams=2, pipeline_depth=2)
    threads = (eng._up_thread, eng._fetch_thread)
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_poll_drains_pipelined_ticks(models):
    """poll() hands out a pipelined tick's responses once its output is on
    the host, without another tick; tick and poll together give the
    synchronous engine's responses, lane by lane."""
    import time

    def run(depth):
        eng = port_engine(models, max_streams=2, max_symbols_per_step=4,
                          pipeline_depth=depth)
        lane, chunk, got = eng.open_stream(), chunk_source(11), []
        for _ in range(6):
            eng.push_audio(lane, chunk(960))
            got.append(_normalise(eng.tick()))
            if depth:
                eng._upq.join()  # the tick dispatched: poll alone must drain it
            deadline = time.time() + 10
            while eng._pending and time.time() < deadline:
                got.append(_normalise(eng.poll()))
                time.sleep(0.002)
        assert not eng._pending
        eng.close()
        return _per_lane(got)

    want = run(0)
    assert want and run(2) == want
