"""The port's streaming clients against the JAX package's: the terminal
stack and the live client's view (mirrors tests/inference/test_term_stack.py),
the user-perceived-latency fusion (mirrors tests/latency/test_upl_client.py),
``measures.measure``, and both packages' ``transcribe_file`` against the
port's server on localhost over a CPU engine. Each result must equal the
JAX one exactly: the ANSI stream written, the fused times, the measures,
the transcripts and responses."""

import asyncio
import io
import json
import socket
import wave

import numpy as np
import pytest

from caiman_asr_tpu.inference import measures as jax_measures
from caiman_asr_tpu.inference import transcriber as jax_transcriber
from caiman_asr_tpu.inference.live_client import TranscriptView as JaxView
from caiman_asr_tpu.inference.term_stack import Style as JaxStyle
from caiman_asr_tpu.inference.term_stack import TermStack as JaxStack
from caiman_asr_tpu.latency import client as jax_upl
from caiman_asr_tpu_torch.inference import measures, transcriber
from caiman_asr_tpu_torch.inference.live_client import TranscriptView
from caiman_asr_tpu_torch.inference.term_stack import Style, TermStack
from caiman_asr_tpu_torch.latency import client as upl
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
from caiman_asr_tpu_torch.serving.engine import StreamingEngine
from caiman_asr_tpu_torch.serving.server import ASRServer

# ------------------------------------------------------------ term stack
STACK_SCRIPTS = {
    "push": ([("push", "hello world", "final")], 80),
    "push_pop": ([("push", "hello", None), ("push", " world", None), ("pop",)], 80),
    "pop_all": ([("push", "hello", None), ("pop",)], 80),
    "wrap": ([("push", "aaa bbb ccc", None)], 8),
    "cross_line_pop": ([("push", "aaa bbb", None), ("push", " ccc ddd", None), ("pop",)], 8),
    "fragment_wraps": ([("push", "abcdef", None), ("push", "ghi", None)], 8),
    "fragment_pop": ([("push", "abcdef", None), ("push", "ghi", None), ("pop",)], 8),
    "long_word": ([("push", "abcdefghijkl mn", "partial"), ("pop",), ("pop",)], 8),
    "empty": ([("push", "", None), ("pop",), ("push", " x", "final")], 8),
}


def _render(stack_cls, style_cls, actions, cols):
    buf = io.StringIO()
    st = stack_cls(cols=cols, out=buf)
    for act, *args in actions:
        if act == "push":
            text, sty = args
            st.push(text, None if sty is None else getattr(style_cls, sty.upper()))
        else:
            st.pop()
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(STACK_SCRIPTS))
def test_term_stack_writes_the_jax_stream(name):
    actions, cols = STACK_SCRIPTS[name]
    want = _render(JaxStack, JaxStyle, actions, cols)
    assert _render(TermStack, Style, actions, cols) == want
    assert want.strip()  # something was written


VIEW_UPDATES = [
    {"is_provisional": True, "alternatives": [{"transcript": " he"}]},
    {"is_provisional": True, "alternatives": [{"transcript": " hello wo"}]},
    {"is_provisional": False, "alternatives": [{"transcript": " hello world"}]},
    {"is_provisional": True, "alternatives": [{"transcript": " aga"}]},
    {"is_provisional": False, "alternatives": [{"transcript": " again"}]},
    {"is_provisional": True, "alternatives": []},
    {"is_provisional": False, "alternatives": [{"transcript": ""}]},
]


def test_transcript_view_writes_the_jax_stream():
    out = []
    for view_cls in (JaxView, TranscriptView):
        buf = io.StringIO()
        view = view_cls(cols=12, out=buf)
        for r in VIEW_UPDATES:
            view.update(r)
        out.append(buf.getvalue())
    assert out[0] == out[1]


# ------------------------------------------------------------ UPL fusion
UPL_SCRIPTS = {  # (text, arrival, is_partial)
    "surviving_prefix": [("ab c", 1.0, True), ("ab c", 5.0, False)],
    "overwritten": [("ax", 1.0, True), ("ab", 2.0, True), ("ab", 5.0, False)],
    "flicker": [("a", 1.0, True), ("x", 2.0, True), ("a", 3.0, True), ("a", 5.0, False)],
    "short_partial": [("ab", 1.0, True), ("a", 2.0, True), ("ab", 5.0, False)],
    "tail_carries": [("abcde", 1.0, True), ("abc", 2.0, False), ("de", 5.0, False)],
    "client_model": [("he", 0.0, True), ("hel", 1.0, True), ("help", 2.0, True),
                     ("hel", 3.0, False), ("p me", 4.0, True), ("p me", 5.0, False)],
    "words": [("the ca", 0.5, True), ("the cat s", 1.2, True), ("the cat", 1.5, False),
              (" sat on", 2.0, True), (" sat", 2.5, False), ("  on  it ", 3.0, False)],
}


@pytest.mark.parametrize("name", sorted(UPL_SCRIPTS))
def test_upl_fusion_matches_jax(name):
    script = UPL_SCRIPTS[name]
    got = [upl.ServerResponse(*r) for r in script]
    want = [jax_upl.ServerResponse(*r) for r in script]
    assert upl.fuse_timestamps(got) == jax_upl.fuse_timestamps(want)
    assert upl.get_word_timestamps(got) == jax_upl.get_word_timestamps(want)
    assert upl.get_word_timestamps(got)


# ------------------------------------------------------------ measures
def _results(mod, seed):
    rng = np.random.default_rng(seed)
    words = ["order", "even", "though", "it", "was", "late", "Mr.", "St", "won't", "12"]
    out = []
    for u in range(4):
        res = mod.TranscriptionResult(fname=f"u{u}.wav", duration=3.0)
        t = 0.0
        for k in range(int(rng.integers(1, 6))):
            t += float(rng.uniform(0.05, 0.5))
            end = float(rng.uniform(0.0, t))
            text = " " + " ".join(rng.choice(words, size=int(rng.integers(1, 3))))
            res.responses.append(mod.TimedResponse(t, {
                "start": 0.0, "end": end, "is_provisional": bool(k % 3 == 1),
                "alternatives": [{"transcript": text, "confidence": 0.5}]}))
        out.append(res)
    return out


@pytest.mark.parametrize("standardize", [True, False])
def test_measures_match_jax(standardize):
    refs = ["order even though it was late", "mister saint", "will not twelve", ""]
    got = measures.measure(_results(transcriber, 0), refs, standardize=standardize)
    want = jax_measures.measure(_results(jax_transcriber, 0), refs, standardize=standardize)
    assert got == want
    assert got["n_responses"] > 0 and got["wer"] > 0


# ------------------------------------------------------------ transcribe_file
CFG = dict(in_feats=240, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=16,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
N_CLASSES = 12


class Tok:
    def id_to_piece(self, i):
        return "▁" * (i % 3 == 0) + chr(97 + i)


def _wav(path, seed, secs):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=int(secs * 16000)) * 3000 * np.exp(rng.normal())).clip(
        -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(x.tobytes())
    return str(path)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_transcribe_file_against_the_port_server(tmp_path):
    import torch
    import websockets.asyncio.server

    torch.manual_seed(0)
    model = RNNT(RNNTModelConfig(**CFG), N_CLASSES, device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.joint_net[2].bias[-1] -= 2.0  # lanes emit on most frames
    engine = StreamingEngine(model, N_CLASSES - 1, Tok(), max_streams=4,
                             max_symbols_per_step=4, logmel=LogMelConfig(dither=0.0),
                             device="cpu")
    files = [_wav(tmp_path / f"u{i}.wav", 50 + i, secs) for i, secs in enumerate((1.3, 0.7))]
    port = _free_port()
    uri = f"ws://127.0.0.1:{port}/asr/v0.1/stream"

    async def run():
        srv = ASRServer(engine, tick_interval=0.002)
        ticker = asyncio.create_task(srv._ticker())
        async with websockets.asyncio.server.serve(srv.handle, "127.0.0.1", port,
                                                   subprotocols=[transcriber.SUBPROTOCOL]):
            out = []
            for mod in (jax_transcriber, transcriber):
                out.append(await asyncio.wait_for(asyncio.gather(*(
                    mod.transcribe_file(uri, f, realtime=False) for f in files)), 60))
        ticker.cancel()
        return out

    jax_res, port_res = asyncio.run(run())
    engine.close()
    for g, w in zip(port_res, jax_res):
        assert type(g).__module__.startswith("caiman_asr_tpu_torch")
        assert g.fname == w.fname and g.duration == w.duration
        assert [r.response for r in g.responses] == [r.response for r in w.responses]
        assert g.transcript == w.transcript
    assert any(r.transcript for r in port_res)


def test_file_streamer_sends_the_jax_bytes(tmp_path):
    """Both streamers send the same chunks. The reference's trait, kept: a
    WAV sample k (read as k / 32768) goes out as trunc(k * 32767 / 32768),
    one step toward zero for every k other than 0."""
    from caiman_asr_tpu.inference.file_streamer import FileStreamer as JaxStreamer
    from caiman_asr_tpu_torch.inference.file_streamer import FileStreamer

    path = _wav(tmp_path / "s.wav", 60, 0.53)
    got = list(FileStreamer(path, 0.1, realtime=False))
    assert got == list(JaxStreamer(path, 0.1, realtime=False))
    assert [len(c) for c in got] == [3200] * 5 + [2 * (8480 - 5 * 1600)]
    with wave.open(path, "rb") as w:
        k = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int64)
    sent = np.frombuffer(b"".join(got), "<i2").astype(np.int64)
    np.testing.assert_array_equal(sent, k - np.sign(k))


class _FlakyConnect:
    """``websockets.asyncio.client.connect`` whose first connection sends one
    response and then fails; the next ones answer EOS with one response."""

    def __init__(self):
        self.calls = 0

    def __call__(self, uri, subprotocols=None):
        self.calls += 1
        return _FlakyConnection(self.calls)


class _FlakyConnection:
    def __init__(self, attempt):
        self.attempt, self.inbox = attempt, asyncio.Queue()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    async def send(self, msg):
        if msg == b"":
            await self.inbox.put(None)

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self.attempt == 1:
            if getattr(self, "sent_one", False):
                raise ConnectionResetError("dropped")
            self.sent_one = True
            return json.dumps({"start": 0.0, "end": 0.06, "is_provisional": False,
                               "alternatives": [{"transcript": " first", "confidence": 1.0}]})
        if getattr(self, "done", False):
            raise StopAsyncIteration
        await self.inbox.get()  # the client's EOS
        self.done = True
        return json.dumps({"start": 0.06, "end": 0.12, "is_provisional": False,
                           "alternatives": [{"transcript": " second", "confidence": 1.0}]})


def test_transcribe_file_retry_keeps_the_failed_attempts_responses(tmp_path, monkeypatch):
    """The reference's trait, kept: a retry after a dropped connection
    appends to the same result, so the failed attempt's responses stay."""
    import websockets.asyncio.client

    path = _wav(tmp_path / "r.wav", 61, 0.2)
    texts = []
    for mod in (jax_transcriber, transcriber):
        monkeypatch.setattr(websockets.asyncio.client, "connect", _FlakyConnect())
        res = asyncio.run(mod.transcribe_file("ws://x", path, realtime=False))
        texts.append([r.response["alternatives"][0]["transcript"] for r in res.responses])
    assert texts[0] == texts[1] == [" first", " second"]
