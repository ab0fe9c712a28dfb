"""The port's serving bundle loader, WebSocket server and state-reset router
against the JAX package's.

One bundle is written in the JAX package's format (a checkpoint of JAX
parameters, dataset mel statistics, a SentencePiece model): both packages'
``build_engine`` read it, and the port's engine then computes the JAX
engine's packed outputs; both servers, on localhost, send the same text
frames for the same audio and refuse the same requests; and
``StateResetRouter`` over either engine gives the same responses. Dither
is 0 in the config: the JAX dither is a ``jax.random`` key, the port's a
counter hash.
"""

import asyncio
import json
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch
import yaml

from caiman_asr_tpu.export.checkpointer import save_checkpoint
from caiman_asr_tpu.export.serving_bundle import create_serving_bundle
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.serving import server as jax_server
from caiman_asr_tpu.serving.state_resets import StateResetRouter as JaxRouter
from caiman_asr_tpu_torch.export.serving_bundle import load_serving_bundle
from caiman_asr_tpu_torch.serving import server
from caiman_asr_tpu_torch.serving.state_resets import StateResetRouter

N_PIECES = 11  # the classes: the pieces and the blank
CFG = dict(in_feats=240, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=16,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
FB = dict(sample_rate=16000, window_size=0.025, window_stride=0.01, n_fft=512, n_filt=80,
          dither=0.0)
PATH = "/asr/v0.1/stream?content_type=audio/x-raw;format=S16LE;channels=1;rate=16000"


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from caiman_asr_tpu.data.tokenizer import save_sentencepiece_model

    d = tmp_path_factory.mktemp("bundle")
    spm = d / "tok.model"
    save_sentencepiece_model(spm, [("<unk>", 0.0, 2)] + [
        ("▁" * (i % 2) + chr(97 + i), -float(i + 1), 1) for i in range(N_PIECES - 1)])
    splice = {"frame_stacking": 3, "frame_subsampling": 3}
    config = d / "model.yaml"
    config.write_text(yaml.safe_dump({
        "tokenizer": {"sentpiece_model": str(spm), "labels": ["a"], "sampling": 0.0},
        "input_val": {"filterbank_features": FB, "frame_splicing": splice},
        "input_train": {"filterbank_features": FB, "frame_splicing": splice},
        "rnnt": CFG}))
    params = jax.tree.map(np.asarray, JaxRNNT(JaxConfig(**CFG), N_PIECES + 1).init(
        jax.random.PRNGKey(3)))
    # blank (the last class) raised so that lanes emit 0 to 4 symbols a tick
    params["joint_fc"]["b"] = params["joint_fc"]["b"] + np.float32(0.3) * (
        np.arange(N_PIECES + 1) == N_PIECES).astype(np.float32)
    ckpt = d / "ckpt.npz"
    save_checkpoint(ckpt, params, meta={"logmel_norm_weight": 1.0})
    rng = np.random.default_rng(0)
    stats = d / "stats.npz"
    np.savez(stats, melmeans=rng.normal(size=80).astype(np.float32) * 0.1 - 8.0,
             melvars=(np.abs(rng.normal(size=80)) + 0.5).astype(np.float32) ** 2)
    out = create_serving_bundle(ckpt, config, d / "bundle.npz", mel_stats_path=stats,
                                sentencepiece_path=spm, skip_state_dict_check=True)
    return {"config": str(config), "bundle": str(out), "params": params, "ckpt": str(ckpt),
            "stats": str(stats)}


def _args(bundle, **kw):
    return Namespace(**{**dict(
        model_config=bundle["config"], serving_bundle=bundle["bundle"], ckpt=None,
        tokenizer_model=None, mel_stats_path=None, max_streams=4, pipeline_depth=0,
        wire_responses=False, decoder="greedy", num_chips=1, device="cpu"), **kw})


def _chunks(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=960) * 3000 * np.exp(rng.normal() * 2.0)).clip(
        -32768, 32767).astype(np.int16) for _ in range(n)]


class Recorder:
    def __init__(self, ser):
        self.ser, self.packed = ser, []

    def __getattr__(self, name):
        return getattr(self.ser, name)

    def greedy_tick(self, packed, adv):
        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.greedy_tick(packed, adv)


def test_bundle_loads_and_the_engine_matches_jax(bundle):
    weights, extras, meta = load_serving_bundle(bundle["bundle"])
    assert {"melmeans", "melvars", "sentencepiece"} <= set(extras)
    assert meta["rnnt_config"]["enc_n_hid"] == CFG["enc_n_hid"]
    flat = jax.tree_util.tree_leaves_with_path(bundle["params"])
    for path, leaf in flat:
        node = weights
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    engines = (jax_server.build_engine(_args(bundle)), server.build_engine(_args(bundle)))
    logs = []
    for eng in engines:
        rec = eng._native_ser = Recorder(eng._native_ser)
        lanes = [eng.open_stream() for _ in range(3)]
        for t, chunks in enumerate(zip(*(_chunks(s, 20) for s in range(3)))):
            for i, (lane, x) in enumerate(zip(lanes, chunks)):
                if (t + i) % 4 != 1:
                    eng.push_audio(lane, x)
            eng.tick()
        logs.append(rec.packed)
        eng.close()
    assert len(logs[0]) == len(logs[1]) == 20
    for (w, wa), (g, ga) in zip(*logs):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
        np.testing.assert_array_equal(g[ga], w[wa])
    assert sum(int(p[:, -1].sum()) for p, _ in logs[1]) > 0


def test_build_engine_refuses_what_is_not_ported(bundle):
    # the beam is served (test_build_engine_beam_matches_jax below); several cards are served (tests/test_torch_multi_chip.py); asking for
    # more than are visible exits
    with pytest.raises(SystemExit):
        server.build_engine(_args(bundle, num_chips=max(2, torch.cuda.device_count() + 1),
                                  device="cuda"))
    # neither a bundle nor a checkpoint
    with pytest.raises(ValueError, match="--ckpt"):
        server.build_engine(_args(bundle, serving_bundle=None))


def test_build_engine_from_a_checkpoint_equals_the_bundle(bundle):
    """--ckpt with --mel_stats_path (the JAX server's route) builds the
    weights and the mel statistics that the bundle written from that
    checkpoint carries, and the tokenizer the config names."""
    from caiman_asr_tpu_torch.training.tree import tree_items

    from_bundle = server.build_engine(_args(bundle))
    from_ckpt = server.build_engine(_args(bundle, serving_bundle=None, ckpt=bundle["ckpt"],
                                          mel_stats_path=bundle["stats"]))
    a, b = (dict(tree_items(e.model.param_tree())) for e in (from_bundle, from_ckpt))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(from_bundle._mean, from_ckpt._mean)
    assert torch.equal(from_bundle._std, from_ckpt._std)
    assert [from_ckpt.tokenizer.id_to_piece(i) for i in range(N_PIECES - 1)] == [
        from_bundle.tokenizer.id_to_piece(i) for i in range(N_PIECES - 1)]


def _dispatch(srv, out):
    """A tick's responses into the server's per-connection queues, as its
    ticker does."""
    for lane, resp in out.items():
        q = srv.queues.get(lane)
        if q is not None:
            for r in resp if isinstance(resp, list) else [resp]:
                q.put_nowait(r)


async def _lockstep_ticks(srv, n_streams: int):
    """Tick only once every client's audio and EOS are in the engine, then
    until every stream has ended: each tick takes one chunk of every lane,
    so how tokens group into messages does not depend on scheduling."""
    eng = srv.engine
    while not (len(eng.streams) == n_streams
               and all(st.closed for st in eng.streams.values())):
        await asyncio.sleep(0.002)
    while eng.streams:
        _dispatch(srv, eng.tick())
        await asyncio.sleep(0)


def test_servers_send_the_same_frames(bundle):
    """Both servers, on localhost, send the same text frames one for one and
    refuse the same requests. The test drives the ticks in lockstep with
    the clients (no timed ticker while the streams run) and binds port 0."""
    websockets = pytest.importorskip("websockets")
    import websockets.asyncio.client
    import websockets.asyncio.server

    async def serve_and_stream(srv, audios):
        kw = dict(subprotocols=[server.SUBPROTOCOL])

        async def client(url, chunks):
            frames = []
            async with websockets.asyncio.client.connect(url, **kw) as ws:
                for x in chunks:
                    await ws.send(x.tobytes())
                await ws.send(b"")
                async for msg in ws:
                    frames.append(msg)
            return frames

        async def refused(url, *messages):
            async with websockets.asyncio.client.connect(url, **kw) as ws:
                for m in messages:
                    await ws.send(m)
                await asyncio.wait_for(ws.wait_closed(), 30)
                return ws.close_code

        async with websockets.asyncio.server.serve(srv.handle, "127.0.0.1", 0, **kw) as ws_srv:
            port = ws_srv.sockets[0].getsockname()[1]
            url = f"ws://127.0.0.1:{port}{PATH}"
            frames = await asyncio.wait_for(asyncio.gather(
                _lockstep_ticks(srv, len(audios)),
                *(client(url, a) for a in audios)), 60)
            # the refusals need no lockstep: a timed ticker frees the lanes
            ticker = asyncio.create_task(srv._ticker())
            odd = await refused(url, b"\x00\x00\x00")
            while srv.engine.streams:  # the refused stream's lane freed
                await asyncio.sleep(0.01)
            # every lane held by a silent client, one more is refused
            holders = [await websockets.asyncio.client.connect(url, **kw) for _ in range(4)]
            while len(srv.engine.streams) < 4:
                await asyncio.sleep(0.01)
            full = await refused(url)
            for ws in holders:
                await ws.close()
        ticker.cancel()  # after the server has drained its handlers
        return frames[1:], odd, full

    audios = [_chunks(10 + s, 8 + 3 * s) for s in range(3)]
    results = []
    for build, make in ((jax_server.build_engine, jax_server.ASRServer),
                        (server.build_engine, server.ASRServer)):
        eng = build(_args(bundle))
        results.append(asyncio.run(serve_and_stream(make(eng, tick_interval=0.005), audios)))
        eng.close()
    (want, want_odd, want_full), (got, got_odd, got_full) = results
    assert got == want
    assert sum(map(len, got)) > 0
    assert all(json.loads(m)["alternatives"] for frames in got for m in frames)
    assert got_odd == want_odd == 1003
    assert got_full == want_full == 1013


def _route(router, uid, out, got):
    for m in out.get(uid, []) if isinstance(out.get(uid), list) else (
            [out[uid]] if uid in out else []):
        got.append(m if isinstance(m, dict) else json.loads(m))


def test_state_reset_router_matches_jax(bundle):
    """Segments of 6 ticks with 2 of overlap, over both engines: the same
    responses, one EOS, every lane freed."""
    results = []
    for build, Router in ((jax_server.build_engine, JaxRouter),
                          (server.build_engine, StateResetRouter)):
        eng = build(_args(bundle, max_streams=4))
        router = Router(eng, segment_secs=6 * 0.06, overlap_secs=2 * 0.06)
        uids = [router.open_stream(), router.open_stream()]
        got = {uid: [] for uid in uids}
        for t, chunks in enumerate(zip(_chunks(20, 14), _chunks(21, 14))):
            for uid, x in zip(uids, chunks):
                router.push_audio(uid, x)
            out = router.tick()
            for uid in uids:
                _route(router, uid, out, got[uid])
        for uid in uids:
            router.close_stream(uid)
        for _ in range(6):
            out = router.tick()
            for uid in uids:
                _route(router, uid, out, got[uid])
        assert not router.streams and not eng.streams
        results.append(got)
        eng.close()
    assert results[1] == results[0]
    assert all(sum(1 for m in msgs if m.get("eos")) == 1 for msgs in results[1].values())
    assert sum(1 for msgs in results[1].values() for m in msgs if "alternatives" in m) > 0


def _beam_args(bundle, tmp_path, **kw):
    """--decoder beam with an ARPA over the bundle's pieces, a keyword list
    and the pruning thresholds (final emission 0.18 s: 3 ticks)."""
    pieces = ["▁" * (i % 2) + chr(97 + i) for i in range(N_PIECES - 1)]
    arpa = tmp_path / "lm.arpa"
    arpa.write_text("\n".join(["\\data\\", f"ngram 1={len(pieces) + 1}", "", "\\1-grams:",
                               "-2.0\t<unk>", *(f"-{0.4 + 0.1 * i:.2f}\t{p}"
                                                for i, p in enumerate(pieces)),
                               "", "\\end\\", ""]))
    kwp = tmp_path / "kw.json"
    kwp.write_text(json.dumps({"keywords": {"bc": 2.0}}))
    return _args(bundle, **{**dict(
        decoder="beam", beam_width=3, beam_prune_score_thresh=0.4, beam_prune_topk_thresh=1.5,
        beam_final_emission_thresh=0.18, ngram_path=str(arpa), ngram_scale_factor=0.5,
        keyword_boost_path=str(kwp)), **kw})


class BeamRecorder(Recorder):
    def beam_tick(self, packed, adv):
        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.beam_tick(packed, adv)


def _beam_packed(eng, ticks=12):
    rec = eng._native_ser = BeamRecorder(eng._native_ser)
    lanes = [eng.open_stream() for _ in range(2)]
    for chunks in zip(*(_chunks(30 + s, ticks) for s in range(2))):
        for lane, x in zip(lanes, chunks):
            eng.push_audio(lane, x)
        eng.tick()
    return rec.packed


def _assert_beam_packed_equal(engines):
    logs = [_beam_packed(e) for e in engines]
    for e in engines:
        e.close()
    assert len(logs[0]) == len(logs[1]) == 12
    for (w, wa), (g, ga) in zip(*logs):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(g[:, :-3], w[:, :-3])
        np.testing.assert_allclose(g[:, -3:].view(np.float32), w[:, -3:].view(np.float32),
                                   rtol=1e-5, atol=1e-5)


def test_build_engine_beam_matches_jax(bundle, tmp_path):
    """build_engine --decoder beam with an n-gram path, keywords and the
    thresholds: the fusion settings the JAX build takes, and the same packed
    beam outputs (integers exact, scores within 1e-5)."""
    args = _beam_args(bundle, tmp_path)
    engines = jax_server.build_engine(args), server.build_engine(args)
    beam = engines[1]._beam
    assert engines[1].decoder == "beam" and engines[1].beam_width == 3
    assert (beam.alpha, beam.score_thresh, beam.topk_thresh, beam.fe_limit) == (0.5, 0.4, 1.5, 3)
    assert beam._lm.tables is not None and beam._kw.tables is not None
    _assert_beam_packed_equal(engines)


def test_build_engine_beam_from_the_bundle_ngram_and_over_engines(bundle, tmp_path):
    """The n-gram and its scale from a bundle's ``ngram`` / ``ngram_scale``
    extras (the JAX build's packed outputs again); --num_chips 2 (two CPU
    engines) serves the beam, streams to EOS."""
    arpa = _beam_args(bundle, tmp_path).ngram_path
    with np.load(bundle["bundle"]) as z:
        arrays = {k: z[k] for k in z.files}
    arrays.update(ngram=np.frombuffer(open(arpa, "rb").read(), np.uint8),
                  ngram_scale=np.float32(0.25))
    path = tmp_path / "bundle_lm.npz"
    np.savez(path, **arrays)
    b2 = dict(bundle, bundle=str(path))
    args = _beam_args(b2, tmp_path, ngram_path=None, ngram_scale_factor=None)
    engines = jax_server.build_engine(args), server.build_engine(args)
    assert engines[1]._beam.alpha == 0.25 and engines[1]._beam._lm.tables is not None
    _assert_beam_packed_equal(engines)

    mc = server.build_engine(_beam_args(b2, tmp_path, num_chips=2, ngram_path=None))
    assert mc.n_chips == 2 and all(e.decoder == "beam" and e._beam.alpha == 0.5
                                   for e in mc.engines)
    lanes = [mc.open_stream() for _ in range(3)]
    for x in _chunks(40, 4):
        for lane in lanes:
            mc.push_audio(lane, x)
        mc.tick()
    for lane in lanes:
        mc.close_stream(lane)
    eos = set()
    while mc.streams:
        for lane, msgs in mc.tick().items():
            eos |= {lane for m in (msgs if isinstance(msgs, list) else [msgs])
                    if isinstance(m, dict) and m.get("eos")}
    mc.close()
    assert eos == set(lanes)
