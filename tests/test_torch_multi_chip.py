"""The port's MultiChipEngine against the JAX package's (mirrors
tests/serving/test_multi_chip.py).

The port runs two engines on the CPU (``["cpu", "cpu"]``), the JAX router
two engines on two of the conftest's eight CPU devices, both with the same
carried-over parameters, audio and lane events. In fp32 the global stream
ids must be equal, and so must every tick's responses (wire mode through
``WireTick.to_dict``; pipelined ticks per lane, in order). Each stream's
transcript must also equal that of one port ``StreamingEngine`` fed the same
audio. ``build_engine --num_chips 2 --device cpu`` against the JAX
``build_engine --num_chips 2`` on the same bundle.
"""

import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving_server import _args, bundle  # noqa: F401  (the bundle fixture)

from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.ops.logmel import LogMelConfig as JaxLogMelConfig
from caiman_asr_tpu.serving import server as jax_server
from caiman_asr_tpu.serving.engine import WireTick as JaxWireTick
from caiman_asr_tpu.serving.multi_chip import MultiChipEngine as JaxMultiChip
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
from caiman_asr_tpu_torch.serving import server
from caiman_asr_tpu_torch.serving.engine import StreamingEngine, WireTick
from caiman_asr_tpu_torch.serving.multi_chip import MultiChipEngine

N_CLASSES = 12
BLANK = N_CLASSES - 1
# the shape of tests/serving/test_multi_chip.py:32-43
CFG = dict(in_feats=240, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=16,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
PER_CHIP = 3
N_STREAMS = 5  # more than one engine holds: the router spreads them
N_TICKS = 12


class Tok:
    def detokenize(self, ids):
        return "".join(chr(97 + i) for i in ids)

    def id_to_piece(self, i):
        return chr(97 + i)


@functools.cache
def _models():
    jm = JaxRNNT(JaxConfig(**CFG), N_CLASSES)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    # blank raised so that lanes emit 0 to 4 symbols a tick
    params["joint_fc"]["b"] = params["joint_fc"]["b"] + 0.3 * (
        np.arange(N_CLASSES) == BLANK).astype(np.float32)
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG), N_CLASSES, device="cpu"), params)
    rng = np.random.default_rng(0)
    mel_stats = (rng.normal(size=80).astype(np.float32) * 0.1 - 8.0,
                 np.abs(rng.normal(size=80)).astype(np.float32) + 0.5)
    return jm, params, tm, mel_stats


def _audio(seed, n_ticks=N_TICKS):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=960 * n_ticks) * 3000 * np.exp(rng.normal())).clip(
        -32768, 32767).astype(np.int16)


def _normalise(out):
    if isinstance(out, (WireTick, JaxWireTick)):
        out = out.to_dict()
    return {g: (m if isinstance(m, list) else [m]) for g, m in out.items()}


def drive(eng):
    """N_STREAMS streams, one of them closed early and its id reused; every
    stream pushes a chunk a tick (one of them a block push). Returns the
    gids opened and every tick's responses."""
    audios = [_audio(100 + s) for s in range(N_STREAMS + 1)]
    gids = [eng.open_stream() for _ in range(N_STREAMS)]
    ticks = []
    for t in range(N_TICKS):
        if t == 5:
            eng.close_stream(gids[1])
        if t == 7:
            gids.append(eng.open_stream())
        live = [i for i, g in enumerate(gids) if g in eng.streams and not eng.streams[g].closed]
        rows = [i for i in live if i % 2 == 0]
        eng.push_audio_block(np.stack([audios[i][t * 960:(t + 1) * 960] for i in rows]),
                             [gids[i] for i in rows])
        for i in live:
            if i % 2:
                eng.push_audio(gids[i], audios[i][t * 960:(t + 1) * 960])
        ticks.append(_normalise(eng.tick()))
    for g in list(eng.streams):
        eng.close_stream(g)
    while eng.streams:
        ticks.append(_normalise(eng.tick()))
    eng.close()
    return gids, ticks


def _per_stream(ticks):
    out = {}
    for tick in ticks:
        for g, msgs in tick.items():
            out.setdefault(g, []).extend(msgs)
    return out


def _transcripts(ticks):
    """Each gid's transcripts, in order, split at its EOS markers."""
    out = {}
    for g, msgs in _per_stream(ticks).items():
        texts = out.setdefault(g, [[]])
        for m in msgs:
            m = json.loads(m) if isinstance(m, str) else m
            if m.get("eos"):
                texts.append([])
            elif m.get("alternatives"):
                texts[-1].append(m["alternatives"][0]["transcript"])
    return {g: ["".join(t) for t in texts[:-1]] for g, texts in out.items()}


@functools.cache
def _jax_run():
    jm, params, _, mel_stats = _models()
    return drive(JaxMultiChip(jm, params, BLANK, Tok(), devices=jax.devices()[:2],
                              max_streams_per_chip=PER_CHIP, mel_stats=mel_stats,
                              max_symbols_per_step=4, logmel=JaxLogMelConfig(dither=0.0),
                              dtype=jnp.float32))


def port_multi(**kw):
    _, _, tm, mel_stats = _models()
    return MultiChipEngine(tm, BLANK, Tok(), devices=["cpu", "cpu"],
                           max_streams_per_chip=PER_CHIP, mel_stats=mel_stats,
                           max_symbols_per_step=4, logmel=LogMelConfig(dither=0.0), **kw)


@pytest.mark.parametrize("mode", ["sync", "pipelined", "wire"])
def test_multi_chip_matches_jax(mode):
    """The JAX router runs synchronously (its pipelined mode on the CPU
    backend parted from its own synchronous mode, tests/test_torch_serving.py)."""
    want_gids, want = _jax_run()
    mc = port_multi(pipeline_depth=2 if mode == "pipelined" else 0,
                    wire_responses=mode == "wire")
    assert mc.B == 2 * PER_CHIP and mc.n_chips == 2
    gids, got = drive(mc)
    assert gids == want_gids
    assert {g // PER_CHIP for g in gids} == {0, 1}  # both engines serve
    if mode == "pipelined":
        assert _per_stream(got) == _per_stream(want)
    else:
        assert got == want
    texts = _transcripts(got)
    assert any(t for ts in texts.values() for t in ts)  # something was decoded


def test_multi_chip_matches_one_engine():
    """Each stream's transcript through the router equals one engine's for
    the same audio."""
    _, _, tm, mel_stats = _models()
    _, got = drive(port_multi())
    one = StreamingEngine(tm, BLANK, Tok(), mel_stats=mel_stats, max_streams=2 * PER_CHIP,
                          max_symbols_per_step=4, logmel=LogMelConfig(dither=0.0), device="cpu")
    audios = [_audio(100 + s) for s in range(N_STREAMS)]
    lanes = [one.open_stream() for _ in range(N_STREAMS)]
    ticks = []
    for t in range(N_TICKS):
        for i, lane in enumerate(lanes):
            if i != 1 or t < 5:
                one.push_audio(lane, audios[i][t * 960:(t + 1) * 960])
        if t == 4:
            one.close_stream(lanes[1])
        ticks.append(_normalise(one.tick()))
    for lane in lanes:
        one.close_stream(lane)
    while one.streams:
        ticks.append(_normalise(one.tick()))
    one.close()
    want = _transcripts(ticks)
    gids = _jax_run()[0]
    multi = _transcripts(got)
    for i in range(N_STREAMS):
        assert multi[gids[i]][0] == want[lanes[i]][0], i


def test_block_push_regroups_rows():
    """Row i of a block lands on gid i's lane on its own engine: buffered
    there, and the tick's output equals that of pushing each row alone."""
    outs = []
    for block_push in (True, False):
        mc = port_multi()
        gids = [mc.open_stream() for _ in range(4)]
        block = np.stack([_audio(7 + i, 1) for i in range(4)])
        if block_push:
            mc.push_audio_block(block, gids)
        else:
            for g, row in zip(gids, block):
                mc.push_audio(g, row)
        for g in gids:
            eng, lane = mc._split(g)
            assert eng._native_stg.buffered(lane) == 960
        outs.append(_normalise(mc.tick()))
        mc.close()
    assert sorted(gids) == [0, 1, 3, 4]  # least-loaded routing alternates
    assert outs[0] == outs[1]


def test_wire_ticks_carry_global_ids():
    mc = port_multi(wire_responses=True)
    gids = [mc.open_stream() for _ in range(4)]
    lanes_seen = set()
    for t in range(6):
        mc.push_audio_block(np.stack([_audio(20 + i, 6)[t * 960:(t + 1) * 960]
                                      for i in range(4)]), gids)
        out = mc.tick()
        assert isinstance(out, WireTick)
        for _, idx in out.segments:
            lanes_seen.update(int(x) for x in idx[:, 0])
    mc.close()
    assert lanes_seen and lanes_seen <= set(gids) and max(lanes_seen) >= PER_CHIP


def test_poll_globalises_finished_ticks():
    mc = port_multi(pipeline_depth=2)
    gids = [mc.open_stream() for _ in range(4)]
    got = {}
    for t in range(6):
        mc.push_audio_block(np.stack([_audio(30 + i, 6)[t * 960:(t + 1) * 960]
                                      for i in range(4)]), gids)
        for src in (mc.tick(), mc.poll()):
            for g, m in _normalise(src).items():
                got.setdefault(g, []).extend(m)
    mc.close()
    assert got and set(got) <= set(gids)


def test_captures_run_serially_before_the_first_tick(monkeypatch):
    """The router warms (on the card: captures) each engine on the calling
    thread, one after another, before any engine ticks."""
    calls = []
    real = StreamingEngine.warmup

    def warmup(self):
        calls.append(("warmup", threading.current_thread().name))
        real(self)

    real_tick = StreamingEngine.tick

    def tick(self):
        calls.append(("tick", None))
        return real_tick(self)

    monkeypatch.setattr(StreamingEngine, "warmup", warmup)
    monkeypatch.setattr(StreamingEngine, "tick", tick)
    mc = port_multi()
    mc.open_stream()
    mc.tick()
    mc.tick()
    mc.close()
    me = threading.current_thread().name
    assert calls[:2] == [("warmup", me), ("warmup", me)]
    assert [c[0] for c in calls[2:]] == ["tick"] * 4


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    _, _, tm, _ = _models()
    with pytest.raises(ValueError, match="at least one device"):
        MultiChipEngine(tm, BLANK, Tok())


def test_build_engine_num_chips_on_the_cpu(bundle):  # noqa: F811
    """``--num_chips 2 --device cpu``: two CPU engines behind the router,
    with the JAX ``build_engine --num_chips 2``'s responses."""
    results = []
    for build in (jax_server.build_engine, server.build_engine):
        eng = build(_args(bundle, num_chips=2, max_streams=2))
        assert eng.n_chips == 2 and eng.B == 4 and eng.per_chip == 2
        audios = [_audio(40 + s, 8) for s in range(3)]
        gids = [eng.open_stream() for _ in range(3)]
        ticks = []
        for t in range(8):
            for g, a in zip(gids, audios):
                eng.push_audio(g, a[t * 960:(t + 1) * 960])
            ticks.append(_normalise(eng.tick()))
        for g in gids:
            eng.close_stream(g)
        while eng.streams:
            ticks.append(_normalise(eng.tick()))
        eng.close()
        results.append((gids, ticks))
    assert results[0] == results[1]
    assert any(results[1][1])


def test_build_engine_num_chips_past_the_cards_exits(bundle):  # noqa: F811
    with pytest.raises(SystemExit, match="num_chips"):
        server.build_engine(_args(bundle, num_chips=max(2, torch.cuda.device_count() + 1),
                                  device="cuda"))


def test_the_router_keeps_the_servers_flood_guard():
    """The port's router gives the server ``hop_samples``, so the server's
    backpressure (``lane_frames * hop_samples``) stays on over several
    engines. The JAX router has none: its server's guard catches the
    AttributeError and turns off (ROADMAP.md Queue 3)."""
    jm, params, _, mel_stats = _models()
    mc = port_multi()
    gid = mc.open_stream()
    assert mc.hop_samples == 960 and mc.lane_frames(gid) == 0
    mc.close()
    jax_mc = JaxMultiChip(jm, params, BLANK, Tok(), devices=jax.devices()[:2],
                          max_streams_per_chip=PER_CHIP, mel_stats=mel_stats)
    assert not hasattr(jax_mc, "hop_samples")
    jax_mc.close()
