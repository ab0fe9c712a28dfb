"""WebSocket streaming ASR server over the port's ``StreamingEngine`` (the
port of ``caiman_asr_tpu/serving/server.py``, greedy and beam decoding).

The reference deployment's client contract
(docs/src/inference/websocket_api.md): path ``/asr/v0.1/stream``,
query-encoded ``content_type=audio/x-raw;format=S16LE;channels=1;rate=16000``,
binary frames of raw samples in, zero-length binary = EOS, JSON text frames
out (``{start, end, is_provisional, alternatives: [{transcript,
confidence}]}``), subprotocol ``stream.asr.api.myrtle.ai``.

All connections share ONE engine: a single ticker task advances the whole
lane batch every frame interval, so concurrency costs one device tick (one
CUDA graph replay) per 60 ms whatever the number of streams.

Run on the card (needs the ``websockets`` package, which ``serve()`` alone
imports):

    python -m caiman_asr_tpu_torch.serving.server --model_config CONFIG.yaml \
        --serving_bundle bundle.npz --port 8765

The model is built from the config's ``rnnt`` block with the bundle's
weights; the tokenizer from the bundle's ``sentencepiece`` bytes (or
``--tokenizer_model``). A training checkpoint serves in place of a bundle,
as in the JAX server: ``--ckpt best.npz --mel_stats_path stats.npz`` (its
EMA weights where it has them; the config's tokenizer). ``--num_chips N`` serves over the first N cards,
one engine each (``serving/multi_chip.py``). The beam, with n-gram fusion
and keyword boosting:

    python -m caiman_asr_tpu_torch.serving.server --model_config CONFIG.yaml \
        --serving_bundle bundle.npz --decoder beam --beam_width 4 \
        --ngram_path ngram.arpa --keyword_boost_path keywords.json

(``--ngram_path`` defaults to the bundle's ``ngram`` extra, its scale to
``--ngram_scale_factor``, else the bundle's ``ngram_scale``, else the
config's ``ngram.scale_factor``). Not ported: kenlm's binary n-gram
format.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import tempfile
import urllib.parse
from typing import Dict

import numpy as np

SUBPROTOCOL = "stream.asr.api.myrtle.ai"


class ASRServer:
    def __init__(self, engine, tick_interval: float = 0.02,
                 max_buffer_secs: float = 30.0):
        """max_buffer_secs: when a client has pushed more than this much
        audio beyond what the engine has consumed, the server stops
        reading its socket until the lane drains (TCP backpressure), so a
        flooding client costs bounded host RAM while legitimate
        faster-than-real-time file clients are merely flow-controlled,
        not disconnected."""
        self.engine = engine
        self.tick_interval = tick_interval
        self.max_buffer_secs = max_buffer_secs
        self.queues: Dict[int, asyncio.Queue] = {}
        self._ticker_task = None

    # ------------------------------------------------------------ lifecycle
    async def _ticker(self):
        import traceback

        from caiman_asr_tpu_torch.serving.engine import WireTick

        loop = asyncio.get_event_loop()

        def dispatch(out):
            if isinstance(out, WireTick):
                # wire mode: slice each lane's JSON payload straight
                # out of the C serializer's arena (no dict/str
                # materialisation on the tick path — the sender
                # decodes at write time, off the hot loop)
                for raw, idx in out.segments:
                    mv = memoryview(raw)
                    for lane, off, ln in idx.tolist():
                        q = self.queues.get(lane)
                        if q is not None:
                            q.put_nowait(bytes(mv[off:off + ln]))
                out = out.specials
            for lane, resp in out.items():
                q = self.queues.get(lane)
                if q is not None:
                    for r in resp if isinstance(resp, list) else [resp]:
                        q.put_nowait(r)

        poll = getattr(self.engine, "poll", None)
        while True:
            try:
                if self.engine.streams:
                    dispatch(await loop.run_in_executor(
                        None, self.engine.tick))
                    if poll is not None:
                        # under pipelining (pipeline_depth > 0) a tick's
                        # responses complete a fetch-time after dispatch;
                        # polling each wake ships them then, instead of
                        # holding them for the next full-chunk tick
                        # (cuts response latency by up to one chunk)
                        dispatch(await loop.run_in_executor(None, poll))
            except Exception:
                # A dead ticker would silently hang every stream: log & keep
                # ticking (the engine lock makes tick itself safe).
                traceback.print_exc()
            await asyncio.sleep(self.tick_interval)

    @staticmethod
    def validate_params(path: str) -> str | None:
        """Returns an error string, or None if the request is valid."""
        parsed = urllib.parse.urlparse(path)
        if not parsed.path.endswith("/stream"):
            return f"unknown path {parsed.path}"
        q = urllib.parse.parse_qs(parsed.query)
        ct = q.get("content_type", [""])[0]
        if not ct:
            return "missing content_type"
        parts = ct.split(";")
        if parts[0] != "audio/x-raw":
            return f"unsupported content type {parts[0]}"
        opts = dict(p.split("=", 1) for p in parts[1:] if "=" in p)
        if opts.get("format", "S16LE") != "S16LE":
            return "only S16LE supported"
        if opts.get("rate", "16000") != "16000":
            return "only rate=16000 supported"
        if opts.get("channels", "1") != "1":
            return "only channels=1 supported"
        return None

    # ------------------------------------------------------------- handler
    async def handle(self, websocket):
        path = websocket.request.path
        err = self.validate_params(path)
        if err is not None:
            await websocket.close(code=1008, reason=err)
            return
        lane = self.engine.open_stream()
        if lane is None:
            await websocket.close(code=1013, reason="server at capacity")
            return
        q: asyncio.Queue = asyncio.Queue()
        self.queues[lane] = q

        async def sender():
            while True:
                resp = await q.get()
                # native-serializer responses are pre-serialized JSON strings
                # (bytes in wire mode, decoded here so the client still sees
                # text frames); only the engine's own dict responses can
                # carry the eos flag
                if isinstance(resp, dict) and resp.get("eos"):
                    return
                if isinstance(resp, bytes):
                    resp = resp.decode("utf-8")
                elif not isinstance(resp, str):
                    resp = json.dumps(resp)
                await websocket.send(resp)

        send_task = asyncio.create_task(sender())
        pushed = 0

        def consumed_samples():
            # engine wrappers (state-reset router) may not track per-lane
            # frame counts; the flood guard degrades to off there
            try:
                return self.engine.lane_frames(lane) * self.engine.hop_samples
            except Exception:
                return None

        frame_base = consumed_samples() or 0
        max_ahead = int(self.max_buffer_secs * 16000)
        check_quantum = 16000  # amortize the engine-lock touch to ~1/s of audio
        next_check = check_quantum
        clean_eos = False
        try:
            async for message in websocket:
                if isinstance(message, str):
                    continue  # text frames ignored on input
                if len(message) == 0:
                    self.engine.close_stream(lane)
                    clean_eos = True
                    break
                if len(message) % 2:
                    # S16LE frames must be even-sized; a truncated final
                    # byte would otherwise kill the connection uncleanly
                    await websocket.close(code=1003, reason="odd-length frame")
                    break
                # wire format is pcm16 and the engine stages int16: pass the
                # bytes straight through (no per-message float conversion)
                arr = np.frombuffer(message, dtype="<i2")
                pushed += len(arr)
                self.engine.push_audio(lane, arr)
                if pushed >= next_check:
                    next_check = pushed + check_quantum
                    # backpressure: stop reading until the lane drains to
                    # within the buffer cap (flooding costs bounded RAM;
                    # fast file clients are flow-controlled, not dropped)
                    while True:
                        consumed = consumed_samples()
                        if consumed is None or (
                                pushed - (consumed - frame_base)) <= max_ahead:
                            break
                        await asyncio.sleep(self.tick_interval)
            else:
                self.engine.close_stream(lane)
                clean_eos = True
            if clean_eos:
                # drain the EOS flush; error paths skip straight to cleanup
                await send_task
        finally:
            send_task.cancel()
            self.queues.pop(lane, None)
            if lane in self.engine.streams:
                self.engine.close_stream(lane)
            await websocket.close()

    async def serve(self, host: str, port: int):
        import websockets.asyncio.server

        self._ticker_task = asyncio.create_task(self._ticker())
        async with websockets.asyncio.server.serve(
            self.handle, host, port, subprotocols=[SUBPROTOCOL], max_size=2**24
        ):
            await asyncio.Future()


def beam_options(args, cfg, tokenizer, n_classes: int, extras, frame_secs: float) -> dict:
    """The beam engine's keyword arguments from the CLI (as
    ``caiman_asr_tpu/serving/server.py:244-345``): the n-gram from
    ``--ngram_path`` or the bundle's ``ngram`` extra, compiled into device
    tables over the tokenizer's pieces (fusion off at a scale <= 0); the
    keyword list of ``--keyword_boost_path`` compiled likewise; the pruning
    thresholds (< 0 disables one; the final-emission one, in seconds, turned
    into ticks of ``frame_secs``)."""
    from caiman_asr_tpu_torch.data.tokenizer import piece_table
    from caiman_asr_tpu_torch.keywords.device_table import build_keyword_tables
    from caiman_asr_tpu_torch.keywords.process import load_keywords
    from caiman_asr_tpu_torch.lm.device_table import build_device_tables
    from caiman_asr_tpu_torch.lm.ngram import NGramLM

    blank = n_classes - 1
    pieces = piece_table(tokenizer, n_classes)
    ngram_path = getattr(args, "ngram_path", None)
    scale = getattr(args, "ngram_scale_factor", None)
    tables, alpha = None, 0.0
    tmp = None
    if ngram_path is None and "ngram" in extras:
        fd, tmp = tempfile.mkstemp(suffix=".arpa")
        with os.fdopen(fd, "wb") as fh:
            fh.write(np.asarray(extras["ngram"], np.uint8).tobytes())
        ngram_path = tmp
        if scale is None and "ngram_scale" in extras:
            scale = float(extras["ngram_scale"])
    try:
        if ngram_path:
            alpha = float(scale if scale is not None else cfg.ngram.scale_factor)
            if alpha > 0.0:
                tables = build_device_tables(NGramLM.load(ngram_path),
                                             pieces, skip_ids=[blank])
                print(f"n-gram fusion on: {tables.n_states} states, alpha={alpha}", flush=True)
    finally:
        if tmp is not None:
            os.unlink(tmp)
    kw_tables = None
    if getattr(args, "keyword_boost_path", None):
        kw_tables = build_keyword_tables(load_keywords(args.keyword_boost_path),
                                         pieces, skip_ids=[blank])
        print(f"keyword boosting on: {kw_tables.n_states} states", flush=True)

    def thresh(name):
        v = getattr(args, name, None)
        return None if v is None or v < 0 else v

    fe = float(getattr(args, "beam_final_emission_thresh", float("inf")))
    return dict(
        beam_width=getattr(args, "beam_width", 4),
        beam_score_thresh=thresh("beam_prune_score_thresh"),
        beam_topk_thresh=thresh("beam_prune_topk_thresh"),
        beam_final_emission_frames=max(1, round(fe / frame_secs)) if np.isfinite(fe) else None,
        ngram_lm=tables, ngram_alpha=alpha if tables is not None else 0.0, keywords=kw_tables)


def build_engine(args):
    """The engine the CLI asks for: the model from ``--model_config``
    with the weights of ``--serving_bundle`` or, with ``--ckpt``, of a
    training checkpoint (its EMA where it has one), loaded strictly; the
    tokenizer from ``--tokenizer_model``, else the bundle's SentencePiece
    bytes, else (``--ckpt``) the config's file; the mel statistics from
    ``--mel_stats_path`` (an ``.npz`` of melmeans, melvars), else the
    bundle's. Runs
    on ``--device`` (cuda unless "cpu" is asked for; no card raises). With
    ``--num_chips`` N > 1, a ``MultiChipEngine`` over the first N cards
    (``SystemExit`` when fewer are visible), or over N engines on the CPU
    with ``--device cpu``; ``--max_streams`` lanes each. ``--decoder
    beam`` adds what ``beam_options`` reads."""
    import torch

    from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
    from caiman_asr_tpu_torch.device import resolve_device
    from caiman_asr_tpu_torch.export.checkpointer import load_checkpoint
    from caiman_asr_tpu_torch.export.from_jax import load_jax_params
    from caiman_asr_tpu_torch.export.serving_bundle import bundle_mel_stats, load_serving_bundle
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine
    from caiman_asr_tpu_torch.serving.multi_chip import MultiChipEngine

    num_chips = getattr(args, "num_chips", 1) or 1
    device = getattr(args, "device", "cuda")
    if num_chips > 1 and torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if visible < num_chips:
            raise SystemExit(f"--num_chips {num_chips} but only {visible} cards visible")
    if not args.serving_bundle and not getattr(args, "ckpt", None):
        raise ValueError("pass --serving_bundle, or --ckpt with --mel_stats_path")
    device = resolve_device(device)
    cfg = load_config(args.model_config)
    extras = {}
    if args.serving_bundle:
        weights, extras, _ = load_serving_bundle(args.serving_bundle)
    else:
        loaded, ema, _, _ = load_checkpoint(args.ckpt)
        weights = {k: v for k, v in (ema if ema is not None else loaded).items()
                   if k not in ("simple_am", "simple_lm")}
    if args.tokenizer_model:
        tokenizer = Tokenizer([], args.tokenizer_model)
    elif "sentencepiece" in extras:
        tokenizer = Tokenizer([], np.asarray(extras["sentencepiece"], np.uint8).tobytes())
    elif not args.serving_bundle and cfg.tokenizer.sentpiece_model:
        tokenizer = Tokenizer([], cfg.tokenizer.sentpiece_model)
    else:
        raise ValueError("no sentencepiece model in the bundle or the config: pass "
                         "--tokenizer_model")
    model = load_jax_params(RNNT(cfg.rnnt, tokenizer.num_labels + 1, device="cpu"),
                            weights).to(device)
    if args.mel_stats_path:
        with np.load(args.mel_stats_path) as z:
            mel_stats = (np.asarray(z["melmeans"], np.float32),
                         np.sqrt(np.asarray(z["melvars"], np.float32)))
    else:
        mel_stats = bundle_mel_stats(extras)
    decoder = getattr(args, "decoder", "greedy")
    beam_kw = {}
    if decoder == "beam":
        # a tick: window stride x frame stacking x stack time (60 ms)
        frame_secs = (cfg.input_val.logmel.window_stride
                      * cfg.input_val.splicing.frame_stacking * cfg.rnnt.enc_stack_time_factor)
        beam_kw = beam_options(args, cfg, tokenizer, tokenizer.num_labels + 1, extras,
                               frame_secs)
    engine_kw = dict(
        mel_stats=mel_stats, decoder=decoder, **beam_kw,
        logmel=cfg.input_val.logmel,
        frame_stacking=cfg.input_val.splicing.frame_stacking,
        frame_subsampling=cfg.input_val.splicing.frame_subsampling,
        pipeline_depth=getattr(args, "pipeline_depth", 1),
        wire_responses=getattr(args, "wire_responses", False),
        dtype=torch.float32,
    )
    if num_chips > 1:
        devices = (["cpu"] * num_chips if device.type == "cpu"
                   else [f"cuda:{i}" for i in range(num_chips)])
        return MultiChipEngine(model, tokenizer.num_labels, tokenizer, devices=devices,
                               max_streams_per_chip=args.max_streams, **engine_kw)
    return StreamingEngine(model, tokenizer.num_labels, tokenizer,
                           max_streams=args.max_streams, device=device, **engine_kw)


def main(argv=None):
    p = argparse.ArgumentParser(description="streaming ASR WebSocket server (PyTorch/CUDA)")
    p.add_argument("--model_config", required=True)
    p.add_argument("--serving_bundle", default=None)
    p.add_argument("--ckpt", default=None,
                   help="a training checkpoint (its EMA weights where it has them) in place "
                        "of --serving_bundle; the mel statistics from --mel_stats_path")
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--mel_stats_path", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--max_streams", type=int, default=64, help="lane capacity per card")
    p.add_argument("--num_chips", type=int, default=1,
                   help="serve over the first N cards: one engine per card, lanes routed "
                        "to the least-loaded card (with --device cpu: N engines on the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (the cards) or cpu")
    p.add_argument("--decoder", default="greedy", choices=["greedy", "beam"])
    p.add_argument("--beam_width", type=int, default=4)
    p.add_argument("--beam_prune_score_thresh", type=float, default=0.4,
                   help="kill hypotheses whose normalised score trails the beam best by "
                        "more; <0 = off")
    p.add_argument("--beam_prune_topk_thresh", type=float, default=1.5,
                   help="mask expansion candidates more than this below the frame's best "
                        "acoustic log-prob; <0 = off")
    p.add_argument("--beam_final_emission_thresh", type=float, default=float("inf"),
                   help="seconds a final may lag before the beam prunes the blocking "
                        "divergence")
    p.add_argument("--ngram_path", default=None,
                   help="ARPA n-gram (or an npz from NGramLM.save_binary) for shallow "
                        "fusion in beam mode (default: the serving bundle's)")
    p.add_argument("--ngram_scale_factor", type=float, default=None)
    p.add_argument("--keyword_boost_path", default=None,
                   help="keyword JSON for boosting in beam mode")
    p.add_argument("--pipeline_depth", type=int, default=1,
                   help="in-flight ticks before host consumption; each unit hides one "
                        "tick of device->host latency and adds one chunk (60 ms) of "
                        "response latency")
    p.add_argument("--sr_segment", type=float, default=0.0,
                   help="serving state resets: refresh model state every N seconds per "
                        "stream via shadow-lane handover (0 = off)")
    p.add_argument("--sr_overlap", type=float, default=3.0,
                   help="warmup context seconds for each state reset")
    p.add_argument("--wire_responses", action="store_true",
                   help="keep native-serializer responses as one JSON bytes arena per "
                        "tick instead of per-lane Python strings")
    p.add_argument("--max_buffer_secs", type=float, default=30.0,
                   help="stop reading a client's socket (TCP backpressure) while it is "
                        "more than this many seconds of audio ahead of the engine")
    args = p.parse_args(argv)
    engine = build_engine(args)
    engine.warmup()
    devices = getattr(engine, "devices", None) or [engine.device]
    where = f"{engine.B} lanes on {', '.join(map(str, devices))}"
    if args.sr_segment > 0:
        from caiman_asr_tpu_torch.serving.state_resets import StateResetRouter

        engine = StateResetRouter(engine, segment_secs=args.sr_segment,
                                  overlap_secs=args.sr_overlap)
    server = ASRServer(engine, max_buffer_secs=args.max_buffer_secs)
    print(f"serving on ws://{args.host}:{args.port}/asr/v0.1/stream ({where})", flush=True)
    asyncio.run(server.serve(args.host, args.port))


if __name__ == "__main__":
    main()
