"""Streaming cells: the port's ``StreamingEngine`` driven as its server's
ticker drives it - ``push_audio_block``, ``tick()``, then ``poll()`` - with
no sockets: every lane a long-lived stream that pushes one 60 ms int16
chunk a tick, greedy decoding with up to ``max_symbols`` tokens a frame,
wire-mode responses over an 8,704-piece table (``tokenizer.py``).

Traffic: ``paced`` offers each tick on the 60 ms grid (open loop: a late
engine finds the next chunk already due); ``closed`` offers the next tick
as soon as the last returns. Each tick's chunks come from a pool of
synthetic speech-like audio made on the device from the seed: lane b's
chunk at tick t is row (t B + b) of the pool, so a tick's block is one or
two slices of it.

A chunk is answered at the ``tick()`` or ``poll()`` return that hands out
its tick's responses (a lane that emits nothing gets no message: its answer
is that blank). Its latency runs from its due time, its grid slot in the
open loop; chunks still unanswered when the window closes are waited for,
up to a minute, and their latency counts the wait.

``correct``: after the window the engine is freed, and the reference
(``reference/greedy.py``) walks a sample of the lanes, drawn from the seed,
from their first chunk: at each served decision the widest gap by which
the served token's logit lies below the reference's best."""

from __future__ import annotations

import gc
import json
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import common
from benchmark.cell import Cell, Record, now
from benchmark.reference import frontend
from benchmark.reference.greedy import decision_gaps
from benchmark.reference.precision import PRECISIONS, fp32_exact
from benchmark.reference.weights import make_weights
from benchmark.tokenizer import bench_tokenizer

CHUNK = 960
CHUNK_S = 0.060
DRAIN_S = 60.0


class Traffic:
    """The general generator of streaming traffic: a pool of ``pool_chunks``
    60 ms chunks on the host, cut from synthetic recordings."""

    def __init__(self, t: dict, lanes: int, seed: int, device):
        self.B = lanes
        n = t["pool_chunks"]
        per = t["recording_chunks"]
        gen = torch.Generator(device=device).manual_seed(common.derive_seed(seed, "audio"))
        rec = common.synthetic_recordings(-(-n // per), per * CHUNK_S, gen, device)
        self.pool = common.to_int16_grid(rec).reshape(-1, CHUNK)[:n].cpu().numpy()
        self.N = n
        if lanes > n:
            raise ValueError(f"{lanes} lanes need a pool of at least as many chunks, not {n}")

    def block(self, tick: int):
        """[(rows, lanes or None)]: tick's chunks, one or two pool slices."""
        s = (tick * self.B) % self.N
        if s + self.B <= self.N:
            return [(self.pool[s:s + self.B], None)]
        k = self.N - s
        return [(self.pool[s:], np.arange(k)), (self.pool[:self.B - k], np.arange(k, self.B))]

    def lane_audio(self, lane: int, ticks: int) -> np.ndarray:
        rows = (np.arange(ticks) * self.B + lane) % self.N
        return self.pool[rows].reshape(-1)


def mel_stats(traffic: Traffic, device, n: int = 2048):
    """Dataset statistics of the log-mels over ``n`` pool chunks as four
    streams (the reference front end)."""
    x = torch.from_numpy(traffic.pool[:n].astype(np.float32) / 32768.0).to(device)
    x = x.reshape(4, -1)
    mel, fl = frontend.log_mel(x, torch.full((4,), x.shape[1], device=device))
    vals = mel.transpose(1, 2).reshape(-1, mel.shape[1])
    return vals.mean(0), vals.std(0)


class Served:
    """Each sampled lane's served tokens by frame, read off the wire."""

    def __init__(self, lanes, B: int, tok):
        self.lanes = list(lanes)
        self.pick = np.zeros(B, bool)
        self.pick[self.lanes] = True
        self.tok = tok
        self.frames: Dict[int, Dict[int, List[int]]] = {lane: {} for lane in self.lanes}
        self.tokens = 0

    def take(self, out) -> None:
        """A WireTick's responses: count the tokens, keep the sampled lanes'."""
        for raw, idx in out.segments:
            self.tokens += raw.count(b"'")
            for lane, off, ln in idx[self.pick[idx[:, 0]]].tolist():
                msg = json.loads(raw[off:off + ln])
                frame = int(round(msg["start"] / CHUNK_S))
                self.frames[lane][frame] = self.tok.split(msg["alternatives"][0]["transcript"])

    def by_frame(self, lane: int, n: int) -> List[List[int]]:
        return [self.frames[lane].get(t, []) for t in range(n)]


def _engine(cell: Cell, weights, mean, std, lanes: int, dev):
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine

    cfg = cell.config
    rnnt = {k: v for k, v in cfg["rnnt"].items() if k in RNNTModelConfig.__dataclass_fields__}
    model = RNNT(RNNTModelConfig(**rnnt), cfg["n_classes"], device=dev)
    model.load_state_dict(weights, strict=True)
    s = cfg["serving"]
    tok = bench_tokenizer(cfg["n_classes"])
    eng = StreamingEngine(model, cfg["n_classes"] - 1, tok,
                          mel_stats=(mean.cpu().numpy(), std.cpu().numpy()), max_streams=lanes,
                          max_symbols_per_step=s["max_symbols_per_step"], dtype=torch.bfloat16,
                          pipeline_depth=s["pipeline_depth"], wire_responses=True, device=dev)
    return model, eng, tok


def run(cell: Cell) -> Record:
    if cell.control not in ("", "fp8"):
        raise ValueError(f"--control {cell.control}: a streaming cell's control is fp8")
    fp32_exact()
    dev = torch.device(cell.device)
    cfg, t, rec = cell.config, cell.traffic, Record()
    rnnt, K = cfg["rnnt"], cfg["n_classes"]
    B = cell.lanes or t["lanes"]
    traffic = Traffic(t, B, cell.seed, dev)
    weights = make_weights(rnnt, K, common.derive_seed(cell.seed, "weights"), dev)
    mean, std = mel_stats(traffic, dev)
    s = cfg["serving"]
    model, eng, tok = _engine(cell, weights, mean, std, B, dev)
    rng = np.random.default_rng(common.derive_seed(cell.seed, "sample"))
    served = Served(rng.choice(B, size=min(cell.limits["check_lanes"], B), replace=False), B, tok)
    due: Dict[int, float] = {}        # tick number -> due time
    latency: Dict[int, float] = {}    # tick number -> its answer's latency
    late: List[float] = []
    ticks, answered = [0], [0]   # ticks offered, ticks answered (numbered from 1)

    def handle(out, when: float) -> None:
        served.take(out)
        for k in range(answered[0] + 1, eng.ticks_consumed + 1):
            latency[k] = when - due[k]
        answered[0] = eng.ticks_consumed

    def offer(due_at: float) -> None:
        for rows, lanes in traffic.block(ticks[0]):
            eng.push_audio_block(rows, lanes)
        ticks[0] += 1
        due[ticks[0]] = due_at
        out = eng.tick()
        back = now()
        late.append(back - due_at)
        handle(out, back)
        handle(eng.poll(), now())

    def paced(t0: float, end: float) -> None:
        """The server's ticker: it wakes every ``tick_interval``, ticks and
        polls; the clients' chunks arrive on the 60 ms grid from t0, and the
        last is due before ``end``."""
        every = s["tick_interval"]
        per = int(round(CHUNK_S / every))
        k = 0
        while True:
            wake = t0 + k * every
            if k % per == 0 and wake >= end:
                return
            time.sleep(max(0.0, wake - now()))
            if k % per == 0:
                offer(wake)
            else:
                handle(eng.tick(), now())
                handle(eng.poll(), now())
            k += 1

    def drain(limit_s: float) -> None:
        end = now() + limit_s
        while eng.ticks_consumed < ticks[0] and now() < end:
            time.sleep(0.001)
            handle(eng.poll(), now())

    try:
        for _ in range(B):
            eng.open_stream()
        eng.warmup()
        for _ in range(t["warm_ticks"]):
            offer(now())
        drain(DRAIN_S)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        late.clear()
        first, tokens0 = ticks[0] + 1, served.tokens

        rec.setup_s = now() - cell.t_start
        t0 = now()
        if t["loop"] == "paced":
            paced(t0, t0 + cell.seconds)
        else:
            while now() - t0 < cell.seconds:
                offer(now())
        rec.window_s = now() - t0
        last = ticks[0]
        answered_in_window = eng.ticks_consumed - (first - 1)
        tokens_in_window = served.tokens - tokens0
        drain(DRAIN_S)
        window_ticks = range(first, last + 1)
        rec.attempted = B * len(window_ticks)
        rec.failed = B * sum(1 for k in window_ticks if k not in latency)
        rec.values["chunk_latency_s"] = [latency.get(k, float("inf")) for k in window_ticks]
        rec.values["lateness_s"] = list(late)
        rec.values["lanes"] = B
        rec.values["answered_audio_s"] = answered_in_window * B * CHUNK_S
        rec.values["ticks"] = len(window_ticks)
        rec.values["emitted_tokens"] = tokens_in_window
        rec.values["tokens_per_frame"] = tokens_in_window / max(1, answered_in_window * B)
        lat = rec.values["chunk_latency_s"]
        half = len(lat) // 2
        rec.values["p95_ms_halves"] = [1e3 * common.quantile(lat[:half], 0.95),
                                       1e3 * common.quantile(lat[half:], 0.95)]
        rec.values["lateness_p99_ms"] = 1e3 * common.quantile(late, 0.99)
        rec.values["tick_flops"] = tick_flops(rnnt, K)
        if dev.type == "cuda":
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

        if cell.trace:
            n_tr = t["traced_ticks"]
            tokens0 = served.tokens

            def traced():
                if t["loop"] == "paced":
                    t1 = now()
                    paced(t1, t1 + (n_tr - 0.5) * CHUNK_S)
                else:
                    for _ in range(n_tr):
                        offer(now())
                drain(DRAIN_S)

            rec.trace = common.traced(traced)
            rec.values["traced_ticks"] = 2 * n_tr
            rec.values["traced_tokens"] = served.tokens - tokens0
            k1 = common.k1_times(B, rnnt["enc_n_hid"])
            layers = ((2, rnnt["enc_pre_rnn_layers"]), (1, rnnt["enc_post_rnn_layers"]))
            rec.values["k1"] = {"ms": sum(n * k1[T] for T, n in layers), "bound_ms": sum(
                n * common.recurrence_bound_ms(T, "bfloat16", B, rnnt["enc_n_hid"])[0]
                for T, n in layers)}
    finally:
        eng.close()
    n_frames = ticks[0]
    del eng, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = now()
    lanes = served.lanes
    audio = torch.from_numpy(np.stack([traffic.lane_audio(lane, n_frames) for lane in lanes]
                                      ).astype(np.float32) / 32768.0).to(dev)
    lens = torch.full((len(lanes),), audio.shape[1], device=dev)
    sides = ["fp32"] + (["fp8"] if cell.control == "fp8" else [])
    feats = [frontend.stream_features(audio, lens, mean, std, PRECISIONS[p])[0] for p in sides]
    gaps = decision_gaps(weights, rnnt, K - 1, feats, [served.by_frame(lane, n_frames)
                                                       for lane in lanes],
                         s["max_symbols_per_step"],
                         PRECISIONS["fp8"] if cell.control == "fp8" else None)
    rec.values["check_s"] = now() - t_check
    rec.values["decisions_checked"] = gaps["decisions"]
    rec.values["tokens_checked"] = sum(len(x) for lane in lanes
                                       for x in served.frames[lane].values())
    if cell.control == "fp8":
        rec.check("token_gap", gaps["worst_gap_control"], cell.limits["token_gap"])
        rec.values["program_gap"] = gaps["worst_gap"]
    else:
        rec.check("token_gap", gaps["worst_gap"], cell.limits["token_gap"])
    return rec


def tick_flops(rnnt: dict, K: int) -> dict:
    """A lane's products a tick (log-mel DFT and filterbank, the encoder at
    two pre-stack frames and one post-stack frame, the projection), a joint
    row's and a predictor step's."""
    H, Hp, Hj = rnnt["enc_n_hid"], rnnt["pred_n_hid"], rnnt["joint_n_hid"]
    lane = 2.0 * 6 * 400 * 514 + 2.0 * 6 * 257 * 80
    lane += sum(common.lstm_flops(2, rnnt["in_feats"] if i == 0 else H, H)
                for i in range(rnnt["enc_pre_rnn_layers"]))
    lane += sum(common.lstm_flops(1, rnnt["enc_stack_time_factor"] * H if i == 0 else H, H)
                for i in range(rnnt["enc_post_rnn_layers"]))
    lane += 2.0 * H * Hj
    pred = sum(common.lstm_flops(1, Hp, Hp) for _ in range(rnnt["pred_rnn_layers"]))
    return {"lane": lane, "joint_row": 2.0 * Hj * K, "pred_step": pred + 2.0 * Hp * Hj}
