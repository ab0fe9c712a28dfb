"""Concurrent real-time streams on one card: base-85M, greedy, bf16 (the
port's counterpart of the JAX package's ``bench.py``).

Every tier starts from raw 60 ms int16 chunks and goes through the port's
``StreamingEngine`` as a server drives it: per-lane audio push and native
staging, the pipelined upload (real PCIe: pinned slots, the uploader's own
stream), the tick as one CUDA graph (featurizer, encoder with K1, greedy
step with ``max_symbols_per_step=4``), the pipelined copy back, and
wire-mode JSON for every lane every tick over a synthetic 8,704-piece
vocabulary (so each response pays real detokenisation and serialisation).

Tiers, per rung of the ladder of batch sizes B (largest first):

- back-to-back: the mean tick wall over 110 unpaced ticks must be at most
  60 ms (the classic sustainability bound);
- paced CL99: ticks fired on the 60 ms grid; p99 over 320 ticks of
  (``tick()`` return - its grid slot) must be at most 60 ms (``bench.py``'s
  tier). With 8 ticks in flight a ``tick()`` call dispatches its chunk and
  hands out the responses of earlier ticks that have finished, so this
  bounds how far the host falls behind the grid, not when a chunk's
  responses ship. The tier also reports each chunk's response latency:
  from its grid slot (the chunk pushed) to the ``tick()`` return that hands
  out its responses, with no ``poll()`` between ticks (p99 and max over the
  chunks answered inside the window). The headline: the largest B that
  passes CL99 (the ladder stops there);
- compute path (B = 16,384, 8,192, 4,096, 1,024): ms per graph replay,
  chained on the device (CUDA events over 20 replays), the device-side
  ceiling; and K1 alone at those batches, T=2 and T=1, ms a call and
  launches a call;
- profile (B = 8,192): ``torch.profiler`` over 20 engine ticks, the
  device's busy share of a tick and its largest kernels, and over the
  tick run eagerly, device time by the operator that launched it.

``--decoder beam`` runs the same tiers over the beam engine (width
``--beam_width``, ``--beam_win`` token slots a hypothesis to the host a
tick, ``--score_thresh`` / ``--topk_thresh`` / ``--fe_frames`` as
``scripts/bench_beam_serving.py`` takes them, off unless given), without the
profile:

    python -m caiman_asr_tpu_torch.bench_serving --decoder beam --ladder 4096 2048 1024

Weights are random, drawn from ``--seed``. Run on the card:

    python -m caiman_asr_tpu_torch.bench_serving [--ladder 16384 8192 4096]

It prints one JSON line, ``{"metric": "streaming_rts_base85m_greedy",
"value", "unit", "vs_baseline", "device", "rungs", "compute", "k1",
"profile"}``; ``value`` is the largest B that passed CL99 (else the largest that
passed the mean tier, else the best sustained streams, B x 60 ms / mean
tick). Without a
card it raises unless ``--device cpu`` is given (a rehearsal at the sizes
it is given; its times are the CPU's, never the card's).
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Optional

import numpy as np
import torch

CHUNK_SECONDS = 0.060
# the reference's FPGA figure for base-85M greedy (docs/src/performance.md:23)
BASELINE_RTS = 2000.0
LADDER = (16384, 14336, 12288, 8192, 4096)
TICKS, PACED_TICKS = 110, 320        # bench.py's windows
COMPUTE_B = (16384, 8192, 4096, 1024)
PROFILE_B = 8192
# base-85M (`__graft_entry__.py:14-27`); the classes are 8,703 pieces + blank
BASE_85M = dict(in_feats=240, enc_n_hid=1024, enc_pre_rnn_layers=2, enc_post_rnn_layers=6,
                enc_stack_time_factor=2, pred_n_hid=512, pred_rnn_layers=2, joint_n_hid=768)
N_CLASSES = 8704
MAX_SYMBOLS = 4


class PieceTokenizer:
    """A piece table behind ``id_to_piece``, all the engine's responses read."""

    def __init__(self, pieces):
        self._pieces = pieces

    def id_to_piece(self, i):
        return self._pieces[i]


def bench_tokenizer(n_classes: int = N_CLASSES) -> PieceTokenizer:
    """A deterministic SentencePiece-like vocabulary (``bench.py:216-240``):
    ~55% word-initial (▁) pieces, syllable-shaped, ~4.5 characters, the
    shape of the reference's 8,703-piece LibriSpeech vocabulary; the blank
    (last) has no text."""
    rng = np.random.default_rng(8703)
    vowels, cons = "aeiou", "bcdfghjklmnprstvwz"
    pieces, seen = [], set()
    while len(pieces) < n_classes - 1:
        w = "".join(cons[int(rng.integers(len(cons)))] + vowels[int(rng.integers(len(vowels)))]
                    for _ in range(int(rng.integers(1, 4))))
        if rng.random() < 0.3:
            w += cons[int(rng.integers(len(cons)))]
        if rng.random() < 0.55:
            w = "▁" + w
        if w in seen:
            continue
        seen.add(w)
        pieces.append(w)
    pieces.append("")
    return PieceTokenizer(pieces)


def build_model(device="cuda", seed: int = 0, config: Optional[dict] = None,
                n_classes: int = N_CLASSES):
    """base-85M (or ``config``) with weights drawn from ``seed``."""
    from caiman_asr_tpu_torch.device import resolve_device
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT

    dev = resolve_device(device)
    model = RNNT(RNNTModelConfig(**(config or BASE_85M)), n_classes, device=dev)
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))


def build_engine(model, batch_size: int, *, pipeline_depth: int = 8, tokenizer=None,
                 wire: bool = True, dtype=torch.bfloat16, cuda_graph: bool = True,
                 engine_kw: Optional[dict] = None):
    """``engine_kw``: more of ``StreamingEngine``'s options (the beam's, as
    ``beam_options`` gives them)."""
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine

    return StreamingEngine(
        model, model.n_classes - 1, tokenizer, max_streams=batch_size,
        max_symbols_per_step=MAX_SYMBOLS, dtype=dtype, pipeline_depth=pipeline_depth,
        wire_responses=wire, device=next(model.parameters()).device, cuda_graph=cuda_graph,
        **(engine_kw or {}))


def beam_options(width: int = 4, win: int = 64, score_thresh: Optional[float] = None,
                 topk_thresh: Optional[float] = None, fe_frames: Optional[int] = None) -> dict:
    """The beam engine's options (``scripts/bench_beam_serving.py``'s knobs:
    the window a hypothesis ships a tick, the pruning thresholds, the
    final-emission budget in ticks; None disables each)."""
    return dict(decoder="beam", beam_width=width, beam_win=win, beam_score_thresh=score_thresh,
                beam_topk_thresh=topk_thresh, beam_final_emission_frames=fe_frames)


def _p99(xs) -> float:
    xs = sorted(xs)
    return xs[min(int(np.ceil(0.99 * len(xs))) - 1, len(xs) - 1)]


def measure_engine(model, batch_size: int, paced: bool = False, tokenizer=None,
                   engine_kw: Optional[dict] = None) -> dict:
    """The whole ``tick()`` loop over ``batch_size`` open lanes: each tick
    pushes one 60 ms int16 block for every lane and drains the responses.
    Unpaced: TICKS back-to-back ticks, the mean and p99 wall (ms). Paced:
    PACED_TICKS ticks on the 60 ms grid, p99 and max of (``tick()`` return -
    grid slot), and of each chunk's response latency (the ``tick()`` return
    that hands out its tick's responses - its grid slot) (ms)."""
    eng = build_engine(model, batch_size, tokenizer=tokenizer or bench_tokenizer(),
                       engine_kw=engine_kw)
    try:
        for _ in range(batch_size):
            eng.open_stream()
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        block = (rng.standard_normal((batch_size, eng.hop_samples)) * 0.05 * 32768
                 ).astype(np.int16)

        def one_tick():
            eng.push_audio_block(block)
            return eng.tick()

        for _ in range(5):
            one_tick()
        out = {"b": batch_size, "warmup_s": warm_s}
        if paced:
            late, resp, slots = [], [], {}
            answered = eng.ticks_consumed
            grid0 = time.perf_counter() + CHUNK_SECONDS
            for i in range(PACED_TICKS):
                slot = grid0 + i * CHUNK_SECONDS
                now = time.perf_counter()
                if now < slot:
                    time.sleep(slot - now)
                one_tick()
                now = time.perf_counter()
                late.append(max(0.0, now - slot))
                # ticks are numbered as dispatched and answered in that order
                slots[eng._tick_count] = slot
                for k in range(answered + 1, eng.ticks_consumed + 1):
                    if k in slots:
                        resp.append(now - slots[k])
                answered = eng.ticks_consumed
            out.update(cl99_p99_ms=1e3 * _p99(late), cl99_max_ms=1e3 * max(late),
                       paced_ticks=PACED_TICKS, response_p99_ms=1e3 * _p99(resp),
                       response_max_ms=1e3 * max(resp), responses=len(resp))
        else:
            times = []
            for _ in range(TICKS):
                t0 = time.perf_counter()
                one_tick()
                times.append(time.perf_counter() - t0)
            out.update(mean_ms=1e3 * sum(times) / len(times), p99_ms=1e3 * _p99(times),
                       ticks=TICKS)
        return out
    finally:
        eng.close()


def compute_ms(model, batch_size: int, reps: int = 20, dtype=torch.bfloat16,
               engine_kw: Optional[dict] = None) -> dict:
    """The tick alone, every lane advancing: ms per CUDA graph replay,
    ``reps`` replays chained on the engine's stream between two events (on
    the CPU, ms per eager tick). Also the K1 launches a tick."""
    eng = build_engine(model, batch_size, pipeline_depth=0, wire=False, dtype=dtype,
                       engine_kw=engine_kw)
    try:
        eng.warmup()
        rng = np.random.default_rng(0)
        eng._in_samples.copy_(torch.from_numpy(
            (rng.standard_normal((batch_size, eng.hop_samples)) * 0.05 * 32768
             ).astype(np.int16)))
        eng._in_meta[:batch_size] = 1
        if eng._graph is None:
            t0 = time.perf_counter()
            for _ in range(reps):
                eng._step()
            ms = 1e3 * (time.perf_counter() - t0) / reps
        else:
            eng._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(eng._stream):
                eng._graph.replay()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(reps):
                    eng._graph.replay()
                end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / reps
        return {"b": batch_size, "ms_per_tick": ms, "k1_launches_per_tick":
                eng.k1_launches_per_tick}
    finally:
        eng.close()


def k1_times(batches, H: int = 1024, dtype=torch.bfloat16, reps: int = 20) -> list:
    """K1 alone at the tick's shapes, T=2 (the pre-stack layers) and T=1
    (the post-stack ones), on random inputs: ms a call (CUDA events over
    ``reps`` calls) and the launches a call (its batch slices)."""
    from caiman_asr_tpu_torch.ops import lstm_kernel

    out = []
    g = torch.Generator(device="cuda").manual_seed(0)
    w_hh = ((torch.rand((4 * H, H), generator=g, device="cuda") * 2 - 1) / H ** 0.5).to(dtype)
    for B in batches:
        h0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)
        for T in (2, 1):
            gx = (torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5).to(dtype)
            n0 = lstm_kernel.lstm_recurrence.launches
            lstm_kernel.lstm_recurrence(gx, w_hh, h0, h0)
            launches = lstm_kernel.lstm_recurrence.launches - n0
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                lstm_kernel.lstm_recurrence(gx, w_hh, h0, h0)
            end.record()
            end.synchronize()
            out.append({"T": T, "b": B, "dtype": str(dtype).removeprefix("torch."),
                        "ms": start.elapsed_time(end) / reps, "launches": launches})
    return out


def busy_share(model, batch_size: int, ticks: int = 20) -> dict:
    """``torch.profiler`` over ``ticks`` engine ticks at ``batch_size``
    (pipelined, wire mode), the pipeline drained before and after: the
    device's busy time (the union of its kernels' and copies' spans on every
    stream) over the window's wall, the device time summed, and the largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    eng = build_engine(model, batch_size, tokenizer=bench_tokenizer())
    try:
        for _ in range(batch_size):
            eng.open_stream()
        eng.warmup()
        block = (np.random.default_rng(0).standard_normal((batch_size, eng.hop_samples))
                 * 0.05 * 32768).astype(np.int16)
        def drain():  # every queued tick dispatched and finished on the device
            eng._upq.join()
            torch.cuda.synchronize()

        for _ in range(5):
            eng.push_audio_block(block)
            eng.tick()
        drain()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.push_audio_block(block)
                eng.tick()
            drain()
            wall = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        # the device is busy where any kernel or copy runs, on any stream
        spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == cuda)
        busy_ns, end = 0, 0
        for a, b in spans:
            busy_ns += max(0, b - max(a, end))
            end = max(end, b)
        events = [e for e in prof.key_averages() if e.device_type == cuda]
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
        return {"b": batch_size, "ticks": ticks, "wall_ms_per_tick": 1e3 * wall / ticks,
                "device_busy_ms_per_tick": busy_ns / 1e6 / ticks,
                "busy_share": busy_ns / 1e9 / wall,
                "device_ms_per_tick_summed": sum(e.self_device_time_total for e in events)
                / 1e3 / ticks,
                "top": {e.key[:60]: e.self_device_time_total / 1e3 / ticks for e in top}}
    finally:
        eng.close()


def eager_ops(model, batch_size: int, ticks: int = 5, engine_kw: Optional[dict] = None) -> dict:
    """The tick run eagerly (``cuda_graph=False``) under ``torch.profiler``,
    every lane advancing: device ms a tick by the PyTorch operator that
    launched it (a graph replay hides which operator launched a kernel)."""
    from torch.profiler import ProfilerActivity, profile

    eng = build_engine(model, batch_size, pipeline_depth=0, wire=False, cuda_graph=False,
                       engine_kw=engine_kw)
    try:
        eng.warmup()
        eng._in_meta[:batch_size] = 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(eng._stream):
                for _ in range(ticks):
                    eng._step()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
        return {"b": batch_size, "device_ms_per_tick": sum(
                    e.self_device_time_total for e in ops) / 1e3 / ticks,
                "ops_ms_per_tick": {e.key: e.self_device_time_total / 1e3 / ticks
                                    for e in top}}
    finally:
        eng.close()


def run_ladder(model, ladder, log=print, engine_kw: Optional[dict] = None) -> dict:
    """Largest B first: the back-to-back tier, then, where its mean holds
    60 ms, the paced tier; stops at the first B that passes the paced tier."""
    tok = bench_tokenizer(model.n_classes)
    rungs = []
    for B in ladder:
        gc.collect()  # the last rung's engine, its graph and its pool
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        try:
            rung = measure_engine(model, B, tokenizer=tok, engine_kw=engine_kw)
        except torch.cuda.OutOfMemoryError as e:
            rungs.append({"b": B, "error": f"out of memory: {e}"[:200]})
            log(f"  B={B}: out of device memory")
            continue
        if rung["mean_ms"] <= 1e3 * CHUNK_SECONDS:
            rung.update({k: v for k, v in measure_engine(model, B, paced=True, tokenizer=tok,
                                                         engine_kw=engine_kw).items()
                         if k.startswith(("cl99", "paced", "response"))})
        rungs.append(rung)
        log(f"  rung {json.dumps(rung)}")
        if rung.get("cl99_p99_ms", float("inf")) <= 1e3 * CHUNK_SECONDS:
            break
    return {"rungs": rungs}


def headline(rungs) -> tuple:
    """(value, what it is) from the ladder's rungs, as ``bench.py`` reads its
    tiers."""
    ms = 1e3 * CHUNK_SECONDS
    cl = [r for r in rungs if r.get("cl99_p99_ms", float("inf")) <= ms]
    if cl:
        r = max(cl, key=lambda r: r["b"])
        return float(r["b"]), (f"CL99-verified engine-e2e real-time streams/card (p99 "
                               f"tick() lateness {r['cl99_p99_ms']:.2f} ms over "
                               f"{r['paced_ticks']} paced ticks at B={r['b']}; p99 chunk "
                               f"response latency {r['response_p99_ms']:.2f} ms)")
    ok = [r for r in rungs if r.get("mean_ms", float("inf")) <= ms]
    if ok:
        r = max(ok, key=lambda r: r["b"])
        return float(r["b"]), (f"verified (mean <= 60 ms) engine-e2e streams/card "
                               f"({r['mean_ms']:.2f} ms mean over {r['ticks']} ticks at "
                               f"B={r['b']})")
    timed = [r for r in rungs if "mean_ms" in r]
    if not timed:
        return 0.0, "no rung completed"
    r = max(timed, key=lambda r: r["b"] / r["mean_ms"])
    return round(r["b"] * ms / r["mean_ms"], 1), (
        f"sustained-throughput engine-e2e streams/card ({r['mean_ms']:.2f} ms mean at "
        f"B={r['b']})")


def device_info(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ladder", type=int, nargs="+", default=list(LADDER))
    p.add_argument("--device", default="cuda", help="cuda, or cpu (no timing of the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decoder", choices=["greedy", "beam"], default="greedy")
    p.add_argument("--beam_width", type=int, default=4)
    p.add_argument("--beam_win", type=int, default=64,
                   help="beam: token slots a hypothesis ships to the host a tick")
    p.add_argument("--score_thresh", type=float, default=None,
                   help="beam: length-normalised score pruning (the server's 0.4); off")
    p.add_argument("--topk_thresh", type=float, default=None,
                   help="beam: acoustic candidate threshold (the server's 1.5); off")
    p.add_argument("--fe_frames", type=int, default=None,
                   help="beam: final-emission budget in ticks; off")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(args.device, args.seed)
    cuda = torch.device(args.device).type == "cuda"
    kw = None
    if args.decoder == "beam":
        kw = beam_options(args.beam_width, args.beam_win, args.score_thresh, args.topk_thresh,
                          args.fe_frames)
    compute = [compute_ms(model, B, engine_kw=kw) for B in COMPUTE_B]
    for c in compute:
        print(f"  compute {json.dumps(c)}", flush=True)
    k1 = k1_times(COMPUTE_B) if cuda else []
    for r in k1:
        print(f"  K1 {json.dumps(r)}", flush=True)
    rungs = run_ladder(model, args.ladder, engine_kw=kw)["rungs"]
    value, what = headline(rungs)
    search = ("greedy" if kw is None else
              f"beam width {args.beam_width}, window {args.beam_win}, thresholds "
              f"{args.score_thresh}/{args.topk_thresh}/{args.fe_frames}")
    line = {"metric": f"streaming_rts_base85m_{args.decoder}", "value": value,
            "unit": (f"{what}; raw 60 ms int16 audio -> native staging -> pinned upload "
                     f"(PCIe, timed) -> one CUDA graph (log-mel, encoder with K1, {search}, "
                     "max_symbols_per_step=4, bf16) -> wire-mode JSON over an 8,704-piece "
                     "vocabulary for every lane every tick"),
             "vs_baseline": round(value / BASELINE_RTS, 3),
             "device": device_info(args.device), "rungs": rungs, "compute": compute,
             "k1": k1}
    if cuda and kw is None:
        line["profile"] = dict(busy_share(model, PROFILE_B), eager=eager_ops(model, PROFILE_B))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
