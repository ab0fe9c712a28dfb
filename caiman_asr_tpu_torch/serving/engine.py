"""Batched streaming inference engine, the serving hot path (the port of
``caiman_asr_tpu/serving/engine.py``, greedy and beam decoding).

One tick advances every lane by one 60 ms chunk, all of it on the device:

  raw 60 ms audio chunk [B, 960 int16 samples] + a 241-sample device carry
    -> pre-emphasis -> matmul-DFT log-mel (6 x 10 ms frames)
    -> dataset-stats normalisation -> frame stacking (2 x 30 ms frames)
    -> stateful encoder step (pre_rnn -> StackTime -> post_rnn; on the card
       K1, one launch a layer, once per batch slice where the batch is
       larger than one launch takes)
    -> greedy decode step (joint + argmax + prediction-net advance, unrolled
       max_symbols_per_step times), or the beam step
       (``decoding/fast_beam.StreamingBeamStep``: W hypotheses a lane, E =
       min(max_symbols_per_step, 8) gated expansion trips, n-gram and
       keyword fusion, the pruning thresholds)
  -> one packed int32 output: greedy [B, max_symbols + 1], each lane's
     tokens and their count; beam [B, W*win/2 + W + 2 + W], the newest
     ``win`` token slots of every hypothesis as int16 pairs, the W lengths,
     the window's base, the rebase echo and the W scores (fp32 bits).

Beam lanes keep ``beam_cap`` token slots a hypothesis. Long streams are
rebased: when a lane's longest hypothesis comes within
``(pipeline_depth + 2) * E`` slots of the cap, the host asks the next tick
to drop the tokens it has already shipped as finals (the meta vector's
rebase entries); the tick rolls them out of the buffers before the step (a
roll by 0 is the identity, so the tick always rolls) and echoes the shift
in its output, so the host shifts its own coordinates at the tick that
applied it. The commit state (shipped horizon, the best hypothesis' token
history) lives in the native serializer, which derives the finals and the
partials from the packed window.

All lanes advance in lock-step; a lane that did not advance keeps its state,
so one program serves any mix of streams. The host manages lanes, buffers
audio (``native.AudioStaging``) and serialises responses
(``native.ResponseSerializer``).

On ``cuda`` the tick runs as one CUDA graph, the counterpart of the JAX
package's one jitted chunk program: ``warmup()`` (or the first tick) runs the
tick twice eagerly on the engine's stream, then captures it, and every tick
replays the capture. The device state (carry, encoder and decoder states) and
the tick's inputs and output are static buffers; the tick computes the new
state into temporaries and copies it over the old at its end, so no part of
a tick reads state the same tick has already overwritten (the counterpart of
``donate_argnums``). A capture that fails raises: the engine never falls back
to running the tick eagerly. ``cuda_graph=False`` asks for the eager tick on
the card (the smoke test holds the replay against it bit for bit). The
graph's K1 launches are counted at capture (``k1_launches_per_tick``, 8 or 8
x slices at base-85M) and added to ``lstm_recurrence.launches`` on every
replay, since a Python counter does not see replays.

With ``pipeline_depth`` N > 0, ``tick()`` fills one of two pinned staging
slots and hands it to an uploader thread, which copies it to the device on
its own CUDA stream, hands the slot back once the copy is done, then, on the
engine's stream, copies it into the tick's static input and replays the
tick; its packed output is copied back into a pinned buffer behind an event,
which a fetcher thread waits on. ``tick()`` consumes whatever has finished,
oldest first, and at most N ticks stay in flight. ``pipeline_depth=0`` runs
each tick to its end in ``tick()``.

"""

from __future__ import annotations

import queue
import threading
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.data.tokenizer import piece_table
from caiman_asr_tpu_torch.decoding.fast_beam import StreamingBeamStep, lane_axis
from caiman_asr_tpu_torch.decoding.greedy import init_decode_state, make_streaming_step
from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.models.state import EncoderState
from caiman_asr_tpu_torch.ops import lstm_kernel
from caiman_asr_tpu_torch.ops.features import stack_subsample_frames
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig, dft_bases, hann_window, mel_filterbank
from caiman_asr_tpu_torch.training.tree import tree_map


@dataclass
class StreamState:
    """Host-side per-lane bookkeeping; the lane's audio and its frame clock
    live in the native staging and serializer."""

    closed: bool = False  # EOS received; flush then free
    rebase_pending: bool = False  # a rebase is in flight (beam)


@dataclass
class WireTick:
    """One tick's responses in wire form (``wire_responses=True``).

    ``segments``: (raw, idx) pairs, one per drained tick: ``raw`` is a bytes
    arena of UTF-8 JSON payloads and ``idx`` an int32 [n, 3] array of (lane,
    offset, length), ``raw[off:off+len]`` being the text frame for that
    lane's socket. ``specials``: the engine's own dict responses (the EOS
    markers on stream close)."""

    segments: List[Tuple[bytes, np.ndarray]]
    specials: Dict[int, list]

    def to_dict(self) -> Dict[int, list]:
        """Flatten to the default mode's {lane: [json_str | dict]} form."""
        out: Dict[int, list] = {}
        for raw, idx in self.segments:
            for lane, off, ln in idx.tolist():
                out.setdefault(lane, []).append(raw[off:off + ln].decode("utf-8"))
        for lane, msgs in self.specials.items():
            out.setdefault(lane, []).extend(msgs)
        return out


class _Fetch:
    """A dispatched tick's packed output: a pinned host buffer that an event
    marks complete (on the card), or the tensor itself (on the CPU).
    ``result()`` waits, copies it out and hands the buffer back to its pool."""

    def __init__(self, buf: torch.Tensor, event=None, pool=None):
        self.buf, self.event, self.pool = buf, event, pool

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        out = self.buf.numpy().copy()
        if self.pool is not None:
            self.pool.put(self.buf)
        return out


@dataclass
class _Slot:
    """A staging slot: the host matrices the staging fills (numpy views of
    pinned tensors on the card) and, for the pipelined uploader, their
    device copies and the event after which the tick has read those."""

    samples_t: torch.Tensor
    meta_t: torch.Tensor
    dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    read: Optional[torch.cuda.Event] = None

    @property
    def samples(self) -> np.ndarray:
        return self.samples_t.numpy()

    @property
    def meta(self) -> np.ndarray:
        return self.meta_t.numpy()


def _upload_loop(q, eng_ref):
    """Uploader thread: for each queued (slot, adv), copy the slot to the
    device (no lock held), hand the slot back, then dispatch the tick under
    the state lock. Holds only the queue and a weakref, so a dropped engine
    is never pinned. ``None`` is the shutdown sentinel. An error is put in
    the pending entry and raised by the tick thread when it consumes it.
    ``q.task_done()`` comes after the entry is in ``_pending``."""
    while True:
        item = q.get()
        if item is None:
            return
        slot, adv = item
        eng = eng_ref()
        if eng is None:
            return
        ev = threading.Event()
        try:
            staged = eng._upload(slot)
            with eng._state_lock:
                fetch = eng._run(*staged)
        except Exception as e:  # surfaced by _consume on the tick thread
            ev.set()
            eng._pending.append([e, adv, ev])
            del eng
            q.task_done()
            continue
        entry = [fetch, adv, ev]
        eng._pending.append(entry)
        eng._fetchq.put(entry)
        del eng, entry, fetch
        q.task_done()


def _fetch_loop(q):
    """Fetcher thread: wait for each dispatched tick's output and copy it to
    the host. Touches only the queue and its entries, never the engine."""
    while True:
        entry = q.get()
        if entry is None:
            return
        try:
            entry[0] = entry[0].result()
        except Exception as e:  # surfaced by _consume on the tick thread
            entry[0] = e
        entry[2].set()


def _gate(new: torch.Tensor, old: torch.Tensor, mask: torch.Tensor, axis: int) -> torch.Tensor:
    """new on the lanes of ``mask`` [B], old elsewhere; ``axis`` is the
    leaf's lane axis, known by name, never guessed from its rank."""
    shape = [1] * new.dim()
    shape[axis] = mask.shape[0]
    return torch.where(mask.reshape(shape), new, old)


def _gate_enc(new: EncoderState, old: EncoderState, mask) -> EncoderState:
    """Each layer stack [L, B, H]: lane axis 1."""
    return EncoderState(*(tuple(_gate(a, b, mask, 1) for a, b in zip(hn, ho))
                          for hn, ho in zip(new, old)))


def _gate_dec(new, old, mask):
    """The greedy (g [B, Hj], h, c [L, B, Hp]) or the beam state's dict
    (``fast_beam.lane_axis`` names each leaf's lane axis)."""
    if isinstance(new, dict):
        return {k: _gate(v, old[k], mask, lane_axis(k)) for k, v in new.items()}
    return tuple(_gate(a, b, mask, ax) for a, b, ax in zip(new, old, (0, 1, 1)))


def _leaves(dec) -> List[torch.Tensor]:
    return list(dec.values()) if isinstance(dec, dict) else list(dec)


def _flat(enc: EncoderState, dec) -> List[torch.Tensor]:
    return [*enc.pre_rnn, *enc.post_rnn, *_leaves(dec)]


def _roll_left(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-lane left roll of x [B, W, n] by r[b] along the last axis (the
    tail wraps; callers read only below the shifted length)."""
    n = x.shape[2]
    idx = (torch.arange(n, device=x.device) + r.to(torch.int64)[:, None, None]) % n
    return torch.gather(x, 2, idx.expand(x.shape))


# guards K1's launch count, which the replays of every engine add to
_LAUNCHES_LOCK = threading.Lock()

# the dither's seed (the JAX engine's key is PRNGKey(4242))
DITHER_SEED = 4242


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash in int64 arithmetic (no product reaches 2^63)."""
    x = x & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & 0xFFFFFFFF
    return x ^ (x >> 16)


def dither_noise(shape, tick: torch.Tensor, seed: int) -> torch.Tensor:
    """Standard normal noise [B, S] (fp32) on ``tick``'s device, a function of
    (seed, tick, element) alone: Box-Muller over a counter hash. The JAX
    package folds its dither key with the tick count inside the program;
    this is its counterpart with no generator state, so a graph replay and
    an eager tick draw the same bits."""
    idx = torch.arange(shape[0] * shape[1], device=tick.device, dtype=torch.int64)
    key = _mix32(tick.to(torch.int64) + seed * 0x9E3779B)
    u1 = (_mix32((2 * idx) ^ key).float() + 1.0) * 2.0 ** -32
    u2 = _mix32((2 * idx + 1) ^ key).float() * 2.0 ** -32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)
    return z.reshape(shape)


class StreamingEngine:
    def __init__(
        self,
        model,
        blank_idx: int,
        tokenizer,
        mel_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        max_streams: int = 64,
        max_symbols_per_step: int = 8,
        decoder: str = "greedy",
        logmel: LogMelConfig = LogMelConfig(),
        frame_stacking: int = 3,
        frame_subsampling: int = 3,
        dtype: torch.dtype = torch.float32,
        pipeline_depth: int = 0,
        ngram_lm=None,
        keywords=None,
        device="cuda",
        wire_responses: bool = False,
        cuda_graph: bool = True,
        beam_width: int = 4,
        beam_cap: int = 256,
        beam_win: int = 64,
        ngram_alpha: float = 0.0,
        beam_merge: bool = True,
        beam_score_thresh: Optional[float] = None,
        beam_topk_thresh: Optional[float] = None,
        beam_final_emission_frames: Optional[int] = None,
    ):
        """``model``: an ``RNNT`` whose weights live on ``device``; the engine
        keeps its own copies in ``dtype``. ``device``: "cuda" (one engine per
        card) unless the caller passes "cpu". ``cuda_graph``: on the card,
        run the tick as one CUDA graph (the default) or eagerly; ignored on
        the CPU. ``tokenizer``: one with ``id_to_piece`` (the native
        serializer's piece table), or None for empty transcripts. The C++
        staging and serializer are built on first use; a build that fails
        raises ``native.NativeBuildError``. ``pipeline_depth``: ticks in
        flight (see the module docstring).

        ``decoder="beam"``: ``beam_width`` hypotheses a lane of at most
        ``beam_cap`` tokens, the newest ``beam_win`` (rounded down to even,
        at most the cap) sent to the host a tick; ``ngram_lm`` (a
        ``lm.device_table.DeviceNgram``, fused at ``ngram_alpha``) and
        ``keywords`` (a ``keywords.device_table.DeviceKeywords``);
        ``beam_merge`` merges duplicate hypotheses; the pruning thresholds
        (None disables each; the final-emission one in ticks)."""
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder={decoder!r}: greedy or beam")
        if decoder == "greedy" and (ngram_lm is not None or keywords is not None):
            raise ValueError("n-gram fusion and keyword boosting need decoder='beam'")
        self.device = resolve_device(device)
        param_dev = next(model.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"model parameters are on {param_dev}, the engine on {self.device}")
        cuda = self.device.type == "cuda"
        self.model = model
        self.params = tree_map(lambda t: t.detach().to(self.device, dtype), model.param_tree())
        self.blank_idx = blank_idx
        self.tokenizer = tokenizer
        self.B = max_streams
        self.cfg = logmel
        self.stack = frame_stacking
        self.sub = frame_subsampling
        self.dtype = dtype

        hop, win = logmel.hop_length, logmel.win_length
        self.mel_per_tick = frame_stacking * model.cfg.enc_stack_time_factor  # 6
        self.hop_samples = self.mel_per_tick * hop                            # 960
        self.carry_samples = (win - hop) + 1                                  # 241
        self.frame_seconds = self.hop_samples / logmel.sample_rate            # 0.06

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device, dtype)

        cos_b, sin_b = dft_bases(logmel.n_fft, win)
        w = hann_window(win)[:, None]
        # the windowed real and imaginary bases side by side: one product
        self._dft = dev(np.concatenate([cos_b * w, sin_b * w], axis=1))
        self._fb = dev(mel_filterbank(logmel.sample_rate, logmel.n_fft, logmel.n_mels))
        if mel_stats is not None:
            self._mean, self._std = dev(mel_stats[0]), dev(mel_stats[1])
        else:
            self._mean = dev(np.zeros(logmel.n_mels))
            self._std = dev(np.ones(logmel.n_mels))
        self.decoder = decoder
        self.max_symbols = max_symbols_per_step
        if decoder == "beam":
            self.beam_width = beam_width
            self._beam_cap = beam_cap
            self._beam_win = max(2, min(beam_win, beam_cap) // 2 * 2)
            self._beam_expansions = min(max_symbols_per_step, 8)
            self._beam = StreamingBeamStep(
                model, blank_idx, beam_width=beam_width, expansions=self._beam_expansions,
                cap=beam_cap, ngram_lm=ngram_lm, ngram_alpha=ngram_alpha, keywords=keywords,
                merge=beam_merge, score_thresh=beam_score_thresh, topk_thresh=beam_topk_thresh,
                final_emission_frames=beam_final_emission_frames)
            out_cols = beam_width * self._beam_win // 2 + 2 * beam_width + 2
        else:
            self._decode_step = make_streaming_step(model, blank_idx,
                                                    max_symbols_per_step=max_symbols_per_step)
            out_cols = max_symbols_per_step + 1

        self._init_native()
        self._wire = bool(wire_responses)

        # device state, the tick's static inputs and its output
        c = model.cfg
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=self.device)  # noqa: E731
        self.enc_state = EncoderState(
            pre_rnn=(z(c.enc_pre_rnn_layers, self.B, c.enc_n_hid),
                     z(c.enc_pre_rnn_layers, self.B, c.enc_n_hid)),
            post_rnn=(z(c.enc_post_rnn_layers, self.B, c.enc_n_hid),
                      z(c.enc_post_rnn_layers, self.B, c.enc_n_hid)))
        if decoder == "beam":
            self._init_dec = self._beam.init_state(self.params, self.B, dtype)
            self.dec_state = {k: t.clone() for k, t in self._init_dec.items()}
        else:
            self._init_dec = init_decode_state(model, self.B, params=self.params, dtype=dtype)
            self.dec_state = tuple(t.clone() for t in self._init_dec)
        self._carry = torch.zeros((self.B, self.carry_samples), dtype=torch.int16,
                                  device=self.device)
        self._in_samples = torch.zeros((self.B, self.hop_samples), dtype=torch.int16,
                                       device=self.device)
        self._in_meta = torch.zeros(3 * self.B + 1, dtype=torch.int32, device=self.device)
        self._out = torch.zeros((self.B, out_cols), dtype=torch.int32, device=self.device)
        self._use_graph = cuda and cuda_graph
        self._graph = None
        self._warm = False
        self.k1_launches_per_tick: Optional[int] = None
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._up_stream = torch.cuda.Stream(self.device) if cuda and pipeline_depth else None

        self._tick_count = 0
        # ticks whose responses tick() or poll() has handed out
        self.ticks_consumed = 0
        self.pipeline_depth = pipeline_depth
        # entries [packed (a _Fetch, or the fetched array), adv, event];
        # one producer (tick thread or uploader), one consumer (tick thread)
        self._pending = deque()
        self.streams: Dict[int, StreamState] = {}
        self._free = list(range(self.B))
        # lanes whose device state is zeroed by the next dispatched tick
        self._pending_resets: set = set()
        # the server ticks from an executor thread while connection handlers
        # open, close and push from the event loop
        self._lock = threading.RLock()
        # guards the device state and the dispatch order
        self._state_lock = threading.Lock()

        n_slots = 2 if pipeline_depth else 1
        self._slots = [self._new_slot(pipelined=bool(pipeline_depth)) for _ in range(n_slots)]
        # pinned output buffers: one a tick in flight, and one spare
        self._out_pool: queue.Queue = queue.Queue()
        for _ in range(pipeline_depth + 2 if cuda else 0):
            self._out_pool.put(torch.empty_like(self._out, device="cpu").pin_memory())
        self._slot_pool = self._upq = self._fetchq = None
        self._up_thread = self._fetch_thread = None
        if pipeline_depth:
            self._slot_pool = queue.Queue()
            for s in self._slots:
                self._slot_pool.put(s)
            # free functions + a weakref: a bound method would pin a dropped
            # engine forever through the blocked queue.get()
            self._fetchq = queue.Queue()
            self._fetch_thread = threading.Thread(target=_fetch_loop, args=(self._fetchq,),
                                                  daemon=True)
            self._fetch_thread.start()
            weakref.finalize(self, self._fetchq.put, None)
            self._upq = queue.Queue()
            self._up_thread = threading.Thread(target=_upload_loop,
                                               args=(self._upq, weakref.ref(self)), daemon=True)
            self._up_thread.start()
            weakref.finalize(self, self._upq.put, None)

    def _init_native(self) -> None:
        """The C++ staging and serializer (the serializer's piece table from
        the tokenizer)."""
        from caiman_asr_tpu_torch import native

        tok = self.tokenizer
        if tok is not None and not hasattr(tok, "id_to_piece"):
            raise ValueError("the engine's tokenizer needs id_to_piece")
        # real tokenizers carry n_classes - 1 pieces (the blank never
        # serialises); a synthetic one may carry all n_classes
        pieces = self._pieces = piece_table(tok, self.model.n_classes)
        beam = self.decoder == "beam"
        self._native_ser = native.ResponseSerializer(
            self.B, self.frame_seconds, pieces, beam_width=self.beam_width if beam else 1,
            beam_win=self._beam_win if beam else 1)
        # carry_len 0: the carry is device state
        self._native_stg = native.AudioStaging(self.B, 0, self.hop_samples)
        self._active = np.zeros(self.B, np.uint8)
        self._closed = np.zeros(self.B, np.uint8)

    def _new_slot(self, pipelined: bool) -> _Slot:
        samples = torch.zeros((self.B, self.hop_samples), dtype=torch.int16)
        meta = torch.zeros(3 * self.B + 1, dtype=torch.int32)
        if self.device.type != "cuda":
            return _Slot(samples, meta)
        slot = _Slot(samples.pin_memory(), meta.pin_memory())
        if pipelined:
            slot.dev = (torch.zeros_like(self._in_samples), torch.zeros_like(self._in_meta))
            slot.read = torch.cuda.Event()
            slot.read.record(self._stream)
        return slot

    def close(self):
        """Stop the uploader and fetcher threads and free the native state."""
        if self._upq is not None:
            self._upq.put(None)
            self._up_thread.join(timeout=30)
            self._upq = self._up_thread = None
        if self._fetchq is not None:
            self._fetchq.put(None)
            self._fetch_thread.join(timeout=10)
            self._fetchq = self._fetch_thread = None
        for h in (self._native_ser, self._native_stg):
            h.close()

    # --------------------------------------------------------- device step
    def _tick_impl(self, samples_new, carry, enc_state, dec_state, init_dec, meta):
        """samples_new: [B, hop] int16, only the fresh 60 ms; ``carry`` [B,
        241] int16 is the window and pre-emphasis overlap, device state
        prepended here and taken again from the tail. meta: [3B + 1] int32,
        ``[adv(B), rebase(B), reset(B), tick_count]``. Lanes in ``reset`` are
        zeroed (the decoder state set to ``init_dec``) before the tick
        computes; lanes not in ``adv`` keep their state; ``rebase`` (beam)
        drops that many committed token slots from the front of a lane's
        buffers before the step. Returns (packed int32 output, carry,
        encoder state, decoder state)."""
        cfg = self.cfg
        B = samples_new.shape[0]
        adv = meta[:B] != 0
        keep = meta[2 * B:3 * B] == 0
        carry = torch.where(keep[:, None], carry, 0)
        enc_state = _gate_enc(enc_state, EncoderState(*(tuple(map(torch.zeros_like, hc))
                                                        for hc in enc_state)), keep)
        dec_state = _gate_dec(dec_state, init_dec, keep)
        samples = torch.cat([carry, samples_new], dim=1)
        new_carry = samples[:, -self.carry_samples:]
        x = (samples.float() * (1.0 / 32768.0)).to(self.dtype)
        if cfg.dither != 0.0:
            noise = dither_noise(x.shape, meta[3 * B], DITHER_SEED)
            x = x + cfg.dither * noise.to(self.dtype)
        pre = x[:, 1:] - cfg.preemph * x[:, :-1]                      # [B, 1200]
        # the overlapping windows copied out whole, so the DFT is one plain
        # product over B * 6 rows (a batched product over the strided view
        # is a batch of B small products)
        frames = pre.unfold(1, cfg.win_length, cfg.hop_length)[:, :self.mel_per_tick]
        spec = frames.reshape(B * self.mel_per_tick, cfg.win_length) @ self._dft
        re, im = spec.chunk(2, dim=1)
        mel = ((re * re + im * im) @ self._fb).reshape(B, self.mel_per_tick, -1)
        logmel = torch.log(torch.clamp(mel, min=1e-20))
        norm = (logmel - self._mean) / (self._std + 1e-9)
        lens = torch.full((B,), self.mel_per_tick, dtype=torch.int32, device=x.device)
        feats, _ = stack_subsample_frames(norm.transpose(1, 2), lens, self.stack, self.sub)
        x = feats.permute(2, 0, 1).to(self.dtype)                     # [2, B, 240]
        f, _, new_enc = self.model.encode(
            x, torch.full((B,), x.shape[0], dtype=torch.int32, device=x.device), enc_state,
            params=self.params)
        if self.decoder == "beam":
            rebase = meta[B:2 * B].to(torch.int64)
            dec_state = dict(dec_state, toks=_roll_left(dec_state["toks"], rebase),
                             ts=_roll_left(dec_state["ts"], rebase),
                             lens=torch.clamp(dec_state["lens"] - rebase[:, None], min=0))
            if "committed" in dec_state:  # the final-emission watermark shifts too
                dec_state["committed"] = torch.clamp(dec_state["committed"] - rebase, min=0)
            new_dec = self._beam.step(self.params, f[:, 0], dec_state)
            out = self._beam_pack(new_dec, adv, rebase)
        else:
            toks, n, new_dec = self._decode_step(self.params, f[:, 0], dec_state)
            out = torch.cat([toks, torch.where(adv, n, 0)[:, None]], dim=1).to(torch.int32)
        new_carry = torch.where(adv[:, None], new_carry, carry)
        new_enc = _gate_enc(new_enc, enc_state, adv)
        new_dec = _gate_dec(new_dec, dec_state, adv)
        return out, new_carry, new_enc, new_dec

    def _beam_pack(self, st, adv, rebase) -> torch.Tensor:
        """The beam tick's host-bound output in one int32 [B, W*win/2 + 2W +
        2]: the newest ``win`` slots of every hypothesis as int16 pairs (the
        window starts at ``base``, ``win`` below the longest), the lengths (0
        on a lane that did not advance), base, the rebase echo, the scores'
        bits."""
        B, W, win = adv.shape[0], self.beam_width, self._beam_win
        lens = st["lens"]
        base = torch.clamp(lens.amax(dim=1) - win, min=0)
        toks = _roll_left(st["toks"], base)[:, :, :win]
        pairs = toks.to(torch.int16).reshape(B, W * win).contiguous().view(torch.int32)
        return torch.cat([pairs, torch.where(adv[:, None], lens, 0).to(torch.int32),
                          base.to(torch.int32)[:, None], rebase.to(torch.int32)[:, None],
                          st["scores"].float().contiguous().view(torch.int32)], dim=1)

    @torch.no_grad()
    def _step(self) -> None:
        """One tick over the static buffers: the state is read whole, then
        overwritten in place at the end (what the CUDA graph captures)."""
        out, carry, enc, dec = self._tick_impl(self._in_samples, self._carry, self.enc_state,
                                               self.dec_state, self._init_dec, self._in_meta)
        self._out.copy_(out)
        self._carry.copy_(carry)
        for dst, src in zip(_flat(self.enc_state, self.dec_state), _flat(enc, dec)):
            dst.copy_(src)

    def warmup(self):
        """Run the tick twice with no lane advancing (the state is left as it
        was), then, on the card, capture it as a CUDA graph. Raises if the
        capture fails."""
        with self._state_lock:
            self._warmup_locked()

    def _warmup_locked(self):
        if self._warm:
            return
        self._in_meta.zero_()
        k1 = lstm_kernel.lstm_recurrence
        if self._stream is None:
            self._step()
            n0 = k1.launches
            self._step()
            self.k1_launches_per_tick = k1.launches - n0
            self._warm = True
            return
        with torch.cuda.device(self.device):
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                self._step()
                n0 = k1.launches
                self._step()
                self.k1_launches_per_tick = k1.launches - n0
            self._stream.synchronize()
            if self._use_graph:
                graph = torch.cuda.CUDAGraph()
                n0 = k1.launches
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    self._step()
                # the capture launched nothing; each replay launches these
                captured = k1.launches - n0
                k1.launches = n0
                if captured != self.k1_launches_per_tick:
                    raise RuntimeError(f"the captured tick holds {captured} K1 launches, "
                                       f"the eager tick {self.k1_launches_per_tick}")
                self._graph = graph
        self._warm = True

    def _upload(self, slot: _Slot):
        """The pipelined upload: the slot's host matrices to its device
        copies on the upload stream (after the tick that last read those);
        the slot goes back to the pool once the copy is done (on the CPU, a
        copy of it is the upload). Returns what ``_run`` takes."""
        try:
            if self._up_stream is None:  # CPU
                return (slot.samples_t.clone(), slot.meta_t.clone(), None, None)
            with torch.cuda.device(self.device), torch.cuda.stream(self._up_stream):
                self._up_stream.wait_event(slot.read)
                slot.dev[0].copy_(slot.samples_t, non_blocking=True)
                slot.dev[1].copy_(slot.meta_t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._up_stream)
            done.synchronize()
            return slot.dev + (done, slot.read)
        finally:  # even after a failed copy, or the tick thread waits forever
            self._slot_pool.put(slot)

    def _run(self, samples, meta, uploaded=None, read=None) -> _Fetch:
        """Dispatch one tick (state lock held): its inputs into the static
        buffers on the engine's stream (after ``uploaded``; ``read`` recorded
        once they are copied), the graph's replay (or the eager tick), and
        the output's copy to a pinned buffer. Returns its ``_Fetch``."""
        if not self._warm:
            self._warmup_locked()
        if self._stream is None:
            self._in_samples.copy_(samples)
            self._in_meta.copy_(meta)
            self._step()
            return _Fetch(self._out.clone())
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if uploaded is not None:
                self._stream.wait_event(uploaded)
            self._in_samples.copy_(samples, non_blocking=True)
            self._in_meta.copy_(meta, non_blocking=True)
            if read is not None:
                read.record(self._stream)
            if self._graph is not None:
                self._graph.replay()
                with _LAUNCHES_LOCK:  # engines on several cards tick from threads
                    lstm_kernel.lstm_recurrence.launches += self.k1_launches_per_tick
            else:
                self._step()
            buf = self._out_pool.get()
            buf.copy_(self._out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return _Fetch(buf, done, self._out_pool)

    # ------------------------------------------------------------- streams
    def open_stream(self) -> Optional[int]:
        with self._lock:
            if not self._free:
                return None
            lane = self._free.pop(0)
            self.streams[lane] = StreamState()
            self._native_stg.reset_lane(lane)
            self._active[lane] = 1
            self._closed[lane] = 0
            self._reset_lane(lane)
            return lane

    def close_stream(self, lane: int):
        """Mark EOS: the lane's buffered audio is flushed on the next ticks."""
        with self._lock:
            if lane in self.streams:
                self.streams[lane].closed = True
                self._closed[lane] = 1

    def lane_frames(self, lane: int) -> int:
        """Decoder frames (60 ms ticks) the lane has consumed so far."""
        with self._lock:
            return self._native_ser.frame_idx(lane)

    def set_lane_frame_base(self, lane: int, frames: int):
        """Start the lane's response clock at an absolute frame index (a
        state-reset shadow lane's stream-absolute timestamps)."""
        with self._lock:
            self._native_ser.set_frame_idx(lane, frames)

    def _reset_lane(self, lane: int):
        """Zero the lane's device state in the next dispatched tick (through
        the meta vector's reset mask)."""
        self._native_ser.reset_lane(lane)
        self._pending_resets.add(lane)

    def push_audio(self, lane: int, samples: np.ndarray):
        """Buffer audio for a lane: int16 PCM (the wire format) or float32 in
        [-1, 1) (converted)."""
        with self._lock:
            if lane not in self.streams:
                raise KeyError(lane)
            self._native_stg.push(lane, samples)

    def push_audio_block(self, block: np.ndarray, lanes=None):
        """Row i of ``block`` ([m, n] int16 or float32) to lane ``lanes[i]``
        (lane i when lanes is None), under one lock and, natively, one call."""
        with self._lock:
            self._native_stg.push_rows(block, lanes)

    def _release(self, lane: int):
        del self.streams[lane]
        self._active[lane] = 0
        self._free.append(lane)

    # ----------------------------------------------------------------- tick
    def tick(self):
        """Advance every lane that has a full chunk buffered (or is flushing).

        Returns {lane: response} for lanes that produced output (a list where
        a lane has several), or a ``WireTick`` in wire mode; releases lanes
        whose EOS flush completed."""
        with self._lock:
            return self._tick_locked()

    def poll(self):
        """Drain the in-flight ticks whose output is already on the host,
        without advancing lanes (non-blocking); the same shape as tick()."""
        with self._lock:
            out: Dict[int, List] = {}
            wire = [] if self._wire else None
            while self._pending:
                fetch, _, ev = self._pending[0]
                if not (ev.is_set() if ev is not None else fetch.ready()):
                    break
                self._consume(self._pending.popleft(), out, wire)
            return self._shape(out, wire)

    def _shape(self, out, wire):
        if wire is not None:
            return WireTick(wire, out)
        return {lane: (msgs if len(msgs) > 1 else msgs[0]) for lane, msgs in out.items()}

    def _tick_locked(self):
        if not self.streams:
            return WireTick([], {}) if self._wire else {}
        # blocks while both slots are with the uploader: the backpressure
        # that keeps a steady tick at max(upload, device, host)
        slot = self._slot_pool.get() if self._slot_pool is not None else self._slots[0]
        adv, fin = self._native_stg.tick(slot.samples, self._active, self._closed)
        finishing = [int(lane) for lane in np.flatnonzero(fin)]

        out: Dict[int, List] = {}
        wire = [] if self._wire else None
        if adv.any():
            self._tick_count += 1
            meta = slot.meta
            meta[:self.B] = adv
            meta[self.B:] = 0
            if self.decoder == "beam":
                self._schedule_rebase(adv, meta[self.B:2 * self.B])
            for lane in self._pending_resets:
                meta[2 * self.B + lane] = 1
            self._pending_resets.clear()
            meta[-1] = self._tick_count
            if self._upq is not None:
                self._upq.put((slot, adv))
                while self._pending and self._pending[0][2].is_set():
                    self._consume(self._pending.popleft(), out, wire)
            else:
                with self._state_lock:
                    fetch = self._run(slot.samples_t, slot.meta_t)
                self._pending.append([fetch, adv, None])
            while len(self._pending) > self.pipeline_depth:
                self._consume(self._pending.popleft(), out, wire)
        elif self._slot_pool is not None:
            self._slot_pool.put(slot)  # nothing advanced: the slot goes back

        if finishing:
            # drain every in-flight tick before the EOS markers
            if self._upq is not None:
                self._upq.join()
            while self._pending:
                self._consume(self._pending.popleft(), out, wire)
        for lane in finishing:
            msgs = out.setdefault(lane, [])
            if self.decoder == "beam":
                tail = self._beam_tail(lane)
                if tail:
                    msgs.append(self._response(self._native_ser.frame_idx(lane), tail))
            msgs.append({"eos": True})
            self._reset_lane(lane)
            self._release(lane)
        return self._shape(out, wire)

    def _schedule_rebase(self, adv: np.ndarray, rebase: np.ndarray) -> None:
        """Ask the next tick to drop a lane's shipped tokens once its longest
        hypothesis (as the last consumed tick saw it) is within the margin of
        the cap: the ticks in flight may each add E."""
        margin = (self.pipeline_depth + 2) * self._beam_expansions
        near = np.flatnonzero(adv & (self._native_ser._dev_len + margin >= self._beam_cap))
        for lane in near.tolist():
            st = self.streams.get(lane)
            if st is None or st.rebase_pending:
                continue
            committed = self._native_ser.committed(lane)
            if committed > 0:
                rebase[lane] = committed
                st.rebase_pending = True

    def _beam_tail(self, lane: int) -> List[int]:
        """A closing lane's best hypothesis past what it has shipped (every
        tick of the lane consumed), read from the device state."""
        committed = self._native_ser.committed(lane)
        with self._state_lock:
            if self._stream is not None:
                self._stream.synchronize()
            toks, lens, scores = (self.dec_state[k][lane].cpu().numpy()
                                  for k in ("toks", "lens", "scores"))
        best = int(np.argmax(scores / np.maximum(lens + 1, 1)))
        return [int(t) for t in toks[best, committed:lens[best]]]

    def _response(self, frame_idx: int, tokens: List[int]) -> dict:
        """A final as the WebSocket schema has it (the close flush's)."""
        text = "".join(self._pieces[t] for t in tokens).replace("▁", " ")
        t = frame_idx * self.frame_seconds
        return {"start": round(t, 3), "end": round(t + self.frame_seconds, 3),
                "is_provisional": False,
                "alternatives": [{"transcript": text, "confidence": 1.0}]}

    def _consume(self, entry, out: Dict[int, List], wire=None):
        """One in-flight tick's packed output -> responses appended to
        ``out`` (or, in wire mode, one (arena, index) segment to ``wire``)."""
        packed, adv, ev = entry
        if ev is not None:
            ev.wait()
            packed = entry[0]
            if isinstance(packed, Exception):
                raise packed
        else:
            packed = packed.result()
        self.ticks_consumed += 1
        ser = self._native_ser
        if self.decoder == "beam":
            # the int16 token pairs widened back to int32, the layout the
            # serializer parses
            W, win = self.beam_width, self._beam_win
            half = W * win // 2
            t16 = np.ascontiguousarray(packed[:, :half]).view(np.int16)
            packed = np.concatenate([t16.astype(np.int32), packed[:, half:]], axis=1)
            if wire is not None:
                raw, idx, _ = ser.beam_tick_raw(packed, adv)
            else:
                recs, _ = ser.beam_tick(packed, adv)
            echo = packed[:, W * win + W + 1]
            for lane in np.flatnonzero((echo > 0) & adv).tolist():
                st = self.streams.get(lane)
                if st is not None:
                    st.rebase_pending = False
        elif wire is not None:
            raw, idx = ser.greedy_tick_raw(packed, adv)
        else:
            recs = ser.greedy_tick(packed, adv)
        if wire is not None:
            if len(idx):
                wire.append((raw, idx.copy()))  # idx views a reused buffer
        else:
            for lane, msgs in recs.items():
                if lane in self.streams:
                    out.setdefault(lane, []).extend(msgs)
