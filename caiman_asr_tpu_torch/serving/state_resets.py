"""State resets for SERVING: periodic model-state refresh on live streams.

The port's copy of ``caiman_asr_tpu/serving/state_resets.py``
(``StateResetRouter``, ``:79-320``), over the port's ``StreamingEngine``.

Long audio degrades LSTM streaming models; the reference resets model state
every ``--sr_segment`` seconds with ``--sr_overlap`` seconds of warmup
context, at ~25% RTS cost on its FPGA (reference
docs/src/training/state_resets.md, performance.md:31-39 "with state
resets" rows; evaluate/state_resets/* implements the offline variant).
This module brings the same mechanism to the streaming server.

Design — shadow-lane handover, entirely host-side: the engine's lanes
advance in lock-step in one device tick, so a per-lane "replay the last
3 s" is impossible without stalling the batch. Instead, for each user stream the
router keeps segment boundaries at ``k * segment`` on the stream's own
audio clock and:

  1. at ``boundary - overlap`` opens a SHADOW lane from zero model state,
     feeding it the same audio (its response clock is pre-set to the
     absolute frame via ``engine.set_lane_frame_base``);
  2. drops shadow responses that END inside the overlap (the offline
     analogue: overlap tokens of the second segment are dropped,
     evaluate/state_resets.py) and WITHHOLDS post-boundary ones — a
     backlogged shadow can outrun the primary's drain (burst pushes);
  3. once the primary has CONSUMED up to the boundary (``lane_frames``,
     or its EOS after a user hang-up — it only ever holds audio up to the
     boundary), retires it (EOS swallowed), promotes the shadow, and
     flushes the withheld responses — the stream continues seamlessly
     with stream-absolute timestamps. A user close with post-boundary
     audio in flight still completes the handover so no audio is lost.

Capacity: a stream occupies a second lane only during the overlap window,
so provision ``ceil(streams * (1 + overlap/segment))`` lanes — the same
lane arithmetic behind the reference's ~25% RTS cost. If no lane is free
when a shadow is due, that reset cycle is skipped (the stream simply keeps
its state one more segment) rather than dropping audio.

Boundary semantics per decoder: GREEDY responses carry their emission
tick, which equals the audio tick, so the overlap filter is exact — no
loss, no duplication. BEAM finals ship when hypothesis agreement commits,
typically a few ticks after the audio they cover; a shadow's
overlap-audio tokens can therefore commit past the boundary and be
delivered even though the primary also emitted them — at a reset
boundary a beam stream may REPEAT a word or two of the overlap rather
than lose text (duplication is the safe side for captions; the offline
evaluator's lookahead merge, evaluate/state_resets.py, is the exact
variant when timestamps are available after the fact).

Works over any engine object with open/close/push/tick/lane_frames/
set_lane_frame_base (one with an ``engines`` list, as the JAX package's
MultiChipEngine, is read through its first engine).
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class _SRStream:
    primary: int
    pos: int = 0                  # samples pushed by the user so far
    seg_k: int = 1                # next boundary is at seg_k * segment
    shadow: Optional[int] = None
    shadow_failed: bool = False   # no free lane this cycle; retry next one
    closed: bool = False
    # lanes draining to EOS: (lane, forward) — retired primaries forward
    # their close-flush tail (beam ships committed-but-unsent tokens there);
    # dropped mid-overlap shadows are pure re-decodes and stay silent
    retiring: List[object] = field(default_factory=list)
    # shadow responses past the boundary, withheld until the handover (a
    # bursty/backlogged shadow can outrun the primary's drain)
    buf: List[object] = field(default_factory=list)


class StateResetRouter:
    """Engine wrapper adding periodic state resets to live streams."""

    def __init__(self, engine, segment_secs: float = 15.0,
                 overlap_secs: float = 3.0):
        if not 0.0 < overlap_secs < segment_secs:
            raise ValueError("need 0 < overlap < segment")
        base = engine.engines[0] if hasattr(engine, "engines") else engine
        if getattr(base, "_wire", False):
            # the router re-keys and merges per-lane responses across the
            # shadow handover — it needs the dict form, not the wire arena
            raise ValueError(
                "state-reset routing is incompatible with wire_responses"
            )
        self.eng = engine
        fs = engine.frame_seconds if hasattr(engine, "frame_seconds") else \
            engine.engines[0].frame_seconds
        self.hop = int(round(
            (engine.hop_samples if hasattr(engine, "hop_samples")
             else engine.engines[0].hop_samples)))
        self.frame_secs = fs
        self.seg_ticks = max(2, int(round(segment_secs / fs)))
        self.ovl_ticks = max(1, min(int(round(overlap_secs / fs)),
                                    self.seg_ticks - 1))
        self.seg_samples = self.seg_ticks * self.hop
        self.ovl_samples = self.ovl_ticks * self.hop
        self.streams: Dict[int, _SRStream] = {}
        self._next_uid = 0
        self._warned_capacity = False
        # The wrapped engine locks its own entry points, but the router's
        # compound handover (promote + re-key + grid advance) must not
        # interleave with pushes: the server ticks from an executor thread
        # while handlers push on the event loop.
        self._lock = threading.RLock()

    # ------------------------------------------------------------ passthrough
    @property
    def B(self):
        return self.eng.B

    @property
    def n_chips(self):
        return getattr(self.eng, "n_chips", 1)

    def warmup(self):
        self.eng.warmup()

    def close(self):
        if hasattr(self.eng, "close"):
            self.eng.close()

    # ---------------------------------------------------------------- streams
    def open_stream(self) -> Optional[int]:
        with self._lock:
            lane = self.eng.open_stream()
            if lane is None:
                return None
            uid = self._next_uid
            self._next_uid += 1
            self.streams[uid] = _SRStream(primary=lane)
            return uid

    def close_stream(self, uid: int):
        with self._lock:
            self._close_stream_locked(uid)

    def _close_stream_locked(self, uid: int):
        s = self.streams.get(uid)
        if s is None or s.closed:
            return
        s.closed = True
        self.eng.close_stream(s.primary)
        if s.shadow is not None:
            if s.pos >= s.seg_k * self.seg_samples:
                # the stream crossed the boundary: post-boundary audio lives
                # ONLY in the shadow, so the handover must still complete —
                # keep the shadow; tick() closes it after the swap.
                pass
            else:
                # ended mid-overlap: the primary heard everything; the
                # shadow is a pure re-decode of the tail — drop it
                self.eng.close_stream(s.shadow)
                s.retiring.append((s.shadow, False))
                s.shadow = None

    def push_audio(self, uid: int, samples: np.ndarray):
        with self._lock:
            self._push_audio_locked(uid, samples)

    def _push_audio_locked(self, uid: int, samples: np.ndarray):
        s = self.streams[uid]
        n = len(samples)
        if n == 0 or s.closed:
            return
        start, end = s.pos, s.pos + n
        boundary = s.seg_k * self.seg_samples
        shadow_from = boundary - self.ovl_samples

        # the shadow must exist before any audio beyond the boundary
        # arrives; if no lane is free, skip this reset cycle cleanly
        if end > shadow_from and s.shadow is None and not s.shadow_failed:
            lane = self.eng.open_stream()
            if lane is None:
                if not self._warned_capacity:
                    warnings.warn(
                        "state-reset shadow lane unavailable (engine at "
                        "capacity); skipping this reset cycle — provision "
                        "~(1 + overlap/segment) lanes per stream"
                    )
                    self._warned_capacity = True
                s.shadow_failed = True
            else:
                s.shadow = lane
                # response clock = the absolute tick of the FIRST sample
                # this lane will hear: normally boundary - overlap, later
                # when a burst already passed it (less warmup, but
                # timestamps and the overlap filter stay aligned)
                self.eng.set_lane_frame_base(
                    lane, max(start, shadow_from) // self.hop
                )
        if s.shadow_failed and end > boundary:
            # reset cycle skipped: slide the grid one segment
            s.seg_k += 1
            s.shadow_failed = False
            boundary = s.seg_k * self.seg_samples

        # primary hears [start, min(end, boundary)); shadow hears
        # [max(start, shadow_from), end)
        p_end = min(end, boundary)
        if p_end > start:
            self.eng.push_audio(s.primary, samples[: p_end - start])
        if s.shadow is not None:
            sh_from = max(start, shadow_from)
            if end > sh_from:
                self.eng.push_audio(s.shadow, samples[sh_from - start:])
        s.pos = end

    # ------------------------------------------------------------------- tick
    def tick(self) -> Dict[int, object]:
        out = self.eng.tick()
        with self._lock:
            return self._route_locked(out)

    def _route_locked(self, out) -> Dict[int, object]:
        user_out: Dict[int, List[object]] = {}
        done = []
        for uid, s in self.streams.items():
            # drain retired lanes: a retired PRIMARY's close-flush tail is
            # real transcript (beam ships committed-but-unsent tokens with
            # the flush) and is forwarded — it covers audio just before the
            # boundary, so it lands ahead of this tick's messages; dropped
            # shadows stay silent; EOS frees the lane either way
            still = []
            for lane, forward in s.retiring:
                resp = out.pop(lane, None)
                if resp is None:
                    still.append((lane, forward))
                    continue
                eos_seen = False
                for m in _msgs(resp):
                    if _is_eos(m):
                        eos_seen = True
                    elif forward:
                        user_out.setdefault(uid, []).append(m)
                if not eos_seen:
                    still.append((lane, forward))
            s.retiring = still
            boundary_frames = s.seg_k * self.seg_ticks
            boundary_secs = boundary_frames * self.frame_secs
            resp = out.pop(s.primary, None)
            primary_eos = False
            if resp is not None:
                for m in _msgs(resp):
                    if _is_eos(m):
                        primary_eos = True
                    else:
                        user_out.setdefault(uid, []).append(m)
            if s.shadow is not None:
                # shadow responses: warmup re-decodes of the overlap are
                # dropped; anything ENDING past the boundary is the true
                # continuation — withheld until the handover so ordering
                # is preserved even when a backlogged shadow outruns the
                # primary's drain
                sresp = out.pop(s.shadow, None)
                if sresp is not None:
                    for m in _msgs(sresp):
                        if _is_eos(m):
                            continue
                        if _end_secs(m) > boundary_secs + 1e-9:
                            s.buf.append(m)
                # hand over once the primary has consumed through the
                # boundary (its EOS implies that: it only ever holds audio
                # up to the boundary)
                if primary_eos or (
                    self.eng.lane_frames(s.primary) >= boundary_frames
                ):
                    if not primary_eos:
                        self.eng.close_stream(s.primary)
                        s.retiring.append((s.primary, True))
                    # (on EOS the engine already released the lane)
                    s.primary = s.shadow
                    s.shadow = None
                    s.seg_k += 1
                    if s.buf:
                        user_out.setdefault(uid, []).extend(s.buf)
                        s.buf = []
                    if s.closed:
                        # user already hung up: flush the tail and finish
                        self.eng.close_stream(s.primary)
            elif primary_eos and s.closed:
                user_out.setdefault(uid, []).append({"eos": True})
                done.append(uid)
        for uid in done:
            self.streams[uid].primary = -1  # drained; only retirees remain
        for uid, s in list(self.streams.items()):
            if s.closed and s.primary == -1 and not s.retiring:
                del self.streams[uid]
        return {
            uid: (msgs if len(msgs) > 1 else msgs[0])
            for uid, msgs in user_out.items()
        }


def _msgs(resp) -> List[object]:
    return resp if isinstance(resp, list) else [resp]


def _is_eos(m) -> bool:
    return isinstance(m, dict) and bool(m.get("eos"))


def _end_secs(m) -> float:
    """Response end time: dict (Python path) or pre-serialized JSON string
    (native serializer). Parsing only happens for shadow-lane messages
    inside overlap windows — a tiny slice of total traffic."""
    if isinstance(m, str):
        import json

        m = json.loads(m)
    return float(m.get("end", 0.0))


