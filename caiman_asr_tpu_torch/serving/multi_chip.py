"""Serving over several cards: one ``StreamingEngine`` per torch device
behind one router (the port of ``caiman_asr_tpu/serving/multi_chip.py``).

Streaming lanes share no computation, so the unit of scale-out is a whole
engine pinned to one device, with its own weights, state, native staging and
serializer, and CUDA graph; there is no collective. The router only

  - allocates lanes, least-loaded engine first, so the cards stay balanced;
  - maps global stream ids to (engine, lane): gid = chip * per_chip + lane;
  - fans ``tick()`` out over a thread pool when there is more than one
    engine (each engine replays its graph on its own stream, so the host
    work of one engine overlaps the device work of another);
  - merges the engines' responses under global ids.

Each engine's tick is captured serially (``warmup()``, or the first tick):
a CUDA graph capture made while another thread launches work on the card
fails under the default global capture mode, so no two captures, and no
capture and replay, overlap. The replays then run concurrently. The server
drives this through the engine's duck-typed interface
(``serving/server.py --num_chips``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from caiman_asr_tpu_torch.serving.engine import StreamingEngine, WireTick


class _StreamsView:
    """Lazy merged view of the per-engine stream dicts under global ids."""

    __slots__ = ("_mc",)

    def __init__(self, mc: "MultiChipEngine"):
        self._mc = mc

    def __bool__(self):
        return any(e.streams for e in self._mc.engines)

    def __contains__(self, gid):
        chip, lane = divmod(int(gid), self._mc.per_chip)
        if not 0 <= chip < len(self._mc.engines):
            return False
        return lane in self._mc.engines[chip].streams

    def __len__(self):
        return sum(len(e.streams) for e in self._mc.engines)

    def __iter__(self):
        for i, e in enumerate(self._mc.engines):
            off = i * self._mc.per_chip
            for lane in e.streams:
                yield off + lane

    def __getitem__(self, gid):
        chip, lane = divmod(int(gid), self._mc.per_chip)
        return self._mc.engines[chip].streams[lane]

    def items(self):
        for i, e in enumerate(self._mc.engines):
            off = i * self._mc.per_chip
            for lane, st in e.streams.items():
                yield off + lane, st

    def keys(self):
        return iter(self)


def _merge(results: list, per_chip: int):
    """Per-engine tick results (dicts, or ``WireTick``s in wire mode) under
    global ids. A wire tick's index is already the tick's own copy, so its
    lane column is globalised in place."""
    if results and isinstance(results[0], WireTick):
        segments, specials = [], {}
        for i, r in enumerate(results):
            off = i * per_chip
            for raw, idx in r.segments:
                if off:
                    idx[:, 0] += off
                segments.append((raw, idx))
            for lane, msgs in r.specials.items():
                specials[off + lane] = msgs
        return WireTick(segments, specials)
    out: Dict[int, object] = {}
    for i, r in enumerate(results):
        off = i * per_chip
        for lane, resp in r.items():
            out[off + lane] = resp
    return out


class MultiChipEngine:
    """A ``StreamingEngine`` stand-in spanning several devices.

    Exposes what the server and clients use (open_stream / close_stream /
    push_audio / push_audio_block / lane_frames / set_lane_frame_base /
    tick / poll / warmup / streams / close) with lane ids global across
    engines. ``devices``: torch devices, one engine each (default: every
    visible card; the same card may appear twice); ``model``'s weights may
    live on any device of the same type, each engine keeps its own copy on
    its device. ``engine_kw`` go to every ``StreamingEngine``.
    """

    def __init__(
        self,
        model,
        blank_idx: int,
        tokenizer,
        devices=None,
        max_streams_per_chip: int = 64,
        **engine_kw,
    ):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("MultiChipEngine needs at least one device")
        self.devices = devices
        self.per_chip = max_streams_per_chip
        self.engines: List[StreamingEngine] = [
            StreamingEngine(model, blank_idx, tokenizer, max_streams=max_streams_per_chip,
                            device=d, **engine_kw)
            for d in devices
        ]
        self._warm = False
        self._pool = (ThreadPoolExecutor(max_workers=len(devices),
                                         thread_name_prefix="chip-tick")
                      if len(devices) > 1 else None)

    # ------------------------------------------------------------ properties
    @property
    def n_chips(self) -> int:
        return len(self.engines)

    @property
    def B(self) -> int:
        """Total lane capacity across engines."""
        return self.per_chip * len(self.engines)

    @property
    def hop_samples(self) -> int:
        """Samples a lane consumes a tick (the server's flood guard)."""
        return self.engines[0].hop_samples

    @property
    def streams(self) -> _StreamsView:
        """Live streams keyed by global id, a lazy read-only view."""
        return _StreamsView(self)

    def _split(self, gid: int):
        chip, lane = divmod(int(gid), self.per_chip)
        return self.engines[chip], lane

    # ------------------------------------------------------------- lifecycle
    def warmup(self):
        """Warm up and capture every engine's tick, one engine after another."""
        for e in self.engines:
            e.warmup()
        self._warm = True

    def close(self):
        for e in self.engines:
            e.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # --------------------------------------------------------------- streams
    def open_stream(self) -> Optional[int]:
        """Allocate a lane on the least-loaded engine; returns a global id."""
        order = sorted(range(len(self.engines)), key=lambda i: len(self.engines[i].streams))
        for i in order:
            lane = self.engines[i].open_stream()
            if lane is not None:
                return i * self.per_chip + lane
        return None

    def close_stream(self, gid: int):
        eng, lane = self._split(gid)
        eng.close_stream(lane)

    def push_audio(self, gid: int, samples: np.ndarray):
        eng, lane = self._split(gid)
        eng.push_audio(lane, samples)

    def lane_frames(self, gid: int) -> int:
        eng, lane = self._split(gid)
        return eng.lane_frames(lane)

    def set_lane_frame_base(self, gid: int, frames: int):
        eng, lane = self._split(gid)
        eng.set_lane_frame_base(lane, frames)

    def push_audio_block(self, block: np.ndarray, lanes=None):
        """Row i of ``block`` goes to global id ``lanes[i]`` (global lane i
        when None). Rows are regrouped per engine, so each engine still gets
        one batched native call."""
        gids = np.arange(block.shape[0]) if lanes is None else np.asarray(lanes)
        chips = gids // self.per_chip
        for c in np.unique(chips):
            sel = np.flatnonzero(chips == c)
            self.engines[int(c)].push_audio_block(np.ascontiguousarray(block[sel]),
                                                  (gids[sel] % self.per_chip).astype(np.int32))

    # ------------------------------------------------------------------ tick
    def tick(self):
        """Advance every engine (concurrently when there are several) and
        merge the responses under global ids. The first tick captures every
        engine's tick first, serially."""
        if not self._warm:
            self.warmup()
        if self._pool is not None:
            results = list(self._pool.map(lambda e: e.tick(), self.engines))
        else:
            results = [self.engines[0].tick()]
        return _merge(results, self.per_chip)

    def poll(self):
        """Drain every engine's finished in-flight ticks without advancing
        lanes (``StreamingEngine.poll``, globalised)."""
        return _merge([e.poll() for e in self.engines], self.per_chip)
