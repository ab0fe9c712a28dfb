"""Client-side user-perceived latency (UPL) primitives (the port of
``caiman_asr_tpu/latency/client.py``).

UPL is when a word FIRST became continuously visible on the user's screen
(reference latency/client.py:1-67, docs/src/inference/
user_perceived_latency.md): a partial that is later overwritten does not
count, but a partial whose prefix survives into the final does — the
surviving characters were visible from that partial's arrival.

A live probe (the JAX package's scripts/measure_upl.py) streams audio to
the WebSocket server in real time, records each response's wall-clock
arrival, fuses partials/finals into per-word first-visible times here, and
differences them against ground-truth word end times (forced-alignment CTM)
to get per-word UPL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class ServerResponse:
    """One transcript message and its wall-clock arrival (seconds from
    stream start)."""

    text: str
    timestamp: float
    is_partial: bool


def fuse_timestamps(
    responses: List[ServerResponse],
) -> List[Tuple[str, float]]:
    """Per-character first-continuously-visible times.

    Finals commit characters; each committed character's time is the arrival
    of the OLDEST partial from which that character was visible without
    interruption (scanning newest -> oldest: a partial too short to cover
    the position is skipped, a disagreeing partial stops the scan — the
    character flickered there, so visibility restarts after it). Partials
    longer than the final they absorb keep their uncommitted tail (with the
    original arrival time) for the next final. Matches reference
    latency/client.py:17-45 behaviour.
    """
    out: List[Tuple[str, float]] = []
    pending: List[Tuple[str, float]] = []  # live partials, oldest first

    for r in responses:
        if r.is_partial:
            pending.append((r.text, r.timestamp))
            continue
        for i, ch in enumerate(r.text):
            first_seen = r.timestamp
            for text, at in reversed(pending):
                if i >= len(text):
                    continue  # too short to show this position; keep looking
                if text[i] != ch:
                    break  # flicker: visibility chain ends here
                first_seen = at
            out.append((ch, first_seen))
        # carry over the tails of partials that outran this final
        pending = [
            (text[len(r.text):], at)
            for text, at in pending
            if len(text) > len(r.text)
        ]
    return out


def get_word_timestamps(
    responses: List[ServerResponse],
) -> List[Tuple[str, float]]:
    """Fuse to characters, then split on spaces; a word's time is the
    latest first-visible time among its characters (the word is only fully
    readable once its last-arriving character shows)."""
    words: List[Tuple[str, float]] = []
    word, at = "", 0.0
    for ch, t in fuse_timestamps(responses):
        if ch == " ":
            if word:
                words.append((word, at))
            word, at = "", 0.0
        else:
            word += ch
            at = max(at, t)
    if word:
        words.append((word, at))
    return words
