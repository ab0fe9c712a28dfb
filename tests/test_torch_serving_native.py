"""The port's own build of the serving C++ (``caiman_asr_tpu_torch/native``)
against the JAX package's (``caiman_asr_tpu/native``): the same calls on
the same random inputs give byte-identical JSON and identical staging,
tick after tick. The port never loads the JAX package's library."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from caiman_asr_tpu.native import AudioStaging as JaxStaging
from caiman_asr_tpu.native import ResponseSerializer as JaxSerializer
from caiman_asr_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]
TICKS = 240
PIECES = ["", "▁he", "llo", '"\\', "\n", "▁", "ü", "▁wörld", "\t", "日本", "a" * 40, "▁x"]


def test_serializer_fuzz_is_byte_identical():
    B, cap = 6, 5
    rng = np.random.default_rng(0)
    pieces = PIECES + [f"▁p{i}" for i in range(20)]
    ours = native.ResponseSerializer(B, 0.06, pieces)
    ref = JaxSerializer(B, 1, 1, 0.06, pieces)
    for t in range(TICKS):
        packed = rng.integers(0, len(pieces), size=(B, cap + 1)).astype(np.int32)
        packed[:, -1] = rng.integers(0, cap + 1, size=B)
        adv = rng.random(B) < 0.7
        for lane in np.flatnonzero(rng.random(B) < 0.05):
            ours.reset_lane(int(lane))
            ref.reset_lane(int(lane))
        if t % 37 == 5:
            lane, base = int(rng.integers(B)), int(rng.integers(0, 10_000))
            ours.set_frame_idx(lane, base)
            ref.set_frame_idx(lane, base)
        raw, idx = ours.greedy_tick_raw(packed, adv)
        want_raw, want_idx = ref.greedy_tick_raw(packed, adv)
        assert raw == want_raw
        np.testing.assert_array_equal(idx, want_idx)
        assert [ours.frame_idx(i) for i in range(B)] == [ref.frame_idx(i) for i in range(B)]
    assert ours.greedy_tick(packed, adv) == ref.greedy_tick(packed, adv)
    ours.close()
    with pytest.raises(ValueError, match="after close"):
        ours.frame_idx(0)
    ref.close()


class _BeamLanes:
    """A model of ser_beam_tick's commit state a lane (history, committed
    horizon, frame index) and of the records it emits, as (lane, text,
    is_provisional). ``oob_lanes`` names the lanes whose last row slid
    agreement past positions no row carried: there the JAX package's build
    reads its history out of bounds (or its zero padding), and the port
    emits only the positions it has seen."""

    def __init__(self, B: int, W: int, win: int, pieces):
        self.W, self.win = W, win
        self.text = [p.replace("▁", " ") for p in pieces]
        self.lanes = [self._fresh() for _ in range(B)]

    @staticmethod
    def _fresh():
        return {"hist": [], "committed": 0, "frame_idx": 0}

    def reset_lane(self, lane: int):
        self.lanes[lane] = self._fresh()

    def _text(self, ids):
        return "".join(self.text[i] if 0 <= i < len(self.text) else "" for i in ids)

    def tick(self, packed: np.ndarray, adv: np.ndarray):
        W, win = self.W, self.win
        records, oob_lanes = [], []
        for b in np.flatnonzero(adv):
            ln, row = self.lanes[b], packed[b]
            toks = row[: W * win].reshape(W, win)
            lens = row[W * win: W * win + W].astype(np.int64)
            base, echo = int(row[W * win + W]), int(row[W * win + W + 1])
            scores = row[W * win + W + 2:].view(np.float32)
            if echo > 0:
                ln["committed"] = max(ln["committed"] - echo, 0)
                ln["hist"] = ln["hist"][echo:]
            alive = scores > -1e29
            if not alive.any():
                ln["frame_idx"] += 1
                continue
            norm = [scores[w] / max(int(lens[w]) + 1, 1) if alive[w] else -np.inf
                    for w in range(W)]
            best = int(np.argmax(norm))
            blen, bt = int(lens[best]), toks[best]
            seen = len(ln["hist"])
            ln["hist"] += [0] * max(blen - seen, 0)
            for i in range(base, blen):
                ln["hist"][i] = int(bt[i - base])
            if ln["committed"] < base:
                if base > seen:
                    oob_lanes.append(int(b))
                upto = min(base, seen)
                if upto > ln["committed"]:
                    records.append((int(b), self._text(ln["hist"][ln["committed"]:upto]),
                                    False))
                ln["committed"] = base
            p = ln["committed"]
            min_len = int(lens[alive].min())
            if min_len > p:
                j = p - base
                while j < min_len - base and (toks[alive, j] == bt[j]).all():
                    j += 1
                p = base + j
            if p > ln["committed"]:
                records.append((int(b), self._text(bt[ln["committed"] - base: p - base]),
                                False))
                ln["committed"] = p
            if blen > p:
                records.append((int(b), self._text(bt[p - base: blen - base]), True))
            ln["frame_idx"] += 1
        return records, oob_lanes


def _fields(rec: str):
    """(transcript, is_provisional) of one record's JSON."""
    d = json.loads(rec)
    return d["alternatives"][0]["transcript"], d["is_provisional"]


def _records(raw: bytes, idx: np.ndarray):
    """(lane, text, is_provisional) of each record of a beam tick."""
    return [(lane, *_fields(raw[off:off + n].decode("utf-8"))) for lane, off, n in idx.tolist()]


def _by_lane(raw: bytes, idx: np.ndarray):
    """Each lane's records of a tick, as the raw JSON bytes in order."""
    out = {}
    for lane, off, n in idx.tolist():
        out.setdefault(lane, []).append(raw[off:off + n])
    return out


@pytest.mark.parametrize("W,win", [(1, 2), (3, 8), (4, 16)])
@pytest.mark.parametrize("repeat", range(3))
def test_beam_serializer_fuzz_is_byte_identical(W, win, repeat):
    """ser_beam_tick on random windows: hypotheses agreeing on a random
    prefix, dead ones (scores below -1e29), bases that slide past the
    committed horizon, rebase echoes, lane resets. Every tick's records
    equal the lane model's; dev_len and the commit state equal the JAX
    package's build's; each lane's JSON equals that build's byte for byte
    except on a lane whose agreement slid past positions the host has seen
    (where that build reads its history out of bounds), and on a tick with
    no such lane the whole buffer and index do, through the raw and the
    parsed calls. Each width runs several times in one process: the result
    must not depend on what ran before."""
    B = 5
    rng = np.random.default_rng(W)
    pieces = PIECES + [f"▁p{i}" for i in range(20)]
    ours = native.ResponseSerializer(B, 0.06, pieces, beam_width=W, beam_win=win)
    ref = JaxSerializer(B, W, win, 0.06, pieces)
    model = _BeamLanes(B, W, win, pieces)
    lens = np.zeros((B, W), np.int64)
    oob_ticks = parsed_ticks = 0
    for t in range(TICKS):
        lens = np.minimum(lens + rng.integers(0, 3, size=(B, W)), 10_000)
        toks = rng.integers(0, len(pieces), size=(B, W, win)).astype(np.int32)
        common = rng.integers(0, win + 1, size=B)
        for b in range(B):
            toks[b, :, :common[b]] = toks[b, 0, :common[b]]
        base = np.maximum(lens.max(axis=1) - win, 0)
        echo = np.where(rng.random(B) < 0.05, rng.integers(1, 4, size=B), 0)
        scores = rng.normal(size=(B, W)).astype(np.float32) * 3 - 5
        scores[rng.random((B, W)) < 0.2] = -1e30
        packed = np.concatenate([toks.reshape(B, -1), lens.astype(np.int32), base[:, None],
                                 echo[:, None], scores.view(np.int32)], axis=1).astype(np.int32)
        adv = rng.random(B) < 0.8
        for lane in np.flatnonzero(rng.random(B) < 0.03):
            ours.reset_lane(int(lane))
            ref.reset_lane(int(lane))
            model.reset_lane(int(lane))
            lens[lane] = 0
        want_records, oob_lanes = model.tick(packed, adv)
        if t % 8 == 7 and not oob_lanes:
            got, dev_len = ours.beam_tick(packed, adv)
            want, want_dev = ref.beam_tick(packed, adv)
            assert got == want
            assert [(lane, *_fields(r)) for lane, rs in got.items() for r in rs] == want_records
            parsed_ticks += 1
        else:
            raw, idx, dev_len = ours.beam_tick_raw(packed, adv)
            want_raw, want_idx, want_dev = ref.beam_tick_raw(packed, adv)
            assert _records(raw, idx) == want_records, t
            got, want = _by_lane(raw, idx), _by_lane(want_raw, want_idx)
            for lane in set(got) | set(want):
                if lane not in oob_lanes:
                    assert got.get(lane) == want.get(lane), (t, lane)
            if oob_lanes:
                oob_ticks += 1
            else:
                assert raw == want_raw
                np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(dev_len, want_dev)
        assert [ours.committed(i) for i in range(B)] == [ref.committed(i) for i in range(B)]
        assert [ours.committed(i) for i in range(B)] == [ln["committed"] for ln in model.lanes]
        assert [ours.frame_idx(i) for i in range(B)] == [ref.frame_idx(i) for i in range(B)]
    print(f"W={W}: {oob_ticks} of {TICKS} ticks slid past the history")
    assert 0 < oob_ticks < TICKS and parsed_ticks > 0
    assert sum(ours.committed(i) for i in range(B)) > 0
    ours.close()
    ref.close()


def test_beam_serializer_slides_only_over_seen_positions():
    """A lane is reset; a row commits one token and shows a second as a
    partial; then a row whose best live hypothesis (2 tokens) is shorter
    than the window's base (3). The slid-out final carries only the seen
    second token, nothing past the history; committed moves to the base,
    dev_len is the longest (dead) hypothesis."""
    W, win = 2, 4
    pieces = PIECES + [f"▁p{i}" for i in range(20)]
    ours = native.ResponseSerializer(1, 0.06, pieces, beam_width=W, beam_win=win)

    def row(toks, lens, base, scores):
        t = np.zeros((W, win), np.int32)
        for w, seq in enumerate(toks):
            t[w, :len(seq)] = seq
        return np.concatenate([t.ravel(), lens, [base, 0],
                               np.asarray(scores, np.float32).view(np.int32)]
                              ).astype(np.int32)[None]

    adv = np.ones(1, bool)
    ours.beam_tick_raw(row([[12, 13, 14], [12, 13, 14]], [3, 3], 0, [-1.0, -2.0]), adv)
    assert ours.committed(0) == 3
    ours.reset_lane(0)
    assert ours.committed(0) == 0
    raw, idx, _ = ours.beam_tick_raw(row([[12, 13], [12, 14]], [2, 2], 0, [-1.0, -2.0]), adv)
    assert _records(raw, idx) == [(0, " p0", False), (0, " p1", True)]
    assert ours.committed(0) == 1
    raw, idx, dev_len = ours.beam_tick_raw(
        row([[15, 16, 17, 18], [0, 0]], [7, 2], 3, [-1e30, -1.0]), adv)
    assert _records(raw, idx) == [(0, " p1", False)]
    assert ours.committed(0) == 3
    assert int(dev_len[0]) == 7
    assert ours.frame_idx(0) == 2  # the reset restarted its clock
    ours.close()


def test_beam_serializer_refuses_a_beam_past_64():
    with pytest.raises(ValueError, match="refused"):
        native.ResponseSerializer(2, 0.06, ["a"], beam_width=65, beam_win=4)


def test_serializer_grows_its_buffer():
    B = 1024
    pieces = ["x" * 600] * 8
    ours = native.ResponseSerializer(B, 0.06, pieces)
    ref = JaxSerializer(B, 1, 1, 0.06, pieces)
    packed = np.zeros((B, 9), np.int32)
    packed[:, -1] = 8  # 1,024 lanes x 8 x 600 bytes: past the first 4 MiB
    adv = np.ones(B, bool)
    raw, idx = ours.greedy_tick_raw(packed, adv)
    want_raw, want_idx = ref.greedy_tick_raw(packed, adv)
    assert len(raw) > 4 << 20
    assert raw == want_raw
    np.testing.assert_array_equal(idx, want_idx)


def test_staging_fuzz_is_identical():
    B, hop = 5, 960
    rng = np.random.default_rng(1)
    ours, ref = native.AudioStaging(B, 0, hop), JaxStaging(B, 0, hop)
    for t in range(TICKS):
        for lane in range(B):
            r = rng.random()
            if r < 0.4:
                x = rng.integers(-32768, 32768, size=int(rng.integers(0, 2500))).astype(np.int16)
            elif r < 0.6:
                x = (rng.normal(size=int(rng.integers(0, 1500))) * 0.3).astype(np.float32)
            else:
                continue
            ours.push(lane, x)
            ref.push(lane, x)
        if t % 11 == 3:
            block = rng.integers(-32768, 32768, size=(3, 700)).astype(np.int16)
            lanes = rng.choice(B, size=3, replace=False)
            ours.push_rows(block, lanes)
            ref.push_rows(block, lanes)
        if t % 13 == 7:
            block = (rng.normal(size=(B, 333)) * 0.2).astype(np.float32)
            ours.push_rows(block)
            ref.push_rows(block)
        if t % 17 == 9:
            lane = int(rng.integers(B))
            ours.reset_lane(lane)
            ref.reset_lane(lane)
        active = (rng.random(B) < 0.9).astype(np.uint8)
        closed = (rng.random(B) < 0.1).astype(np.uint8)
        got_s = np.full((B, hop), 7, np.int16)
        want_s = np.full((B, hop), 7, np.int16)
        got = ours.tick(got_s, active, closed)
        want = ref.tick(want_s, active, closed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got_s, want_s)
        assert [ours.buffered(i) for i in range(B)] == [ref.buffered(i) for i in range(B)]
    ours.close()
    ref.close()


_PROBE = r"""
import numpy as np
from caiman_asr_tpu_torch import native
s = native.ResponseSerializer(2, 0.06, ["a", ""])
s.greedy_tick(np.array([[0, 1], [0, 0]], np.int32), np.array([1, 1], bool))
maps = open("/proc/self/maps").read()
print("libcaiman_serving.so" in maps, "libcaiman_native" in maps)
"""


def test_the_port_loads_its_own_build_only():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False"]
    assert native.LIB == REPO / "build" / "native" / "libcaiman_serving.so"
