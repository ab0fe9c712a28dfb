"""The port's own build of the serving C++ (``caiman_asr_tpu_torch/native``)
against the JAX package's (``caiman_asr_tpu/native``): the same calls on
the same random inputs give byte-identical JSON and identical staging,
tick after tick. The port never loads the JAX package's library."""

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


@pytest.mark.parametrize("W,win", [(1, 2), (3, 8), (4, 16)])
def test_beam_serializer_fuzz_is_byte_identical(W, win):
    """ser_beam_tick on random windows: hypotheses agreeing on a random
    prefix, dead ones (scores below -1e29), bases that slide past the
    committed horizon, rebase echoes, lane resets. The same JSON, records,
    dev_len and commit state as the JAX package's build."""
    B = 5
    rng = np.random.default_rng(W)
    pieces = PIECES + [f"▁p{i}" for i in range(20)]
    ours = native.ResponseSerializer(B, 0.06, pieces, beam_width=W, beam_win=win)
    ref = JaxSerializer(B, W, win, 0.06, pieces)
    lens = np.zeros((B, W), np.int64)
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
            lens[lane] = 0
        raw, idx, dev_len = ours.beam_tick_raw(packed, adv)
        want_raw, want_idx, want_dev = ref.beam_tick_raw(packed, adv)
        assert raw == want_raw
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(dev_len, want_dev)
        assert [ours.committed(i) for i in range(B)] == [ref.committed(i) for i in range(B)]
        assert [ours.frame_idx(i) for i in range(B)] == [ref.frame_idx(i) for i in range(B)]
    assert ours.beam_tick(packed, adv)[0] == ref.beam_tick(packed, adv)[0]
    assert sum(ours.committed(i) for i in range(B)) > 0
    ours.close()
    ref.close()


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
