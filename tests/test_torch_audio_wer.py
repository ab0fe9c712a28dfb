"""The port's audio reader, FLAC decoder, edit distance, WER and manifest
reader against the JAX package's: results equal exactly, resampled audio
within 1e-7. FLAC comes from the verbatim encoder of
tests/native/test_native.py."""

import dataclasses
import importlib.util
import json
import wave
from pathlib import Path

import numpy as np
import pytest

from caiman_asr_tpu.data import audio as jax_audio
from caiman_asr_tpu.data import manifest as jax_manifest
from caiman_asr_tpu.evaluate import wer as jax_wer
from caiman_asr_tpu.native import flac_decode as jax_flac_decode
from caiman_asr_tpu.native import levenshtein as jax_levenshtein
from caiman_asr_tpu_torch import native
from caiman_asr_tpu_torch.data import audio, manifest
from caiman_asr_tpu_torch.evaluate import wer

_spec = importlib.util.spec_from_file_location(
    "native_tests", Path(__file__).parent / "native" / "test_native.py")
_native_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_native_tests)
encode_flac_verbatim = _native_tests.encode_flac_verbatim


def _write_wav(path, data: np.ndarray, width: int, sr: int, channels: int = 1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return path


def _pcm(seed, n, width, channels=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, size=(n, channels))
    if width == 1:
        return np.clip(np.rint(x * 127 + 128), 0, 255).astype(np.uint8)
    if width == 2:
        return np.rint(x * 32767).astype("<i2")
    return np.rint(x * 2147483647).astype("<i4")


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr", [16000, 8000, 22050])
def test_read_wav_matches_jax(tmp_path, width, channels, sr):
    path = _write_wav(tmp_path / "a.wav", _pcm(width * 10 + channels, 3001, width, channels),
                      width, sr, channels)
    got, want = audio.read_audio(path), jax_audio.read_audio(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if sr == 16000:
        np.testing.assert_array_equal(got, want)
    else:  # resampled
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert abs(len(got) - 3001 * 16000 / sr) <= 1


def test_read_npy_matches_jax(tmp_path):
    path = tmp_path / "a.npy"
    np.save(path, np.random.default_rng(1).normal(size=1234))
    np.testing.assert_array_equal(audio.read_audio(path), jax_audio.read_audio(path))


@pytest.mark.parametrize("n", [15, 4096, 10000])  # one block, one whole, a tail
def test_read_flac_matches_jax(tmp_path, n):
    x = np.random.default_rng(n).integers(-32768, 32768, size=n).astype(np.int16)
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac_verbatim(x))
    got = audio.read_audio(path)
    np.testing.assert_array_equal(got, jax_audio.read_audio(path))
    np.testing.assert_array_equal(got, x.astype(np.float32) / 32768.0)


def test_other_formats_raise(tmp_path):
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\x00" * 16)
    with pytest.raises(RuntimeError, match="Cannot decode"):
        audio.read_audio(path)


def test_resample_matches_jax():
    x = np.random.default_rng(2).normal(size=4410).astype(np.float32)
    np.testing.assert_allclose(audio.resample(x, 44100, 16000),
                               jax_audio.resample(x, 44100, 16000), rtol=0, atol=1e-7)


def test_flac_decode_matches_jax():
    x = np.random.default_rng(3).integers(-32768, 32768, size=9000).astype(np.int16)
    data = encode_flac_verbatim(x, sample_rate=8000)
    got, want = native.flac_decode(data), jax_flac_decode(data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (8000, 16, got[3])
    np.testing.assert_array_equal(got[0][:, 0], x)


@pytest.mark.parametrize("data", [
    b"", b"garbage", b"fLaC" + b"\x00" * 10, b"fLaC\x80\x00\x00\x22" + b"\xff" * 40,
    encode_flac_verbatim(np.zeros(1, np.int16)),  # a one-sample block both refuse
])
def test_flac_decode_rejects_garbage(data):
    for decode in (native.flac_decode, jax_flac_decode):
        with pytest.raises(ValueError, match="FLAC decode failed"):
            decode(data)


def test_levenshtein_matches_jax_and_the_plain_version():
    rng = np.random.default_rng(4)
    for _ in range(60):
        a = rng.integers(0, 5, size=int(rng.integers(0, 12))).tolist()
        b = rng.integers(0, 5, size=int(rng.integers(0, 12))).tolist()
        d = native.levenshtein(a, b)
        assert d == jax_levenshtein(a, b) == wer.levenshtein_plain(a, b)
        words_a, words_b = [f"w{i}" for i in a], [f"w{i}" for i in b]
        assert wer.levenshtein(words_a, words_b) == d == jax_wer.levenshtein(words_a, words_b)


@pytest.mark.parametrize("kind", ["WORD", "CHAR", "MIXTURE"])
@pytest.mark.parametrize("standardize", [False, True])
def test_word_error_rate_matches_jax(kind, standardize):
    hyps = ["the cat sat on the mat", "Mr. Smith won't pay $5", "你好 world", "", "a b c"]
    refs = ["the cat sat on a mat", "mister smith will not pay five dollars", "你们好 world",
            "nothing heard", "a b c"]
    got = wer.word_error_rate(hyps, refs, standardize, getattr(wer.ErrorRateKind, kind))
    want = jax_wer.word_error_rate(hyps, refs, standardize, getattr(jax_wer.ErrorRateKind, kind))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.scores > 0


def _manifest(tmp_path):
    entries = [
        {"transcript": "short one", "files": [{"fname": "a.wav"}], "original_duration": 0.5},
        {"transcript": "a medium utterance", "files": [{"fname": "b.flac", "duration": 3.0}],
         "original_duration": None},
        {"transcript": "x" * 50, "files": [{"fname": "sub/c.wav"}], "original_duration": 9.0},
        {"transcript": "too long", "files": [{"fname": "d.wav"}], "original_duration": 30.0},
    ]
    path = tmp_path / "m.json"
    path.write_text(json.dumps(entries))
    return path


@pytest.mark.parametrize("filters", [
    {}, {"max_duration": 10.0}, {"min_duration": 1.0, "max_transcript_len": 20},
    {"data_dir": "/data"}])
def test_load_manifest_matches_jax(tmp_path, filters):
    path = _manifest(tmp_path)
    got = [dataclasses.astuple(u) for u in manifest.load_manifest(path, **filters)]
    want = [dataclasses.astuple(u) for u in jax_manifest.load_manifest(path, **filters)]
    assert got == want and got
    both = manifest.load_manifests([path, path], max_duration=10.0)
    assert [dataclasses.astuple(u) for u in both] == [
        dataclasses.astuple(u) for u in jax_manifest.load_manifests([path, path],
                                                                    max_duration=10.0)]
    assert {u.manifest_idx for u in both} == {0, 1}


def test_utterances_from_dir_matches_jax(tmp_path):
    _write_wav(tmp_path / "a.wav", _pcm(5, 8000, 2), 2, 16000)
    (tmp_path / "a.txt").write_text("first one\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.flac").write_bytes(encode_flac_verbatim(
        _pcm(6, 12000, 2)[:, 0]))
    (tmp_path / "sub" / "b.txt").write_text("second")
    _write_wav(tmp_path / "c.wav", _pcm(7, 100, 2), 2, 16000)  # no transcript: skipped
    with pytest.warns(UserWarning):
        got = manifest.utterances_from_dir(tmp_path)
    with pytest.warns(UserWarning):
        want = jax_manifest.utterances_from_dir(tmp_path)
    assert [dataclasses.astuple(u) for u in got] == [dataclasses.astuple(u) for u in want]
    assert [u.duration for u in got] == [0.5, 0.75]
