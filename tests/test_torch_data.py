"""The port's host data path against the JAX package's, on the same seeded
inputs: transcript normalisation (identical strings), the audio
augmentations (the same ``rng``, to atol 1e-6), the samplers (identical
batches, index for index) and the host loader (bit-identical batches, over
WAV and FLAC files, with and without the train augmentations)."""

import importlib.util
import json
import wave
from pathlib import Path

import numpy as np
import pytest

from caiman_asr_tpu.data import audio as jax_audio
from caiman_asr_tpu.data import loader as jax_loader
from caiman_asr_tpu.data import sampler as jax_sampler
from caiman_asr_tpu.data.manifest import load_manifest as jax_load_manifest
from caiman_asr_tpu.data.text import normalize as jax_norm
from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from caiman_asr_tpu.data.tokenizer import save_tokenizer_json, train_tokenizer
from caiman_asr_tpu.models.config import load_config as jax_load_config
from caiman_asr_tpu_torch.data import audio, loader, sampler
from caiman_asr_tpu_torch.data.manifest import load_manifest
from caiman_asr_tpu_torch.data.text import normalize
from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
from caiman_asr_tpu_torch.models.config import load_config

REPO = Path(__file__).resolve().parents[1]
AUG_ATOL = 1e-6
CHARSET = list(" abcdefghijklmnopqrstuvwxyz'")

_spec = importlib.util.spec_from_file_location(
    "native_tests", Path(__file__).parent / "native" / "test_native.py")
_native_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_native_tests)
encode_flac_verbatim = _native_tests.encode_flac_verbatim

TEXTS = [
    "Hello, World! <unk> It's 3 o'clock <EOS>",
    "Café naïve résumé — ÜBER straße <b>bold</b> [noise] (aside)",
    "  multiple   spaces\tand\nnewlines  ",
    "Numbers: 1st 22nd 1,000 $5.50 12:30 3.14 <EOS> end",
    "ALL CAPS <EOS><EOS> trailing",
    "日本語 mixed ascii 42",
    "",
]
REPLACEMENTS = [{"old": "o'clock", "new": "oclock"}, {"old": r"\bIt's\b", "new": "it is"}]


@pytest.mark.parametrize("level", list(jax_norm.NormalizeLevel), ids=lambda v: v.name)
@pytest.mark.parametrize("tags", [True, False])
@pytest.mark.parametrize("replacements", [(), REPLACEMENTS], ids=["plain", "replace"])
@pytest.mark.parametrize("numbers", [True, False])
def test_normalize_transcript_matches_jax(level, tags, replacements, numbers):
    jcfg = jax_norm.NormalizeConfig(level=level, replacements=replacements, remove_tags=tags,
                                    user_symbols=("<EOS>",), verbalize_numbers=numbers)
    tcfg = normalize.NormalizeConfig(level=normalize.NormalizeLevel[level.name],
                                     replacements=replacements, remove_tags=tags,
                                     user_symbols=("<EOS>",), verbalize_numbers=numbers)
    for text in TEXTS:
        assert (normalize.normalize_transcript(text, CHARSET, tcfg)
                == jax_norm.normalize_transcript(text, CHARSET, jcfg)), text


def test_normalize_defaults_and_ascii_fold_match_jax():
    for text in TEXTS:
        assert normalize._ascii_fold(text) == jax_norm._ascii_fold(text)
        assert (normalize.normalize_transcript(text, CHARSET)
                == jax_norm.normalize_transcript(text, CHARSET))


def _signal(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("rate", [0.85, 0.9, 1.0, 1.07, 1.15, 1.0 + 1e-4])
def test_speed_perturb_matches_jax(rate):
    x = _signal(1, 12345)
    got, want = audio.speed_perturb(x, rate), jax_audio.speed_perturb(x, rate)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=AUG_ATOL, rtol=0)


@pytest.mark.parametrize("sr", [16000, 8000, 22050])
def test_narrowband_resim_matches_jax(sr):
    x = _signal(2, 9001)
    got, want = audio.narrowband_resim(x, sr), jax_audio.narrowband_resim(x, sr)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=AUG_ATOL, rtol=0)


@pytest.mark.parametrize("cutoff", [-60.0, -20.0, -6.0])
def test_trim_silence_matches_jax(cutoff):
    x = np.concatenate([np.zeros(3000, np.float32), _signal(3, 5000),
                        1e-5 * np.ones(2000, np.float32)])
    for sig in (x, np.zeros(100, np.float32), np.zeros(0, np.float32)):
        np.testing.assert_array_equal(audio.trim_silence(sig, cutoff),
                                      jax_audio.trim_silence(sig, cutoff))


@pytest.mark.parametrize("snr", [-5.0, 10.0, 40.0])
def test_noise_and_babble_match_jax(snr):
    x, noise = _signal(4, 7000), _signal(5, 2500)
    for start in (0.0, 0.3, 0.99):
        got = audio.blend_noise(np.random.default_rng(0), x, noise, snr, start)
        want = jax_audio.blend_noise(np.random.default_rng(0), x, noise, snr, start)
        np.testing.assert_allclose(got, want, atol=AUG_ATOL, rtol=0)
    batch = [_signal(s, 3000 + 500 * s) for s in range(4)]
    got = audio.babble_batch(np.random.default_rng(7), batch, snr)
    want = jax_audio.babble_batch(np.random.default_rng(7), batch, snr)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=AUG_ATOL, rtol=0)


DURATIONS = np.random.default_rng(11).uniform(0.5, 20.0, size=103)
MANIFEST_IDS = np.random.default_rng(12).integers(0, 3, size=103)
SAMPLERS = {
    "simple": lambda m, **kw: m.SimpleSampler(DURATIONS, **kw),
    "sorted": lambda m, **kw: m.SortedSampler(DURATIONS, **kw),
    "random": lambda m, **kw: m.RandomSampler(DURATIONS, **kw),
    "bucketing": lambda m, **kw: m.BucketingSampler(DURATIONS, num_buckets=3, **kw),
    "bucketing0": lambda m, **kw: m.BucketingSampler(DURATIONS, num_buckets=0, **kw),
    "weighted": lambda m, **kw: m.WeightedBucketingSampler(DURATIONS, MANIFEST_IDS, **kw),
    "absolute": lambda m, **kw: m.WeightedBucketingSampler(
        DURATIONS, MANIFEST_IDS, absolute_ratios=[1, 2, 3], **kw),
    "relative": lambda m, **kw: m.WeightedBucketingSampler(
        DURATIONS, MANIFEST_IDS, relative_ratios=[0.5, 1.5, 2.25], **kw),
    "canary": lambda m, **kw: m.WeightedBucketingSampler(
        DURATIONS, MANIFEST_IDS, canary_exponent=0.5, **kw),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("world_size", [1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_samplers_match_jax(name, world_size, drop_last):
    kw = dict(batch_size=4, world_size=world_size, seed=5, drop_last=drop_last,
              randomize_first_n_epochs=1)
    got, want = SAMPLERS[name](sampler, **kw), SAMPLERS[name](jax_sampler, **kw)
    for epoch in range(3):
        for resume in (0, 2):
            g, w = got.epoch_batches(epoch, resume), want.epoch_batches(epoch, resume)
            assert len(g) == len(w)
            for gb, wb in zip(g, w):
                np.testing.assert_array_equal(gb, wb)
                for rank in range(world_size):
                    np.testing.assert_array_equal(got.shard(gb, rank), want.shard(wb, rank))


def test_a_sampler_with_two_modes_raises_in_both():
    for m in (sampler, jax_sampler):
        with pytest.raises(ValueError):
            m.WeightedBucketingSampler(DURATIONS, MANIFEST_IDS, batch_size=2,
                                       absolute_ratios=[1, 1, 1], canary_exponent=0.5)


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten utterances, WAV and FLAC alternately, a manifest, a tokenizer."""
    root = tmp_path_factory.mktemp("loader")
    entries = []
    texts = ["the cat sat", "A dog <EOS> barks", "She sells 3 shells", "quick brown fox",
             "over the lazy dog", "hello world", "Testing, one two!", "café au lait",
             "long speech here", "the end"]
    for i, text in enumerate(texts):
        n = 4000 + 1700 * i
        x = _signal(20 + i, n)
        name = f"u{i}.wav" if i % 2 == 0 else f"u{i}.flac"
        if i % 2 == 0:
            _write_wav(root / name, x)
        else:
            (root / name).write_bytes(encode_flac_verbatim((x * 32767).astype(np.int16)))
        entries.append({"transcript": text, "files": [{"fname": name, "duration": n / 16000}],
                        "original_duration": n / 16000})
    (root / "m.json").write_text(json.dumps(entries))
    save_tokenizer_json(root / "tok.json", train_tokenizer([t.lower() for t in texts] * 3,
                                                            vocab_size=40,
                                                            user_symbols=("<EOS>",)))
    return root


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("narrowband", [0.0, 0.5])
def test_loader_batches_match_jax(corpus, train, narrowband):
    """Both loaders over the same utterances, sampler and seeds:
    bit-identical audio, lengths, tokens, transcripts and file names (in
    training with base-8703sp.yaml's speed perturbation and silence
    trimming, and token sampling)."""
    jcfg = jax_load_config(REPO / "configs" / "base-8703sp.yaml").cfg
    tcfg = load_config(REPO / "configs" / "base-8703sp.yaml")
    jpipe = jcfg.input_train if train else jcfg.input_val
    tpipe = tcfg.input_train if train else tcfg.input_val
    utts = load_manifest(corpus / "m.json")
    assert utts == [type(utts[0])(**vars(u)) for u in jax_load_manifest(corpus / "m.json")]
    norm_kw = dict(user_symbols=("<EOS>",))
    jl = jax_loader.AudioDataLoader(
        jax_load_manifest(corpus / "m.json"),
        jax_sampler.BucketingSampler([u.duration for u in utts], batch_size=3, seed=3,
                                     num_buckets=2, drop_last=False),
        JaxTokenizer(CHARSET, corpus / "tok.json", sampling=0.3 if train else 0.0, seed=9),
        jpipe, train=train, seed=4, num_workers=3, prob_narrowband=narrowband,
        normalize_config=jax_norm.NormalizeConfig(**norm_kw))
    tl = loader.AudioDataLoader(
        utts,
        sampler.BucketingSampler([u.duration for u in utts], batch_size=3, seed=3,
                                 num_buckets=2, drop_last=False),
        Tokenizer(CHARSET, corpus / "tok.json", sampling=0.3 if train else 0.0, seed=9),
        tpipe, train=train, seed=4, num_workers=3, prob_narrowband=narrowband,
        normalize_config=normalize.NormalizeConfig(**norm_kw))
    assert tl.max_samples == jl.max_samples
    assert tl.steps_per_epoch(1) == jl.steps_per_epoch(1)
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("audio", "audio_lens", "tokens", "token_lens"):
                a, b = getattr(g, key), getattr(w, key)
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b, err_msg=key)
            assert g.transcripts == w.transcripts
            assert g.fnames == w.fnames
    assert list(tl.epoch(0, resume_step=1))[0].fnames == list(jl.epoch(0, resume_step=1))[0].fnames


def test_loader_inspect_audio_writes_the_same_files(corpus, tmp_path):
    jcfg = jax_load_config(REPO / "configs" / "base-8703sp.yaml").cfg
    tcfg = load_config(REPO / "configs" / "base-8703sp.yaml")
    utts = load_manifest(corpus / "m.json")
    for name, mod, smod, tok, pipe in (
            ("jax", jax_loader, jax_sampler, JaxTokenizer, jcfg.input_val),
            ("port", loader, sampler, Tokenizer, tcfg.input_val)):
        ld = mod.AudioDataLoader(utts, smod.SimpleSampler([u.duration for u in utts], 4),
                                 tok(CHARSET, corpus / "tok.json"), pipe, train=False,
                                 inspect_audio_dir=str(tmp_path / name))
        list(ld.epoch(0))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and names
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes()


def test_quantise_matches_jax():
    for n, step, minimum in [(0, 32, 32), (33, 32, 32), (64, 32, 32), (5, 4, 100)]:
        assert loader.quantise(n, step, minimum) == jax_loader.quantise(n, step, minimum)
