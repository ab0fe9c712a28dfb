"""The port's noise augmentation (``caiman_asr_tpu_torch/data/noise.py``) and
the train half of its builders against the JAX package's: the samplers'
draws, the SNR schedule, the noise clips of a directory, and the train
loader with background and babble noise, bit for bit from the same
seeds."""

import json
import wave

import numpy as np
import pytest

from caiman_asr_tpu.args.train import train_arg_parser as jax_train_arg_parser
from caiman_asr_tpu.data import noise as jax_noise
from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from caiman_asr_tpu.models.config import load_config as jax_load_config
from caiman_asr_tpu.setup import builders as jax_builders
from caiman_asr_tpu_torch.args.train import train_arg_parser
from caiman_asr_tpu_torch.data import noise
from caiman_asr_tpu_torch.data.tokenizer import Tokenizer, save_tokenizer_json, train_tokenizer
from caiman_asr_tpu_torch.models.config import load_config
from caiman_asr_tpu_torch.setup import builders


def _wav(path, x, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.mark.parametrize("prob, low, high", [(0.0, 30, 60), (0.25, 30, 60), (1.0, 0, 30)])
def test_sampler_draws_match_jax(prob, low, high):
    got = noise.NoiseSampler(prob, np.random.default_rng(3), low, high)
    want = jax_noise.NoiseSampler(prob, np.random.default_rng(3), low, high)
    for i in range(200):
        if i == 100:
            got.set_range(5, 10)
            want.set_range(5, 10)
        assert got.draw() == want.draw()
    assert got.get_range() == want.get_range()


@pytest.mark.parametrize("delay, ramp", [(0, 10), (5, 20), (4896, 4896)])
def test_schedule_adjusts_snrs_as_in_jax(delay, ramp):
    samplers = {}
    for name, mod in (("port", noise), ("jax", jax_noise)):
        bg = mod.NoiseSampler(0.5, np.random.default_rng(0), 30, 60)
        bb = mod.NoiseSampler(0.5, np.random.default_rng(0), 30, 60)
        samplers[name] = (mod.NoiseSchedule(delay, ramp, 30, 60, background=bg, babble=bb),
                          mod.NoiseSchedule(delay, ramp, 30, 60, background=bg))
    for step in list(range(0, 40)) + [delay + ramp // 2, delay + ramp, 10 ** 6]:
        for a, b in zip(samplers["port"], samplers["jax"]):
            assert a.adjust_snrs(step) == b.adjust_snrs(step), step


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(1)
    (root / "noise" / "sub").mkdir(parents=True)
    for i in range(3):
        _wav(root / "noise" / f"n{i}.wav", rng.normal(size=4000 + 1000 * i) * 0.2)
    _wav(root / "noise" / "sub" / "deep.wav", rng.normal(size=3000) * 0.2)
    (root / "noise" / "readme.txt").write_text("not audio")
    texts = ["the cat sat", "a dog barks", "she sells shells", "quick brown fox", "lazy dog",
             "hello world"]
    entries = []
    for i, t in enumerate(texts):
        _wav(root / f"u{i}.wav", rng.normal(size=6000 + 1500 * i) * 0.1)
        entries.append({"transcript": t, "files": [{"fname": f"u{i}.wav",
                                                    "duration": (6000 + 1500 * i) / 16000}],
                        "original_duration": (6000 + 1500 * i) / 16000})
    (root / "m.json").write_text(json.dumps(entries))
    save_tokenizer_json(root / "tok.json", train_tokenizer(texts * 3, vocab_size=30))
    return root


@pytest.mark.parametrize("max_clips", [None, 2])
def test_dataset_clips_match_jax(corpus, max_clips):
    got = noise.NoiseDataset.from_spec(str(corpus / "noise"), 16000, max_clips=max_clips)
    want = jax_noise.NoiseDataset.from_spec(str(corpus / "noise"), 16000, max_clips=max_clips)
    assert got.paths == want.paths and len(got.paths) == (max_clips or 4)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(10):
        np.testing.assert_array_equal(got.get(r1), want.get(r2))


def test_an_empty_directory_and_a_hub_name_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        noise.NoiseDataset.from_spec(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        noise.NoiseDataset.from_spec("Myrtle/CAIMAN-ASR-BackgroundNoise")


@pytest.mark.parametrize("flags", [
    ["--prob_background_noise", "0.5"],
    ["--prob_background_noise", "0.0", "--prob_babble_noise", "0.5"],
    ["--prob_background_noise", "1.0", "--prob_babble_noise", "0.3", "--num_buckets", "0"],
    ["--prob_background_noise", "0.5", "--relative_train_manifest_ratios", "2",
     "--randomize_first_n_epochs", "1"],
])
def test_train_loader_with_noise_matches_jax(corpus, flags):
    """build_data_source_loader(train=True) in both packages over the same
    manifest, noise directory and seed: the same sampler, the same batches
    bit for bit over two epochs, and (the port) the host streams' states
    after each batch restore to the same next batch."""
    argv = ["--dataset_dir", str(corpus), "--train_manifests", "m.json",
            "--noise_dataset", str(corpus / "noise")] + flags
    cfg_path = "configs/base-8703sp.yaml"
    tcfg, jcfg = load_config(cfg_path), jax_load_config(cfg_path).cfg
    labels = list(tcfg.tokenizer.labels)
    tl = builders.build_data_source_loader(
        train_arg_parser().parse_args(argv), tcfg,
        Tokenizer(labels, corpus / "tok.json", sampling=0.2, seed=4), 2, train=True, seed=5)
    jl = jax_builders.build_data_source_loader(
        jax_train_arg_parser().parse_args(argv), jcfg,
        JaxTokenizer(labels, corpus / "tok.json", sampling=0.2, seed=4), 2, train=True, seed=5)
    assert type(tl.sampler).__name__ == type(jl.sampler).__name__
    states = []
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("audio", "audio_lens", "tokens", "token_lens"):
                np.testing.assert_array_equal(getattr(g, key), getattr(w, key), err_msg=key)
            assert g.fnames == w.fnames
            states.append((g.host_rng, g))
    # restoring the state after batch 0 makes batch 1 again
    (s0, _), (_, b1) = states[0], states[1]
    tl.set_host_rng_state(s0)
    again = tl.make_batch(tl.sampler.shard(tl.sampler.epoch_batches(0)[1], 0))
    np.testing.assert_array_equal(again.audio, b1.audio)
    np.testing.assert_array_equal(again.tokens, b1.tokens)
    with pytest.raises(ValueError):
        tl.set_host_rng_state(s0[:1])
