"""The port's front-end (ops/logmel.py, ops/features.py, data/featurize.py)
against the JAX package's, on audio made with numpy from a seed. Tolerance
1e-4 absolute on log-mel features (fp32 DFT matmuls summed in another
order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.data.loader import FeaturePipeline as JaxFeaturePipeline
from caiman_asr_tpu.models.config import PipelineConfig as JaxPipelineConfig
from caiman_asr_tpu.ops import features as jax_features
from caiman_asr_tpu.ops import logmel as jax_logmel
from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
from caiman_asr_tpu_torch.models.config import PipelineConfig
from caiman_asr_tpu_torch.ops import features, logmel

ATOL = 1e-4


def _audio(seed=0, B=3, n=(8000, 5000, 2600)):
    rng = np.random.default_rng(seed)
    audio = np.zeros((B, max(n)), np.float32)
    for i, k in enumerate(n):
        audio[i, :k] = rng.normal(size=k) * 0.1
    return audio, np.asarray(n, np.int32)


def _feats(seed=1, B=3, M=6, T=11, lens=(11, 8, 3)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, M, T)).astype(np.float32) * 3 + 1, np.asarray(lens, np.int32)


def test_filterbank_constants_match():
    np.testing.assert_array_equal(logmel.hann_window(400), jax_logmel.hann_window(400))
    np.testing.assert_array_equal(
        logmel.mel_filterbank(16000, 512, 80), jax_logmel.mel_filterbank(16000, 512, 80))
    for a, b in zip(logmel.dft_bases(512, 400), jax_logmel.dft_bases(512, 400)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("final_padding_secs", [0.0, 0.05])
def test_logmel_frontend(final_padding_secs):
    audio, lens = _audio()
    jcfg = jax_logmel.LogMelConfig(dither=0.0, final_padding_secs=final_padding_secs)
    tcfg = logmel.LogMelConfig(dither=0.0, final_padding_secs=final_padding_secs)
    want, want_lens = jax_logmel.LogMelFrontend(jcfg)(audio, lens)
    got, got_lens = logmel.LogMelFrontend(tcfg, device="cpu")(
        torch.from_numpy(audio), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dither_draws_from_the_callers_generator():
    audio, lens = _audio()
    fe = logmel.LogMelFrontend(logmel.LogMelConfig(dither=1e-2), device="cpu")
    run = lambda seed: fe(torch.from_numpy(audio), torch.from_numpy(lens),
                          torch.Generator().manual_seed(seed))[0]
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))


@pytest.mark.parametrize("with_stats,ratio", [(False, 0.0), (True, 1.0), (True, 0.3)])
def test_normalize_batch(with_stats, ratio):
    feats, lens = _feats()
    stats = None
    if with_stats:
        rng = np.random.default_rng(2)
        stats = (rng.normal(size=6).astype(np.float32),
                 rng.uniform(0.5, 2, size=6).astype(np.float32))
    jstats = tuple(map(jnp.asarray, stats)) if stats else (None, None)
    tstats = tuple(map(torch.from_numpy, stats)) if stats else (None, None)
    want = jax_logmel.normalize_batch(jnp.asarray(feats), jnp.asarray(lens), *jstats,
                                      dataset_to_utt_ratio=ratio)
    got = logmel.normalize_batch(torch.from_numpy(feats), torch.from_numpy(lens), *tstats,
                                 dataset_to_utt_ratio=ratio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stacking,subsampling", [(3, 3), (2, 1), (1, 2)])
def test_stack_subsample_frames(stacking, subsampling):
    feats, lens = _feats()
    want, want_lens = jax_features.stack_subsample_frames(
        jnp.asarray(feats), jnp.asarray(lens), stacking, subsampling)
    got, got_lens = features.stack_subsample_frames(
        torch.from_numpy(feats), torch.from_numpy(lens), stacking, subsampling)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("factor", [2, 3])
def test_stack_time(factor):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 2, 4)).astype(np.float32)
    lens = np.asarray([7, 4], np.int32)
    want, want_lens = jax_features.stack_time(jnp.asarray(x), jnp.asarray(lens), factor)
    got, got_lens = features.stack_time(torch.from_numpy(x), torch.from_numpy(lens), factor)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("with_stats", [False, True])
def test_feature_pipeline_eval(with_stats):
    audio, lens = _audio(seed=4)
    stats = None
    if with_stats:
        rng = np.random.default_rng(5)
        stats = (rng.normal(-5, 1, size=80).astype(np.float32),
                 rng.uniform(1, 3, size=80).astype(np.float32))
    jpipe = JaxPipelineConfig()
    jpipe = dataclasses.replace(jpipe, logmel=dataclasses.replace(jpipe.logmel, dither=0.0))
    want, want_lens = JaxFeaturePipeline(jpipe, mel_stats=stats, train=False)(
        audio, lens, dataset_to_utt_ratio=1.0)
    tpipe = PipelineConfig(logmel=logmel.LogMelConfig(dither=0.0))
    got, got_lens = FeaturePipeline(tpipe, stats, device="cpu")(
        torch.from_numpy(audio), torch.from_numpy(lens), dataset_to_utt_ratio=1.0)
    assert got.shape == want.shape  # [T, B, 240]
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
