"""The port's SpecAugment (``caiman_asr_tpu_torch/ops/features.py``) and the
train branch of its ``FeaturePipeline`` against the JAX package's.

The port's masks are built from uniforms given as tensors, so the test
draws JAX's own uniforms (the keys ``spec_augment`` splits, in its order)
and feeds them in: the masked features must then equal JAX's exactly. The
port's own draws are checked for what they must do (shape kept, a share of
entries zeroed, the generator deciding the masks). The pipeline's features
agree with JAX's at the eval branch's atol 1e-4 plus rtol 2e-5 (the log-mel
sums in another order, on features normalised to magnitudes near 8), the
masked entries exactly 0 at the same places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.data.loader import FeaturePipeline as JaxFeaturePipeline
from caiman_asr_tpu.models.config import PipelineConfig as JaxPipelineConfig
from caiman_asr_tpu.ops.features import SpecAugmentConfig as JaxSpecAugmentConfig
from caiman_asr_tpu.ops.features import spec_augment as jax_spec_augment
from caiman_asr_tpu.training.schedules import MelNormRamp as JaxMelNormRamp
from caiman_asr_tpu_torch.data import featurize
from caiman_asr_tpu_torch.models.config import PipelineConfig
from caiman_asr_tpu_torch.ops import features
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
from caiman_asr_tpu_torch.training.schedules import MelNormRamp

CONFIGS = {
    # configs/base-8703sp.yaml: ten time masks, the width adaptive
    "base": dict(freq_masks=2, min_freq=0, max_freq=20, time_masks=10, min_time=0,
                 max_time=0.03),
    # tests/ops/test_logmel_features.py's: the count adaptive too
    "adaptive": dict(freq_masks=2, max_freq=20, time_masks=0.1, max_time=0.03),
    # minimum widths, a fixed maximum width, one frequency band
    "fixed": dict(freq_masks=1, min_freq=3, max_freq=7, time_masks=4, min_time=2, max_time=9),
    # an adaptive count past its cap of 40 (round(600 * 0.1) = 60)
    "capped": dict(freq_masks=3, max_freq=30, time_masks=0.1, max_time=0.05),
}


def jax_uniforms(key, B, cfg):
    """The four [B, n] uniforms ``spec_augment`` draws from ``key``."""
    n_t = cfg.max_time_masks if 0 < cfg.time_masks < 1 else int(cfg.time_masks)
    out = [[], [], [], []]
    for k in jax.random.split(key, B):
        r_f, r_t = jax.random.split(k)
        for i, (r, n) in enumerate(((r_f, cfg.freq_masks), (r_t, n_t))):
            r_w, r_s = jax.random.split(r)
            out[2 * i].append(np.asarray(jax.random.uniform(r_w, (n,))))
            out[2 * i + 1].append(np.asarray(jax.random.uniform(r_s, (n,))))
    return [torch.from_numpy(np.stack(u)) for u in out]


def masked_with(feats, lens, cfg, uniforms):
    B, M, T = feats.shape
    fmask, tmask = features.spec_augment_masks(lens, M, T, cfg, *uniforms)
    return torch.where(fmask[:, :, None] | tmask[:, None, :], 0.0, feats)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_from_jax_uniforms_equal_jax(name, seed):
    rng = np.random.default_rng(seed)
    B, M, T = 4, 240, 600 if name == "capped" else 160
    feats = (rng.normal(size=(B, M, T)) + 5.0).astype(np.float32)
    lens = np.asarray([T, T - 37, T // 2, 9], np.int32)
    cfg, jcfg = features.SpecAugmentConfig(**CONFIGS[name]), JaxSpecAugmentConfig(**CONFIGS[name])
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(feats), jnp.asarray(lens), jcfg))
    got = masked_with(torch.from_numpy(feats), torch.from_numpy(lens), cfg,
                      jax_uniforms(key, B, cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < (want == 0).mean() < 0.9


def test_adaptive_count_and_width_round_half_to_even():
    """count = round(len * time_masks) capped at max_time_masks, width bound
    round(len * max_time): lengths at .5 round to even, as jnp.round."""
    cfg = features.SpecAugmentConfig(freq_masks=0, time_masks=0.5, max_time=0.5, min_time=0)
    lens = torch.tensor([5, 7, 200])  # 2.5 -> 2, 3.5 -> 4, 100 -> capped at 40
    ones = torch.full((3, 40), 0.999999)
    zeros = torch.zeros((3, 40))
    # every active band as wide as allowed and at the start: the mask covers
    # [0, round(len / 2)) when at least one band is active
    _, tmask = features.spec_augment_masks(lens, 4, 200, cfg, zeros[:, :0], zeros[:, :0],
                                           ones, zeros)
    assert tmask.sum(1).tolist() == [2, 4, 100]
    active = features.band_mask(ones, zeros, torch.round(lens * 0.5).clamp(max=40).int(),
                                0, 1, 200)
    assert active.any(1).all()


def test_port_draws_mask_and_follow_the_generator():
    rng = np.random.default_rng(6)
    B, M, T = 3, 80, 100
    feats = torch.from_numpy(rng.normal(size=(B, M, T)).astype(np.float32) + 5.0)
    lens = torch.tensor([100, 80, 60])
    cfg = features.SpecAugmentConfig(freq_masks=2, max_freq=20, time_masks=0.1, max_time=0.03)
    run = lambda seed: features.spec_augment(feats, lens, cfg, torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert a.shape == (B, M, T) and torch.equal(a, b) and not torch.equal(a, c)
    assert 0.005 < (a == 0).float().mean() < 0.9
    kept = a != 0
    assert torch.equal(a[kept], feats[kept])
    with pytest.raises(ValueError):
        features.spec_augment(feats, lens, cfg, None)


def _pipelines(spec):
    jpipe = JaxPipelineConfig()
    jpipe = dataclasses.replace(
        jpipe, logmel=dataclasses.replace(jpipe.logmel, dither=0.0),
        specaugment=None if spec is None else JaxSpecAugmentConfig(**spec))
    tpipe = PipelineConfig(logmel=LogMelConfig(dither=0.0),
                           specaugment=None if spec is None else features.SpecAugmentConfig(**spec))
    return jpipe, tpipe


def test_train_pipeline_matches_jax(monkeypatch):
    """Audio -> log-mel -> normalise (the MelNormRamp's ratio) -> splice ->
    SpecAugment on the spliced features and their lengths -> time-major,
    with JAX's uniforms (the key FeaturePipeline splits off for it)."""
    rng = np.random.default_rng(3)
    lens = np.asarray([16000, 11000, 5000], np.int32)
    audio = np.zeros((3, 16000), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rng.normal(size=n) * 0.1
    stats = (rng.normal(size=80).astype(np.float32), rng.uniform(1, 3, size=80).astype(np.float32))
    ramp, jramp = MelNormRamp(10, 30, 0.2), JaxMelNormRamp(10, 30, 0.2)
    ratio = ramp.ratio(20)
    assert ratio == jramp.ratio(20)
    jpipe, tpipe = _pipelines(CONFIGS["base"])
    key = jax.random.PRNGKey(7)
    want, want_lens = JaxFeaturePipeline(jpipe, mel_stats=stats, train=True)(
        audio, lens, rng=key, dataset_to_utt_ratio=ratio)
    cfg = tpipe.specaugment
    uniforms = jax_uniforms(jax.random.split(key, 3)[1], 3, cfg)
    calls = []

    def with_jax_uniforms(feats, feat_lens, spec_cfg, generator):
        calls.append(feats.shape)
        assert spec_cfg == cfg
        return masked_with(feats, feat_lens, spec_cfg, uniforms)

    monkeypatch.setattr(featurize, "spec_augment", with_jax_uniforms)
    got, got_lens = featurize.FeaturePipeline(tpipe, stats, train=True, device="cpu")(
        torch.from_numpy(audio), torch.from_numpy(lens), torch.Generator().manual_seed(0),
        dataset_to_utt_ratio=ratio)
    assert calls == [(3, 240, want.shape[0])]
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    assert 0.0 < (want == 0).mean() < 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=2e-5)


def test_eval_pipeline_ignores_specaugment():
    """train=False (the default) is the eval branch, SpecAugment or not."""
    rng = np.random.default_rng(4)
    audio = torch.from_numpy(rng.normal(size=(2, 8000)).astype(np.float32) * 0.1)
    lens = torch.tensor([8000, 6000])
    _, with_spec = _pipelines(CONFIGS["base"])
    _, without = _pipelines(None)
    a = featurize.FeaturePipeline(with_spec, device="cpu")(audio, lens)
    b = featurize.FeaturePipeline(without, device="cpu")(audio, lens)
    c = featurize.FeaturePipeline(without, train=True, device="cpu")(audio, lens)
    for other in (b, c):
        assert torch.equal(a[0], other[0]) and torch.equal(a[1], other[1])
