"""The whole slice: audio -> offline.transcribe (the port, on the CPU) must
equal the JAX package's eval FeaturePipeline + GreedyDecoder.decode on the
same weights and audio. Tokens and frames exactly; confidences within 1e-5
(fp32)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from caiman_asr_tpu.data.loader import FeaturePipeline as JaxFeaturePipeline
from caiman_asr_tpu.decoding.greedy import GreedyDecoder as JaxGreedy
from caiman_asr_tpu.models.config import PipelineConfig as JaxPipelineConfig
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch import offline
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import PipelineConfig, RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig

K = 33
CFG = dict(
    in_feats=240, enc_n_hid=32, enc_pre_rnn_layers=2, enc_post_rnn_layers=2,
    enc_stack_time_factor=2, pred_n_hid=16, pred_rnn_layers=2, joint_n_hid=24,
)
# large-196M's shape at a narrow width: 2 + 6 encoder layers, the predictor
# half the encoder's width, its joint learning-rate factor
LARGE_SHAPED = dict(CFG, enc_n_hid=48, enc_post_rnn_layers=6, pred_n_hid=24, joint_n_hid=32,
                    joint_net_lr_factor=0.243)


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.asarray([16000, 11000, 6500], np.int32)
    audio = np.zeros((3, lens.max()), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000
        audio[i, :n] = 0.1 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
            + 0.02 * rng.normal(size=n)
    return audio, lens


@pytest.mark.parametrize("cfg", [CFG, LARGE_SHAPED], ids=["base-shaped", "large-shaped"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_transcribe_equals_jax(with_stats, cfg):
    jm = JaxRNNT(JaxConfig(**cfg), K)
    params = jm.init(jax.random.PRNGKey(0))
    model = load_jax_params(RNNT(RNNTModelConfig(**cfg), K, device="cpu"),
                            jax.tree.map(np.asarray, params))
    audio, lens = _audio()
    stats = None
    if with_stats:
        rng = np.random.default_rng(1)
        stats = (rng.normal(-5, 1, size=80).astype(np.float32),
                 rng.uniform(1, 3, size=80).astype(np.float32))

    jpipe = JaxPipelineConfig()
    jpipe = dataclasses.replace(jpipe, logmel=dataclasses.replace(jpipe.logmel, dither=0.0))
    feats, feat_lens = JaxFeaturePipeline(jpipe, mel_stats=stats, train=False)(
        audio, lens, dataset_to_utt_ratio=1.0)
    want = JaxGreedy(jm, K - 1).decode(params, feats, feat_lens)

    got = offline.transcribe(
        model, torch.from_numpy(audio), torch.from_numpy(lens), stats, device="cpu",
        pipeline=PipelineConfig(logmel=LogMelConfig(dither=0.0)),
    )
    assert len(got) == len(want) == 3
    n_tokens = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for t in g:
            gh, wh = g[t].final.alternatives[0], w[t].final.alternatives[0]
            assert (gh.y_seq, gh.timesteps) == (wh.y_seq, wh.timesteps)
            np.testing.assert_allclose(gh.confidence, wh.confidence, atol=1e-5)
            n_tokens += len(gh.y_seq)
    assert n_tokens > 0, "no tokens: the comparison would be vacuous"


def test_transcribe_bf16_runs_on_the_cpu():
    model = RNNT(RNNTModelConfig(**CFG), K, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    audio, lens = _audio()
    out = offline.transcribe(model, torch.from_numpy(audio), torch.from_numpy(lens),
                             device="cpu", dtype=torch.bfloat16)
    assert len(out) == 3
    assert all(isinstance(t, int) for r in out for t in r)


def test_transcribe_rejects_a_model_on_another_device():
    model = RNNT(RNNTModelConfig(**CFG), K, device="cpu")
    audio, lens = _audio()
    with pytest.raises(ValueError):
        offline.transcribe(model, audio, lens, device="meta")
