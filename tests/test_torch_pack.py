"""The packed joint in training: the port's host lattice sizes
(``caiman_asr_tpu_torch/training/pack.py``) against the JAX package's and
against its own feature pipeline and encoder, and the train step with
``pack_to`` against the JAX step with it (its Pallas joint in interpret
mode) and against the port's dense step.

Tolerances: the host helpers exactly; the steps as
``tests/test_torch_train_step.py`` (loss rtol 1e-5, gradient norm rtol
1e-4, parameters, EMA and moments at its STATE_TOL); the packed step
against the port's dense step the same.
"""

import jax
import numpy as np
import pytest
import torch

from caiman_asr_tpu.models.config import PipelineConfig as JaxPipelineConfig
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training import build_optimizer as jax_build_optimizer
from caiman_asr_tpu.training import pack as jpack
from caiman_asr_tpu.training.step import init_train_state as jax_init_train_state
from caiman_asr_tpu.training.step import make_train_step as jax_make_train_step
from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
from caiman_asr_tpu_torch.models.config import PipelineConfig, RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
from caiman_asr_tpu_torch.training import pack
from caiman_asr_tpu_torch.training.step import init_train_state
from tests.test_torch_train_step import (
    OPT, SCALARS, TINY, _np, assert_state_close, jax_fused_joint, make_batch, port_model,
    port_step, to_jax, to_torch,
)

MODEL_KW = dict(in_feats=240, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
                enc_stack_time_factor=2, pred_n_hid=16, pred_rnn_layers=1, joint_n_hid=16)


@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("sub", [1, 3])
def test_host_lattice_sizes_match_jax(factor, sub):
    rng = np.random.default_rng(factor * 10 + sub)
    audio_lens = np.concatenate([[0, 1, 399, 400, 401, 1600, 16000, 16001],
                                 rng.integers(0, 320000, 40)])
    token_lens = rng.integers(0, 100, audio_lens.shape[0])
    for initial_padding, final in ((True, 0.0), (False, 0.25)):
        logmel = dict(initial_padding=initial_padding, final_padding_secs=final)
        jp = JaxPipelineConfig()
        jp = jp.__class__(dataset=jp.dataset, logmel=jp.logmel.__class__(**logmel),
                          splicing=jp.splicing.__class__(3, sub))
        tp = PipelineConfig(LogMelConfig(**logmel), PipelineConfig().splicing.__class__(3, sub))
        mc = RNNTModelConfig(**dict(MODEL_KW, enc_stack_time_factor=factor))
        jmc = JaxConfig(**dict(MODEL_KW, enc_stack_time_factor=factor))
        np.testing.assert_array_equal(pack.enc_frame_lens(audio_lens, tp, mc),
                                      jpack.enc_frame_lens(audio_lens, jp, jmc))
        assert (pack.lattice_nvalid(audio_lens, token_lens, tp, mc)
                == jpack.lattice_nvalid(audio_lens, token_lens, jp, jmc))


def test_pack_cap_matches_jax():
    assert pack.PACK_QUANTUM == jpack.PACK_QUANTUM == 16384
    cases = [(100, 1_000_000, 1024, 0.9), (950_000, 1_000_000, 1024, 0.9),
             (999_999, 1_000_000, 1 << 20, 1.1), (100, 1_000_000, None, 0.9),
             (126_000, 1_000_000, None, 0.9), (10, 80_000, None, 0.9),
             (0, 80_000, None, 0.9), (900_001, 1_000_003, None, 0.9)]
    rng = np.random.default_rng(0)
    for _ in range(200):
        dense = int(rng.integers(1, 5_000_000))
        cases.append((int(rng.integers(0, dense + 1)), dense, None, 0.9))
    for nvalid, dense, quantum, threshold in cases:
        got = pack.pack_cap(nvalid, dense, quantum, threshold)
        assert got == jpack.pack_cap(nvalid, dense, quantum, threshold)
        if got is not None:
            assert nvalid <= got < threshold * dense
    assert pack.pack_cap(100, 1_000_000) == 125_000  # the quantum is dense_n / 8 there


def test_host_lattice_sizes_match_the_port_pipeline_and_encoder():
    """enc_frame_lens equals the f_lens of the port's own features and
    encoder (the JAX package's test_host_enc_lens_match_device)."""
    pipe = PipelineConfig()
    model = RNNT(RNNTModelConfig(**MODEL_KW), 32, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    audio_lens = np.asarray([1600, 4000, 16000, 16001, 12345], np.int32)
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(5, int(audio_lens.max()))).astype(np.float32)
    for b, n in enumerate(audio_lens):
        audio[b, n:] = 0.0
    feats, frame_lens = FeaturePipeline(pipe, device="cpu")(torch.from_numpy(audio),
                                                            torch.from_numpy(audio_lens))
    U = 4
    (_, f_lens), _, _ = model.enc_pred(feats, frame_lens, torch.zeros((5, U), dtype=torch.int64),
                                       torch.full((5,), U))
    host = pack.enc_frame_lens(audio_lens, pipe, model.cfg)
    np.testing.assert_array_equal(f_lens.numpy(), host)
    token_lens = np.asarray([4, 0, 2, 4, 1])
    assert pack.lattice_nvalid(audio_lens, token_lens, pipe, model.cfg) == int(
        np.sum(f_lens.numpy() * (token_lens + 1)))


def _nvalid(batch):
    """Per microbatch, the valid lattice positions (stack factor 2)."""
    t = -(-batch["feat_lens"] // 2)
    return (t * (batch["txt_lens"] + 1)).sum(axis=1)


@pytest.fixture(scope="module")
def jax_packed():
    """JAX steps from the same start: packed at a cap 3 rows past the
    larger microbatch's valid count, and at one row below the smaller's."""
    model = JaxRNNT(JaxConfig(**TINY), 12)
    opt = jax_build_optimizer(JaxOptConfig(**OPT), model.param_lr_factors())
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(0))
    batch = make_batch(np.random.default_rng(1))
    nv = _nvalid(batch)
    caps = {"packed": int(nv.max()) + 3, "overflow": int(nv.min()) - 1}
    out = {}
    with jax_fused_joint():
        step = jax_make_train_step(model, opt, 11, donate=False)
        for name, cap in caps.items():
            s, m = step(state, to_jax(batch), jax.random.PRNGKey(0), SCALARS, pack_to=cap)
            out[name] = (s, {k: float(v) for k, v in m.items()})
    return state, batch, caps, out


def test_packed_step_matches_jax_and_the_dense_step(jax_packed):
    state0, batch, caps, out = jax_packed
    js, jm = out["packed"]
    assert caps["packed"] % 128 and caps["packed"] < 8 * 6 * 5
    got = {}
    for cap in (caps["packed"], None):
        model = port_model(state0.params)
        opt, step = port_step(model)
        state = init_train_state(model, opt, device="cpu")
        state, m = step(state, to_torch(batch), None, SCALARS, pack_to=cap)
        got[cap] = state, m
    state, m = got[caps["packed"]]
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
    assert m["skipped"] == jm["skipped"] == 0
    assert_state_close(state, js)
    dense, dm = got[None]
    np.testing.assert_allclose(float(m["loss"]), float(dm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(dm["grad_norm"]), rtol=1e-4)
    for tree, want in ((state.params, dense.params), (state.opt_state.mu, dense.opt_state.mu)):
        want = _np(want)
        for path, leaf in _np(tree).items():
            np.testing.assert_allclose(leaf, want[path], atol=2e-6, rtol=1e-4, err_msg=str(path))


def test_undercounted_pack_to_skips_in_both_packages(jax_packed):
    """One row below the valid count of a microbatch: the loss is not
    finite, the step skipped, and parameters, EMA and moments bit-identical
    to before in both packages."""
    state0, batch, caps, out = jax_packed
    js, jm = out["overflow"]
    assert jm["skipped"] == 1 and not np.isfinite(jm["loss"])
    for new, old in ((js.params, state0.params), (js.ema_params, state0.ema_params),
                     (js.opt_state, state0.opt_state)):
        for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(old)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = port_model(state0.params)
    opt, step = port_step(model)
    state = init_train_state(model, opt, device="cpu")
    before = {name: _np(tree) for name, tree in (
        ("params", state.params), ("ema", state.ema_params), ("mu", state.opt_state.mu),
        ("nu", state.opt_state.nu))}
    new, m = step(state, to_torch(batch), None, SCALARS, pack_to=caps["overflow"])
    assert m["skipped"] == 1 and not np.isfinite(float(m["loss"]))
    assert new.step == 0 and new.opt_state.count == 0 and new.opt_state.sched_count == 0
    for name, tree in (("params", new.params), ("ema", new.ema_params),
                       ("mu", new.opt_state.mu), ("nu", new.opt_state.nu)):
        for path, leaf in _np(tree).items():
            np.testing.assert_array_equal(leaf, before[name][path])
