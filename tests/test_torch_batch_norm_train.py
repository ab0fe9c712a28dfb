"""Batch-norm training: the port's ``batch_norm_apply(train=True)``
(``caiman_asr_tpu_torch/ops/lstm.py``), the running-stat plumbing of
``RNNT`` and the train step of a batch-norm model against the JAX
package's (``caiman_asr_tpu/ops/lstm.py:281-306``,
``models/rnnt.py:436-452``, ``training/step.py:474-532``). Mirrors
``tests/models/test_batch_norm.py``.

Tolerances: the normalised output atol 1e-5 (fp32 means in another order);
running stats rtol 1e-5; the step as ``tests/test_torch_train_step.py``
(loss rtol 1e-5, gradient norm rtol 1e-4; the JAX step takes its optax
finish here, whose EMA rounds as ``e * d + p * (1 - d)``). Parameters, EMA
and moments at BN_STATE_TOL, atol 2e-5 / rtol 1e-4 where STATE_TOL has
atol 2e-6: the batch statistics, means in another order, move a gradient
by about 1e-12, and a gradient that small (4e-9 on one w_hh entry here,
near Adam's eps of 1e-9) takes its first Adam direction g / (|g| + eps)
from those bits, by up to 2% of the step lr * trust (1.1e-5 measured); the
moments themselves agree to 1.5e-6 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.ops.lstm import BN_MOMENTUM as JAX_BN_MOMENTUM
from caiman_asr_tpu.ops.lstm import batch_norm_apply as jax_batch_norm_apply
from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training import build_optimizer as jax_build_optimizer
from caiman_asr_tpu.training.fused_finish import extract_opt_state
from caiman_asr_tpu.training.step import init_train_state as jax_init_train_state
from caiman_asr_tpu.training.step import make_train_step as jax_make_train_step
from caiman_asr_tpu_torch.export.from_jax import load_jax_params, train_state_from_jax
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops.lstm import BN_MOMENTUM, batch_norm_apply
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step
from tests.test_torch_train_step import (
    OPT, SCALARS, TINY, _np, assert_state_close, jax_fused_joint, make_batch, to_jax, to_torch,
)

BN = dict(TINY, enc_pre_rnn_layers=2, enc_post_rnn_layers=2, pred_rnn_layers=2,
          enc_batch_norm=True, pred_batch_norm=True)
STATS_RTOL = 1e-5
BN_STATE_TOL = dict(atol=2e-5, rtol=1e-4)


def _bn(rng, H):
    return {"scale": rng.normal(size=H).astype(np.float32),
            "bias": rng.normal(size=H).astype(np.float32),
            "mean": rng.normal(size=H).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, size=H).astype(np.float32)}


def test_batch_statistics_match_jax_and_torch():
    """Train mode: normalised by the batch's statistics over every (time,
    batch) position, the biased variance; the unbiased one collected. The
    fold with BN_MOMENTUM equals torch BatchNorm1d's running stats."""
    H, T, B = 16, 7, 5
    rng = np.random.default_rng(0)
    y = rng.normal(size=(T, B, H)).astype(np.float32) * 2 + 1
    bn = _bn(rng, H)
    assert BN_MOMENTUM == JAX_BN_MOMENTUM
    updates, jupdates = [], []
    got = batch_norm_apply({k: torch.from_numpy(v) for k, v in bn.items()}, torch.from_numpy(y),
                           True, updates)
    want = jax_batch_norm_apply({k: jnp.asarray(v) for k, v in bn.items()}, jnp.asarray(y),
                                True, jupdates)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for g, w in zip(updates[0], jupdates[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STATS_RTOL)
    tbn = torch.nn.BatchNorm1d(H)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(tbn, name).copy_(torch.from_numpy(bn[key]))
    tbn.train()
    ref = tbn(torch.from_numpy(y).permute(1, 2, 0)).permute(2, 0, 1).detach()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    (bm, bv), = updates
    fold = lambda old, new: (1 - BN_MOMENTUM) * torch.from_numpy(old) + BN_MOMENTUM * new
    np.testing.assert_allclose(fold(bn["mean"], bm).numpy(), tbn.running_mean.numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fold(bn["var"], bv).numpy(), tbn.running_var.numpy(),
                               rtol=1e-4, atol=1e-6)
    # a bf16 input: statistics in fp32, the output back in bf16
    out16 = batch_norm_apply({k: torch.from_numpy(v) for k, v in bn.items()},
                             torch.from_numpy(y).bfloat16(), True)
    assert out16.dtype == torch.bfloat16


def test_running_stat_order_matches_jax():
    """bn_stats, bn_stat_paths and apply_bn_updates walk pre_rnn, post_rnn,
    dec_rnn as the JAX model does."""
    jmodel = JaxRNNT(JaxConfig(**BN), 12)
    params = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                          params)
    model = load_jax_params(RNNT(RNNTModelConfig(**BN), 12, device="cpu"),
                            jax.tree.map(np.asarray, params))
    tree = model.param_tree()
    want = jmodel.bn_stats(params)
    got = model.bn_stats(tree)
    assert len(got) == len(want) == 6
    for (gm, gv), (wm, wv) in zip(got, want):
        np.testing.assert_array_equal(gm.detach().numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gv.detach().numpy(), np.asarray(wv))
    paths = model.bn_stat_paths(tree)
    assert paths[0] == (("encoder", "pre_rnn", "layer_0", "bn", "mean"),
                        ("encoder", "pre_rnn", "layer_0", "bn", "var"))
    assert paths[-1][1] == ("prediction", "dec_rnn", "layer_1", "bn", "var")
    new = [(torch.full_like(m, float(i)), torch.full_like(v, -float(i)))
           for i, (m, v) in enumerate(got)]
    out = model.apply_bn_updates(tree, new)
    jout = jmodel.apply_bn_updates(params, [(jnp.asarray(m.numpy()), jnp.asarray(v.numpy()))
                                            for m, v in new])
    for (gm, gv), (wm, wv) in zip(model.bn_stats(out), jmodel.bn_stats(jout)):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert model.bn_stats(tree)[1][0] is got[1][0]  # the original tree is untouched
    with pytest.raises(ValueError):
        model.apply_bn_updates(tree, new[:-1])


@pytest.fixture(scope="module")
def jax_bn():
    """Two JAX steps of a batch-norm model over A=2 microbatches."""
    model = JaxRNNT(JaxConfig(**BN), 12)
    opt = jax_build_optimizer(JaxOptConfig(**OPT), model.param_lr_factors())
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(3))
    batches = [make_batch(np.random.default_rng(s)) for s in (31, 32)]
    states, metrics = [state], []
    with jax_fused_joint():
        step = jax_make_train_step(model, opt, 11, donate=False)
        for b in batches:
            s, m = step(states[-1], to_jax(b), jax.random.PRNGKey(0), SCALARS)
            states.append(s)
            metrics.append({k: float(v) for k, v in m.items()})
    return model, batches, states, metrics


def _port(params):
    model = load_jax_params(RNNT(RNNTModelConfig(**BN), 12, device="cpu"),
                            jax.tree.map(np.asarray, params))
    opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
    return model, opt, make_train_step(model, opt, 11, device="cpu")


def _assert_stats_close(model, state, jmodel, jstate):
    for (gm, gv), (wm, wv) in zip(model.bn_stats(state.params), jmodel.bn_stats(jstate.params)):
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=STATS_RTOL, atol=1e-7)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=STATS_RTOL)


def test_batch_norm_steps_match_jax(jax_bn):
    """Each microbatch's statistics folded in turn; after the LAMB update
    the stat leaves take the folded stats, then the EMA: the running stats,
    every parameter, the EMA and the moments against JAX's after each of
    two steps."""
    jmodel, batches, jstates, jmetrics = jax_bn
    model, opt, step = _port(jstates[0].params)
    state = init_train_state(model, opt, device="cpu")
    stats0 = [t.clone() for pair in model.bn_stats(state.params) for t in pair]
    for b, js, jm in zip(batches, jstates[1:], jmetrics):
        state, m = step(state, to_torch(b), None, SCALARS)
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
        assert m["skipped"] == jm["skipped"] == 0
        _assert_stats_close(model, state, jmodel, js)
        assert_state_close(state, js, BN_STATE_TOL)
    stats = [t for pair in model.bn_stats(state.params) for t in pair]
    assert all(not torch.allclose(a, b) for a, b in zip(stats0, stats))
    # the EMA of a stat leaf follows the folded stats
    ema_stats = [t for pair in model.bn_stats(state.ema_params) for t in pair]
    assert all(torch.isfinite(t).all() for t in ema_stats)


def test_batch_norm_step_from_a_carried_state_matches_jax(jax_bn):
    """JAX's state after one step (batch-norm leaves in the parameters,
    EMA and moments) carried over by train_state_from_jax, then the second
    step on both sides."""
    jmodel, batches, jstates, jmetrics = jax_bn
    js = jstates[1]
    adam, sched = extract_opt_state(js.opt_state)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    model = RNNT(RNNTModelConfig(**BN), 12, device="cpu")
    state = train_state_from_jax(model, to_np(js.params), to_np(js.ema_params), to_np(adam.mu),
                                 to_np(adam.nu), int(adam.count), int(sched.count),
                                 int(js.step))
    assert_state_close(state, js, dict(atol=0, rtol=0))
    opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
    state, m = make_train_step(model, opt, 11, device="cpu")(state, to_torch(batches[1]), None,
                                                             SCALARS)
    np.testing.assert_allclose(float(m["loss"]), jmetrics[1]["loss"], rtol=1e-5)
    _assert_stats_close(model, state, jmodel, jstates[2])
    assert_state_close(state, jstates[2], BN_STATE_TOL)


def test_a_skipped_batch_norm_step_keeps_the_running_stats(jax_bn):
    _, batches, jstates, _ = jax_bn
    model, opt, step = _port(jstates[0].params)
    state = init_train_state(model, opt, device="cpu")
    before = _np(state.params)
    bad = to_torch(batches[0])
    bad["feats"][1, 0, 0, 0] = float("nan")
    new, m = step(state, bad, None, SCALARS)
    assert m["skipped"] == 1 and new.step == 0
    for path, leaf in _np(new.params).items():
        np.testing.assert_array_equal(leaf, before[path])
