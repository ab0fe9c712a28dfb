"""Layer statistics (``caiman_asr_tpu_torch/log/layer_stats.py``) and the
train step's gradient noise (``training/step.add_grad_noise``) against the
JAX package's (``caiman_asr_tpu/log/layer_stats.py``,
``training/step.py:260-270``).

The JAX step draws its noise from its key; the test draws the same normals
(the keys ``_add_noise`` splits, over the encoder's leaves in JAX's sorted
order) and hands them to the port's step, so both add the same noise.

Tolerances: names exactly; statistics rtol 1e-5 (atol 1e-7 for the zero
statistics of zero gradients); the step as ``tests/test_torch_train_step.py``
(loss rtol 1e-5, gradient norm rtol 1e-4, parameters, EMA and moments at
its STATE_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.log import layer_stats as jls
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training import build_optimizer as jax_build_optimizer
from caiman_asr_tpu.training.step import init_train_state as jax_init_train_state
from caiman_asr_tpu.training.step import make_train_step as jax_make_train_step
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.log import layer_stats as ls
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.training import step as step_mod
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.training.step import add_grad_noise, init_train_state, make_train_step
from caiman_asr_tpu_torch.training.tree import tree_items, tree_map
from tests.test_torch_train_step import (
    OPT, TINY, assert_state_close, jax_fused_joint, make_batch, port_model, to_jax, to_torch,
)

NOISE = {"delay_penalty": 0.0, "star_penalty": 0.0, "grad_noise_std": 0.05}
STATS_TOL = dict(rtol=1e-5, atol=1e-7)


def _trees(cfg, seed):
    """A JAX parameter tree, the port's model loaded from it, and a
    gradient-shaped tree of numpy normals with one all-zero leaf."""
    params = JaxRNNT(JaxConfig(**cfg), 12).init(jax.random.PRNGKey(seed))
    model = load_jax_params(RNNT(RNNTModelConfig(**cfg), 12, device="cpu"),
                            jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    grads["joint_fc"]["b"] = np.zeros_like(grads["joint_fc"]["b"])
    return params, model, grads


@pytest.mark.parametrize("cfg", [
    TINY, dict(TINY, enc_pre_rnn_layers=2, enc_post_rnn_layers=11),
    dict(TINY, enc_batch_norm=True, pred_batch_norm=True)])
def test_names_and_vector_match_jax(cfg):
    """Sorted-key order (layer_10 before layer_2, the batch-norm leaves
    bias, mean, scale, var), population std."""
    params, model, grads = _trees(cfg, 1)
    tree = model.param_tree()
    names = ls.layer_stat_names(tree)
    assert names == jls.layer_stat_names(params)
    assert len(names) == 5 * len(list(tree_items(tree)))
    gtree = tree_map(lambda p, g: torch.from_numpy(g), tree, grads)
    got = ls.layer_stats_vec(tree, gtree).numpy()
    want = np.asarray(jls.layer_stats_vec(params, jax.tree.map(jnp.asarray, grads)))
    np.testing.assert_allclose(got, want, **STATS_TOL)
    assert ls.layer_stats_dict(names, torch.from_numpy(got)) == jls.layer_stats_dict(names, got)
    if cfg.get("enc_batch_norm"):
        assert "per-layer-weight-norm/encoder.pre_rnn.layer_0.bn.mean" in names


def test_generator_noise_touches_the_encoder_only():
    g = {("encoder", "a"): torch.zeros(3, 4), ("prediction", "b"): torch.zeros(5),
         ("joint_fc", "w"): torch.ones(2)}
    a = add_grad_noise(g, 0.5, torch.Generator().manual_seed(0))
    b = add_grad_noise(g, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(a[("encoder", "a")], b[("encoder", "a")])
    assert a[("encoder", "a")].abs().sum() > 0 and a[("encoder", "a")].std() < 1.0
    assert torch.equal(a[("prediction", "b")], g[("prediction", "b")])
    assert torch.equal(a[("joint_fc", "w")], g[("joint_fc", "w")])
    with pytest.raises(ValueError, match="generator"):
        model = port_model(JaxRNNT(JaxConfig(**TINY), 12).init(jax.random.PRNGKey(0)))
        opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
        make_train_step(model, opt, 11, grad_noise=True, device="cpu")(
            init_train_state(model, opt, device="cpu"),
            to_torch(make_batch(np.random.default_rng(0))), None, NOISE)


def jax_normals(key, encoder_params):
    """The normals JAX's _add_noise draws for each encoder leaf, by path."""
    leaves = jax.tree_util.tree_flatten_with_path(encoder_params)[0]
    keys = jax.random.split(jax.random.fold_in(key, 1 << 20), len(leaves))
    return {("encoder",) + tuple(k.key for k in path):
            torch.from_numpy(np.array(jax.random.normal(k, leaf.shape, jnp.float32)))
            for (path, leaf), k in zip(leaves, keys)}


@pytest.fixture(scope="module")
def jax_noisy():
    """A JAX step with gradient noise (std 0.05) and layer statistics."""
    model = JaxRNNT(JaxConfig(**TINY), 12)
    opt = jax_build_optimizer(JaxOptConfig(**OPT), model.param_lr_factors())
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(0))
    batch = make_batch(np.random.default_rng(21))
    key = jax.random.PRNGKey(5)
    with jax_fused_joint():
        step = jax_make_train_step(model, opt, 11, grad_noise=True, collect_layer_stats=True,
                                   donate=False)
        s, m = step(state, to_jax(batch), key, NOISE)
    return state, batch, key, s, {k: np.asarray(v) for k, v in m.items()}


def test_noisy_step_and_its_layer_stats_match_jax(jax_noisy, monkeypatch):
    state0, batch, key, js, jm = jax_noisy
    normals = jax_normals(key, state0.params["encoder"])
    drawn = []

    def with_jax_normals(grads, std, generator=None, normals_=None):
        drawn.append(std)
        return add_grad_noise(grads, std, generator, normals)

    monkeypatch.setattr(step_mod, "add_grad_noise", with_jax_normals)
    model = port_model(state0.params)
    opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
    step = make_train_step(model, opt, 11, grad_noise=True, collect_layer_stats=True,
                           device="cpu")
    state = init_train_state(model, opt, device="cpu")
    stats_names = ls.layer_stat_names(state.params)
    state, m = step(state, to_torch(batch), torch.Generator().manual_seed(0), NOISE)
    assert drawn == [0.05]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert_state_close(state, js)
    got = m["layer_stats"].numpy()
    assert got.shape == jm["layer_stats"].shape == (len(stats_names),)
    np.testing.assert_allclose(got, jm["layer_stats"], **STATS_TOL)
    # the noise reached the encoder's gradient statistics only
    noisy = [i for i, n in enumerate(stats_names) if "grad" in n and "/encoder." in n]
    assert noisy and all(got[i] > 0 for i in noisy)


def test_noise_moves_the_step(jax_noisy):
    """Without the noise (std 0) the same step differs from JAX's noisy one."""
    state0, batch, _, js, jm = jax_noisy
    model = port_model(state0.params)
    opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
    step = make_train_step(model, opt, 11, grad_noise=True, device="cpu")
    state = init_train_state(model, opt, device="cpu")
    _, m = step(state, to_torch(batch), torch.Generator().manual_seed(0),
                dict(NOISE, grad_noise_std=0.0))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) > 1e-3
