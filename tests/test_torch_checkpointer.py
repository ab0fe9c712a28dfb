"""Checkpoints cross between the packages bit for bit: one the JAX package
writes loads into the port's model (``apply_params`` onto
``model.param_tree()``), and one the port writes loads into the JAX
package's ``load_checkpoint`` / ``apply_params``; the leaves are equal and
the key sets the same. ``apply_params`` keeps its checks."""

import jax
import numpy as np
import pytest
import torch

from caiman_asr_tpu.export import checkpointer as jax_ckpt
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.export import checkpointer
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

K = 13
TINY = dict(in_feats=12, enc_n_hid=8, enc_pre_rnn_layers=1, enc_post_rnn_layers=2,
            pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=8)


def _jax_params(seed: int, **cfg):
    model = JaxRNNT(JaxConfig(**{**TINY, **cfg}), K)
    return jax.tree.map(np.array, model.init(jax.random.PRNGKey(seed)))


def _port_model(**cfg):
    return RNNT(RNNTModelConfig(**{**TINY, **cfg}), K, device="cpu")


def _flat(tree):
    return jax_ckpt.flatten_named(tree)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_a_jax_checkpoint_loads_into_the_port(tmp_path, batch_norm):
    cfg = dict(enc_batch_norm=batch_norm, pred_batch_norm=batch_norm)
    params, ema = _jax_params(0, **cfg), _jax_params(1, **cfg)
    extra = {"rsp/h": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jax_ckpt.save_checkpoint(tmp_path / "c.npz", params, ema, meta={"step": 3, "wer": 0.5},
                             extra=extra)
    loaded, got_ema, opt, meta = checkpointer.load_checkpoint(tmp_path / "c.npz")
    want = jax_ckpt.load_checkpoint(tmp_path / "c.npz")
    assert meta == want[3] == {"step": 3, "wer": 0.5}
    assert opt is None and want[2] is None
    for got_tree, want_tree in ((loaded, want[0]), (got_ema, want[1])):
        g, w = _flat(got_tree), _flat(want_tree)
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    model = _port_model(**cfg)
    checkpointer.apply_params(model.param_tree(), got_ema)
    tree = checkpointer.flatten_named(model.param_tree())
    assert set(tree) == set(_flat(ema))
    for k, v in _flat(ema).items():
        assert tree[k].dtype == v.dtype
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    for k, v in checkpointer.load_extra(tmp_path / "c.npz").items():
        np.testing.assert_array_equal(v, extra[k])


def test_a_port_checkpoint_loads_into_jax(tmp_path):
    model = _port_model().init_weights(torch.Generator().manual_seed(4))
    ema = {k: v + 1.0 for k, v in checkpointer.flatten_named(model.param_tree()).items()}
    checkpointer.save_checkpoint(tmp_path / "p.npz", model.param_tree(),
                                 checkpointer.unflatten_named(ema), meta={"step": 9},
                                 extra={"x": torch.ones(3)})
    assert not (tmp_path / "p.npz.tmp").exists()
    params, got_ema, opt, meta = jax_ckpt.load_checkpoint(tmp_path / "p.npz")
    assert meta == {"step": 9} and opt is None
    template = _jax_params(7)
    applied = jax.tree.map(np.asarray, jax_ckpt.apply_params(template, params))
    want = checkpointer.flatten_named(model.param_tree())
    assert set(_flat(applied)) == set(want) == set(_flat(template))
    for k, v in _flat(applied).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for k, v in _flat(jax_ckpt.apply_params(template, got_ema)).items():
        np.testing.assert_array_equal(np.asarray(v), ema[k], err_msg=k)
    np.testing.assert_array_equal(jax_ckpt.load_extra(tmp_path / "p.npz")["x"], np.ones(3))


def test_flatten_and_unflatten_match_jax():
    tree = {"a": {"b": np.ones(2), "c": [np.zeros(1), np.arange(3)]}, "d": np.float32(2)}
    got, want = checkpointer.flatten_named(tree), jax_ckpt.flatten_named(tree)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert (jax.tree.map(np.asarray, checkpointer.unflatten_named(got)).keys()
            == jax_ckpt.unflatten_named(want).keys())


def test_apply_params_keeps_its_checks():
    model = _port_model()
    params = _jax_params(0)
    with pytest.raises(ValueError, match="unknown"):
        checkpointer.apply_params(model.param_tree(), {**params, "bogus": np.zeros(1)})
    partial = {k: v for k, v in params.items() if k != "joint_fc"}
    with pytest.raises(ValueError, match="missing"):
        checkpointer.apply_params(model.param_tree(), partial)
    before = model.joint_net[2].weight.detach().clone()
    checkpointer.apply_params(model.param_tree(), partial, allow_partial=True)
    assert torch.equal(model.joint_net[2].weight, before)
    np.testing.assert_array_equal(model.prediction["embed"].weight.detach().numpy(),
                                  params["prediction"]["embed"])
    bad = jax.tree.map(np.array, params)
    bad["joint_fc"]["w"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        checkpointer.apply_params(model.param_tree(), bad)
    # the training-only heads of a pruned-loss checkpoint are skipped
    checkpointer.apply_params(model.param_tree(), {**params, "simple_am": {"w": np.zeros(2)}})
