"""Checkpoints cross between the packages bit for bit: one the JAX package
writes loads into the port's model (``apply_params`` onto
``model.param_tree()``), and one the port writes loads into the JAX
package's ``load_checkpoint`` / ``apply_params``; the leaves are equal and
the key sets the same. ``apply_params`` keeps its checks. The optimizer's
``opt/`` leaves cross both ways; ``Checkpointer``, fine-tuning loads and
averaging (the function and the CLI) match the JAX package's."""

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


def _jax_opt_state(params, seed: int, lr_factors):
    """A JAX optax state of the trainer's chain with random moments and
    counts."""
    from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
    from caiman_asr_tpu.training import build_optimizer

    opt = build_optimizer(JaxOptConfig(), lr_factors)
    state = opt.init(params)
    leaves, treedef = jax.tree.flatten(state)
    rng = np.random.default_rng(seed)
    new = [np.int32(rng.integers(1, 1000)) if np.asarray(l).dtype == np.int32
           else rng.normal(size=np.shape(l)).astype(np.float32) for l in leaves]
    return jax.tree.unflatten(treedef, new)


def _lamb(model):
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig

    return Lamb(OptimizerConfig(), model.param_lr_factors())


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("joint_net_lr_factor", [1.0, 0.343])
def test_the_optimizer_state_crosses_both_ways(tmp_path, batch_norm, joint_net_lr_factor):
    """opt/<i> in the optax chain's order (Adam's count, the first and the
    second moments in sorted-key order, the schedule's count), the same
    fingerprint, restored exactly by either package."""
    from caiman_asr_tpu.training.fused_finish import extract_opt_state
    from caiman_asr_tpu_torch.training.tree import tree_items

    cfg = dict(enc_batch_norm=batch_norm, pred_batch_norm=batch_norm,
               joint_net_lr_factor=joint_net_lr_factor)
    params = _jax_params(0, **cfg)
    factors = JaxRNNT(JaxConfig(**{**TINY, **cfg}), K).param_lr_factors()
    jax_state = _jax_opt_state(params, 1, factors)
    jax_ckpt.save_checkpoint(tmp_path / "j.npz", params, params, jax_state, {"step": 3})
    adam, sched = extract_opt_state(jax_state)

    model = _port_model(**cfg)
    lamb = _lamb(model)
    ckptr = checkpointer.Checkpointer(tmp_path / "c")
    _, _, state, meta = ckptr.load_for_resume(tmp_path / "j.npz", model.param_tree(),
                                              model.param_tree(), lamb.init(model.param_tree()))
    assert (state.count, state.sched_count) == (int(adam.count), int(sched.count))
    for got, want in ((state.mu, adam.mu), (state.nu, adam.nu)):
        flat = _flat(jax.tree.map(np.asarray, want))
        for path, t in tree_items(got):
            np.testing.assert_array_equal(t.numpy(), flat["/".join(path)])

    # the port's state written, the JAX package's template restored from it
    checkpointer.save_checkpoint(tmp_path / "p.npz", model.param_tree(), None, state,
                                 {"step": 3})
    _, _, leaves, pmeta = jax_ckpt.load_checkpoint(tmp_path / "p.npz")
    _, _, jleaves, jmeta = jax_ckpt.load_checkpoint(tmp_path / "j.npz")
    assert pmeta["_opt_fingerprint"] == jmeta["_opt_fingerprint"]
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    template = _jax_opt_state(params, 9, factors)
    restored = jax_ckpt.restore_opt_state(template, leaves)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jax_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="mismatch"):
        checkpointer.restore_opt_state(lamb.init(model.param_tree()), leaves[:-1])


def test_the_checkpointer_manages_a_directory_as_in_jax(tmp_path):
    """step{N} / best / last names, the meta fields, and last_checkpoint
    skipping a corrupt last.npz for the newest tracked step."""
    model = _port_model().init_weights(torch.Generator().manual_seed(2))
    lamb = _lamb(model)
    tree = model.param_tree()
    ckptr = checkpointer.Checkpointer(tmp_path)
    for step in (2, 4):
        ckptr.save(tree, tree, lamb.init(tree), 1, step, 0.5, meta={"x": step})
    ckptr.save(tree, tree, lamb.init(tree), 1, 4, 0.25, is_best=True)
    assert ckptr.last_checkpoint() == tmp_path / "step4.npz"
    ckptr.save(tree, tree, lamb.init(tree), 2, 5, 0.25, is_last=True)
    jax_dir = jax_ckpt.Checkpointer(tmp_path)
    assert ckptr.last_checkpoint() == jax_dir.last_checkpoint() == tmp_path / "last.npz"
    _, _, _, meta = checkpointer.load_checkpoint(tmp_path / "step4.npz")
    assert {k: meta[k] for k in ("epoch", "step", "best_wer", "x")} == dict(
        epoch=1, step=4, best_wer=0.5, x=4)
    (tmp_path / "last.npz").write_bytes(b"not a checkpoint")
    reopened = checkpointer.Checkpointer(tmp_path)
    assert sorted(reopened.tracked) == [2, 4]
    assert reopened.last_checkpoint() == jax_ckpt.Checkpointer(tmp_path).last_checkpoint() \
        == tmp_path / "step4.npz"


def test_fine_tune_loads_the_ema_and_allows_partial(tmp_path):
    params, ema = _jax_params(0), _jax_params(1)
    jax_ckpt.save_checkpoint(tmp_path / "c.npz", params, ema, None, {})
    model = _port_model()
    ckptr = checkpointer.Checkpointer(tmp_path / "d")
    ckptr.load_for_fine_tune(tmp_path / "c.npz", model.param_tree())
    got = checkpointer.flatten_named(model.param_tree())
    for k, v in _flat(ema).items():
        np.testing.assert_array_equal(got[k], v)
    partial = {k: v for k, v in params.items() if k != "joint_fc"}
    jax_ckpt.save_checkpoint(tmp_path / "p.npz", partial, None, None, {})
    with pytest.raises(ValueError, match="missing"):
        ckptr.load_for_fine_tune(tmp_path / "p.npz", model.param_tree())
    ckptr.load_for_fine_tune(tmp_path / "p.npz", model.param_tree(), allow_partial=True)


def test_averaging_matches_jax(tmp_path):
    """average_checkpoints and the averaging CLI against the JAX
    package's: the same arrays, the same meta."""
    import os
    import time

    from caiman_asr_tpu.export.checkpoint_averaging import main as jax_main
    from caiman_asr_tpu_torch.export.checkpoint_averaging import main

    paths = []
    for i in range(3):
        p = tmp_path / f"step{i}.npz"
        jax_ckpt.save_checkpoint(p, _jax_params(i), _jax_params(10 + i) if i else None,
                                 None, {"step": i, "_opt_fingerprint": "x"})
        os.utime(p, (time.time() + i, time.time() + i))
        paths.append(str(p))
    got, want = checkpointer.average_checkpoints(paths), jax_ckpt.average_checkpoints(paths)
    for g, w in zip(got[:2], want[:2]):
        fg, fw = _flat(g), _flat(w)
        assert fg.keys() == fw.keys()
        for k in fg:
            np.testing.assert_array_equal(fg[k], fw[k])
    assert got[2] == want[2]
    with pytest.raises(ValueError):
        checkpointer.average_checkpoints([])
    main(["--ckpts", *paths, "--output_path", str(tmp_path / "port.npz")])
    jax_main(["--checkpoints", *paths, "--output_path", str(tmp_path / "jax.npz")])
    a, b = (jax_ckpt.load_checkpoint(tmp_path / f"{n}.npz") for n in ("port", "jax"))
    assert a[3] == b[3] and a[3]["averaged_from"] == paths and "_opt_fingerprint" not in a[3]
    for g, w in zip(a[:2], b[:2]):
        fg, fw = _flat(g), _flat(w)
        assert fg.keys() == fw.keys() and all(np.array_equal(fg[k], fw[k]) for k in fg)
