"""export/from_jax.py: the port's state_dict keys equal the reference torch
names that the JAX package's own exporter emits, values carry over
unchanged, and the port's model loads them strictly."""

import jax
import numpy as np
import pytest

from caiman_asr_tpu.export.torch_export import export_state_dict
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.export.from_jax import load_jax_params, state_dict_from_jax
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

K = 17
TINY = dict(
    in_feats=12, enc_n_hid=16, enc_pre_rnn_layers=2, enc_post_rnn_layers=3,
    enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=16,
)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_keys_match_the_reference_export(batch_norm):
    kw = dict(TINY, enc_batch_norm=batch_norm, pred_batch_norm=batch_norm)
    params = JaxRNNT(JaxConfig(**kw), K).init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    ref = export_state_dict(params)
    sd = state_dict_from_jax(params_np)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)

    model = RNNT(RNNTModelConfig(**kw), K, device="cpu")
    assert set(model.state_dict()) == set(ref)
    load_jax_params(model, params_np)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


def test_unknown_leaf_raises():
    """A leaf the mapping does not know raises; the pruned loss's heads are
    known, and left out of the module's state_dict."""
    params = jax.tree.map(np.asarray, JaxRNNT(JaxConfig(**TINY), K).init(jax.random.PRNGKey(0)))
    params["extra_head"] = {"w": np.zeros((K, 16), np.float32)}
    with pytest.raises(ValueError, match="extra_head"):
        state_dict_from_jax(params)
    del params["extra_head"]
    params["simple_am"] = {"w": np.zeros((K, 16), np.float32)}
    assert not any(k.startswith("simple") for k in state_dict_from_jax(params))


def test_the_simple_heads_cross_with_a_pruned_train_state():
    """A JAX pruned-loss train state (``init_train_state(..., pruned_loss=True)``)
    carried into the port: the heads join the state's tree, with their EMA
    and both moments, value for value; the tree's key set is JAX's."""
    from caiman_asr_tpu.ops.pruned_loss import init_simple_params
    from caiman_asr_tpu_torch.export.from_jax import train_state_from_jax
    from caiman_asr_tpu_torch.training.tree import tree_items

    params = jax.tree.map(np.asarray, JaxRNNT(JaxConfig(**TINY), K).init(jax.random.PRNGKey(0)))
    params.update(jax.tree.map(np.asarray, init_simple_params(jax.random.PRNGKey(3), 16, K)))
    scaled = lambda c: jax.tree.map(lambda a: a * c, params)
    model = RNNT(RNNTModelConfig(**TINY), K, device="cpu")
    state = train_state_from_jax(model, params, scaled(0.5), scaled(0.25), scaled(2.0), 3, 4)
    flat = lambda tree: {"/".join(p): v for p, v in tree_items(tree)}
    jax_keys = {"/".join(str(getattr(k, "key", k)) for k in path)
                for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    for tree, c in ((state.params, 1.0), (state.ema_params, 0.5), (state.opt_state.mu, 0.25),
                    (state.opt_state.nu, 2.0)):
        got = flat(tree)
        assert set(got) == jax_keys
        for top in ("simple_am", "simple_lm"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(got[f"{top}/{leaf}"].detach().numpy(),
                                              params[top][leaf] * c)
    assert state.params["simple_am"]["w"].requires_grad


def test_shape_mismatch_fails_the_strict_load():
    params = jax.tree.map(np.asarray, JaxRNNT(JaxConfig(**TINY), K).init(jax.random.PRNGKey(0)))
    model = RNNT(RNNTModelConfig(**dict(TINY, joint_n_hid=20)), K, device="cpu")
    with pytest.raises(RuntimeError):
        load_jax_params(model, params)


# large-196M's shape at a narrow width: the predictor half the encoder's
# width, 2 + 6 encoder layers, and its joint learning-rate factor
LARGE_SHAPED = dict(
    in_feats=12, enc_n_hid=24, enc_pre_rnn_layers=2, enc_post_rnn_layers=6,
    enc_stack_time_factor=2, pred_n_hid=12, pred_rnn_layers=2, joint_n_hid=16,
    joint_net_lr_factor=0.243,
)


def test_keys_and_shapes_at_a_large_shaped_config():
    """The key set, every shape and every value at the large-shaped config,
    for the weights and for a whole train state."""
    from caiman_asr_tpu_torch.export.from_jax import train_state_from_jax
    from caiman_asr_tpu_torch.training.tree import tree_items

    n_classes = 35
    params = JaxRNNT(JaxConfig(**LARGE_SHAPED), n_classes).init(jax.random.PRNGKey(1))
    params_np = jax.tree.map(np.asarray, params)
    ref = export_state_dict(params)
    model = RNNT(RNNTModelConfig(**LARGE_SHAPED), n_classes, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(np.shape(v)) for k, v in ref.items()}
    assert model.param_lr_factors()["joint_fc"] == 0.243
    ema = jax.tree.map(lambda a: a * 0.5, params_np)
    mu = jax.tree.map(lambda a: a * 0.25, params_np)
    nu = jax.tree.map(lambda a: a * a, params_np)
    state = train_state_from_jax(model, params_np, ema, mu, nu, 7, 5, 6)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    assert (state.opt_state.count, state.opt_state.sched_count, state.step) == (7, 5, 6)
    want = dict(tree_items(state.params))
    assert len(want) == len(ref)
    for tree, scale in ((state.ema_params, 0.5), (state.opt_state.mu, 0.25)):
        got = dict(tree_items(tree))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            assert leaf.shape == want[path].shape and leaf.dtype == want[path].dtype
            np.testing.assert_array_equal(leaf.numpy(), want[path].detach().numpy() * scale)
    for path, leaf in tree_items(state.opt_state.nu):
        np.testing.assert_array_equal(leaf.numpy(), want[path].detach().numpy() ** 2)


def test_the_large_config_file_gives_the_numbers_chip_smoke_writes_out():
    """``configs/large-17407sp.yaml`` through ``load_config`` equals the
    ``rnnt`` numbers ``chip_smoke.py`` builds large-196M from (the machine
    with the card has no YAML reader), and its classes are the 17,407
    sentencepieces plus the blank."""
    from pathlib import Path

    import chip_smoke
    from caiman_asr_tpu_torch.models.config import load_config

    cfg = load_config(Path(chip_smoke.__file__).parent / "configs" / "large-17407sp.yaml")
    assert cfg.rnnt == chip_smoke.model_config("large-196M")
    assert (cfg.rnnt.enc_n_hid, cfg.rnnt.pred_n_hid, cfg.rnnt.joint_n_hid) == (1536, 768, 1024)
    assert cfg.rnnt.joint_net_lr_factor == 0.243
    assert chip_smoke.MODELS["large-196M"][1] == 17407 + 1


def test_lstm_layers_carry_over_unchanged():
    """``lstm_layers_from_jax``: a JAX layer list becomes the port's layer
    dicts with the same values; a leaf it does not know raises."""
    from caiman_asr_tpu.ops.lstm import init_lstm_layer
    from caiman_asr_tpu_torch.export.from_jax import lstm_layers_from_jax

    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    layers = [jax.tree.map(np.asarray, init_lstm_layer(k, 12 if i == 0 else 8, 8))
              for i, k in enumerate(keys)]
    got = lstm_layers_from_jax(layers)
    assert len(got) == 3
    for src, dst in zip(layers, got):
        assert set(dst) == {"w_ih", "w_hh", "b_ih", "b_hh"}
        for k, v in dst.items():
            np.testing.assert_array_equal(v.numpy(), src[k], err_msg=k)
    assert got[0]["w_ih"].shape == (32, 12)
    with pytest.raises(ValueError):
        lstm_layers_from_jax([dict(layers[0], bn={})])
