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
    params = jax.tree.map(np.asarray, JaxRNNT(JaxConfig(**TINY), K).init(jax.random.PRNGKey(0)))
    params["simple_am"] = {"w": np.zeros((K, 16), np.float32)}
    with pytest.raises(ValueError, match="simple_am"):
        state_dict_from_jax(params)


def test_shape_mismatch_fails_the_strict_load():
    params = jax.tree.map(np.asarray, JaxRNNT(JaxConfig(**TINY), K).init(jax.random.PRNGKey(0)))
    model = RNNT(RNNTModelConfig(**dict(TINY, joint_n_hid=20)), K, device="cpu")
    with pytest.raises(RuntimeError):
        load_jax_params(model, params)
