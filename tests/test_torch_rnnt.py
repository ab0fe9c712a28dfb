"""The port's RNN-T (caiman_asr_tpu_torch/models/rnnt.py) against the JAX
package's, with the JAX parameters carried over by export/from_jax.py, and
the port's config loader against the JAX one. Tolerance 2e-5 absolute
(fp32; LSTM and Linear sums in another order)."""

import dataclasses
from unittest import mock
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.models.config import load_config as jax_load_config
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig, load_config
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.models.state import EncoderState

ATOL = 2e-5
K = 29
TINY = dict(
    in_feats=12, enc_n_hid=16, enc_pre_rnn_layers=2, enc_post_rnn_layers=2,
    enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=16,
)
VARIANTS = {
    "plain": {},
    "hard": {"hard_activations": True},
    "batch_norm": {"enc_batch_norm": True, "pred_batch_norm": True},
}


def _randomize_bn(params, rng):
    for stack in (params["encoder"]["pre_rnn"], params["encoder"]["post_rnn"],
                  params["prediction"]["dec_rnn"]):
        for layer in stack.values():
            if "bn" in layer:
                H = layer["bn"]["mean"].shape[0]
                layer["bn"] = {
                    "scale": jnp.asarray(rng.normal(1.0, 0.2, H), jnp.float32),
                    "bias": jnp.asarray(rng.normal(0.0, 0.2, H), jnp.float32),
                    "mean": jnp.asarray(rng.normal(0.0, 0.5, H), jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, H), jnp.float32),
                }
    return params


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    kw = dict(TINY, **VARIANTS[request.param])
    jm = JaxRNNT(JaxConfig(**kw), K)
    params = _randomize_bn(jm.init(jax.random.PRNGKey(0)), np.random.default_rng(9))
    tm = load_jax_params(RNNT(RNNTModelConfig(**kw), K, device="cpu"),
                         jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_encode(models):
    jm, params, tm = models
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 3, 12)).astype(np.float32)
    lens = np.asarray([12, 9, 5], np.int32)
    f, f_lens, st = jm.encode(params, jnp.asarray(x), jnp.asarray(lens))
    tf, tf_lens, tst = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    _close(tf, f)
    np.testing.assert_array_equal(tf_lens.numpy(), np.asarray(f_lens))
    for a, b in zip(jax.tree.leaves((tst.pre_rnn, tst.post_rnn)),
                    jax.tree.leaves((st.pre_rnn, st.post_rnn))):
        _close(a, b)
    # a carried state: the second chunk continues from the first
    f2, _, _ = jm.encode(params, jnp.asarray(x), jnp.asarray(lens), st)
    tf2, _, _ = tm.encode(torch.from_numpy(x), torch.from_numpy(lens),
                          EncoderState(tst.pre_rnn, tst.post_rnn))
    _close(tf2, f2)


def test_predict(models):
    jm, params, tm = models
    rng = np.random.default_rng(1)
    y = rng.integers(0, K - 1, size=(3, 5)).astype(np.int32)
    g, hid, all_hid = jm.predict(params, jnp.asarray(y))
    tg, thid, tall = tm.predict(torch.from_numpy(y))
    _close(tg, g)
    for a, b in zip((*thid, *tall), (*hid, *all_hid)):
        _close(a, b)
    # a carried state with a gated special SOS
    sos = rng.integers(0, K - 1, size=(3, 1)).astype(np.int32)
    gate = np.asarray([1, 0, 1], np.int32)
    g, _, _ = jm.predict(params, jnp.asarray(y), hid, special_sos=jnp.asarray(sos),
                         sos_gate=jnp.asarray(gate))
    tg, _, _ = tm.predict(torch.from_numpy(y), thid, special_sos=torch.from_numpy(sos),
                          sos_gate=torch.from_numpy(gate))
    _close(tg, g)


def test_pred_step_and_joint(models):
    jm, params, tm = models
    rng = np.random.default_rng(2)
    L, Hp = TINY["pred_rnn_layers"], TINY["pred_n_hid"]
    h = (rng.normal(size=(L, 3, Hp)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(L, 3, Hp)) * 0.3).astype(np.float32)
    tok = np.asarray([0, 5, K - 2], np.int32)
    for token in (None, tok):
        g, (h1, c1) = jm.pred_step(params, None if token is None else jnp.asarray(token),
                                   (jnp.asarray(h), jnp.asarray(c)))
        tg, (th1, tc1) = tm.pred_step(None if token is None else torch.from_numpy(token),
                                      (torch.from_numpy(h), torch.from_numpy(c)))
        for a, b in ((tg, g), (th1, h1), (tc1, c1)):
            _close(a, b)
    f = rng.normal(size=(3, 4, TINY["joint_n_hid"])).astype(np.float32)
    gg = rng.normal(size=(3, 6, TINY["joint_n_hid"])).astype(np.float32)
    _close(tm.joint(torch.from_numpy(f), torch.from_numpy(gg)),
           jm.joint(params, jnp.asarray(f), jnp.asarray(gg)))
    _close(tm.joint_step(torch.from_numpy(f[:, 0]), torch.from_numpy(gg[:, 0])),
           jm.joint_step(params, jnp.asarray(f[:, 0]), jnp.asarray(gg[:, 0])))


def test_quantized_model_is_not_ported():
    """A ``quantize: true`` model is ported: it encodes through the
    quantized scan in fp32, never through the recurrence kernel, and differs
    from the plain model on the same weights (tests/test_torch_quantize.py
    holds it against JAX)."""
    from caiman_asr_tpu_torch.ops import lstm_kernel

    tm = RNNT(RNNTModelConfig(**dict(TINY, quantize=True)), K, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    plain = RNNT(RNNTModelConfig(**TINY), K, device="cpu")
    plain.load_state_dict(tm.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 2, 12)).astype(np.float32))
    lens = torch.tensor([8, 6])
    with mock.patch.object(lstm_kernel, "recurrence", side_effect=AssertionError("K1")):
        enc, enc_lens, _ = tm.encode(x, lens)
    assert enc.dtype == torch.float32 and torch.isfinite(enc).all()
    assert not torch.equal(enc, plain.encode(x, lens)[0])


def test_init_weights_is_seeded():
    cfg = RNNTModelConfig(**TINY)
    a = RNNT(cfg, K, device="cpu").init_weights(torch.Generator().manual_seed(5))
    b = RNNT(cfg, K, device="cpu").init_weights(torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    fb = a.encoder["pre_rnn"].lstm.bias_ih_l0[TINY["enc_n_hid"]:2 * TINY["enc_n_hid"]]
    assert torch.all(fb == 1.0)  # forget-gate bias


@pytest.mark.parametrize(
    "name", ["testing-1023sp.yaml", "base-8703sp.yaml", "large-17407sp.yaml"])
def test_load_config_matches_jax(name):
    full = Path(__file__).resolve().parents[1] / "configs" / name
    want = jax_load_config(full)
    got = load_config(full)
    assert dataclasses.asdict(got.rnnt) == dataclasses.asdict(want.cfg.rnnt)
    for pipe in ("input_train", "input_val"):
        g, w = getattr(got, pipe), getattr(want.cfg, pipe)
        assert dataclasses.asdict(g.logmel) == dataclasses.asdict(w.logmel)
        assert dataclasses.asdict(g.splicing) == dataclasses.asdict(w.splicing)
    assert got.stats_path == want.stats_path
