"""The port's LSTM (caiman_asr_tpu_torch/ops/lstm.py) against the JAX
package's scan path and its Pallas kernel (interpret mode on the CPU), on the
same parameters and inputs made with numpy from a seed.

Tolerances: fp32 2e-5, as the JAX package's own Pallas-vs-scan test; bf16
2e-2 against the Pallas kernel, which rounds the input projection to bf16
once where the port rounds the product and then the biased sum.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.ops.lstm import init_lstm, init_lstm_layer
from caiman_asr_tpu.ops.lstm import lstm_step as jax_lstm_step
from caiman_asr_tpu.ops.lstm import run_lstm as jax_run_lstm
from caiman_asr_tpu.ops.lstm import run_lstm_layer as jax_run_lstm_layer
from caiman_asr_tpu.ops.pallas_lstm import run_lstm_layer_pallas
from caiman_asr_tpu_torch.ops import lstm_kernel
from caiman_asr_tpu_torch.ops.lstm import lstm_step, run_lstm, run_lstm_layer

T, B, I, H = 10, 8, 16, 32  # T=10: not a multiple of the Pallas t_blk of 4


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.fixture(scope="module")
def layer():
    params = init_lstm_layer(jax.random.PRNGKey(0), I, H)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, B, I)).astype(np.float32)
    h0 = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    c0 = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    return params, x, h0, c0


@pytest.mark.parametrize("hard", [False, True])
def test_run_lstm_layer_fp32(layer, hard):
    params, x, h0, c0 = layer
    ys, cs = run_lstm_layer(
        to_torch(params), torch.from_numpy(x), torch.from_numpy(h0),
        torch.from_numpy(c0), hard=hard,
    )
    scan = jax_run_lstm_layer(params, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                              hard=hard)
    pallas = run_lstm_layer_pallas(params, jnp.asarray(x), jnp.asarray(h0),
                                   jnp.asarray(c0), hard=hard, t_blk=4, interpret=True)
    for ref_ys, ref_cs in (scan, pallas):
        np.testing.assert_allclose(ys.numpy(), np.asarray(ref_ys), atol=2e-5)
        np.testing.assert_allclose(cs.numpy(), np.asarray(ref_cs), atol=2e-5)


@pytest.mark.parametrize("hard", [False, True])
def test_run_lstm_layer_bf16_matches_pallas(layer, hard):
    params, x, h0, c0 = layer
    bf = torch.bfloat16
    ys, cs = run_lstm_layer(
        to_torch(params), torch.from_numpy(x).to(bf), torch.from_numpy(h0).to(bf),
        torch.from_numpy(c0).to(bf), hard=hard,
    )
    assert ys.dtype == cs.dtype == bf
    ref_ys, ref_cs = run_lstm_layer_pallas(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(h0, jnp.bfloat16),
        jnp.asarray(c0, jnp.bfloat16), hard=hard, t_blk=4, interpret=True,
    )
    np.testing.assert_allclose(ys.float().numpy(), np.asarray(ref_ys, np.float32), atol=2e-2)
    np.testing.assert_allclose(cs.float().numpy(), np.asarray(ref_cs, np.float32), atol=2e-2)


def _bn_stack(n_layers):
    params = init_lstm(jax.random.PRNGKey(1), I, H, n_layers, batch_norm=True)
    rng = np.random.default_rng(1)
    for i in range(n_layers):  # eval batch-norm that is not the identity
        params[f"layer_{i}"]["bn"] = {
            "scale": jnp.asarray(rng.normal(1.0, 0.2, H), jnp.float32),
            "bias": jnp.asarray(rng.normal(0.0, 0.2, H), jnp.float32),
            "mean": jnp.asarray(rng.normal(0.0, 0.5, H), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 2.0, H), jnp.float32),
        }
    return params


@pytest.mark.parametrize("batch_norm", [False, True])
def test_run_lstm_stack(layer, batch_norm):
    _, x, _, _ = layer
    L = 3
    params = _bn_stack(L) if batch_norm else init_lstm(jax.random.PRNGKey(2), I, H, L)
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(L, B, H)) * 0.1).astype(np.float32)
    c = (rng.normal(size=(L, B, H)) * 0.1).astype(np.float32)
    out, (h_n, c_n), (all_h, all_c) = run_lstm(
        to_torch(params), torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c))
    )
    ref = jax_run_lstm(params, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    for got, want in zip((out, h_n, c_n, all_h, all_c), (ref[0], *ref[1], *ref[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("hard,batch_norm", [(False, False), (True, False), (False, True)])
def test_lstm_step(layer, hard, batch_norm):
    L = 2
    params = _bn_stack(L) if batch_norm else init_lstm(jax.random.PRNGKey(3), I, H, L)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, I)).astype(np.float32)
    h = (rng.normal(size=(L, B, H)) * 0.1).astype(np.float32)
    c = (rng.normal(size=(L, B, H)) * 0.1).astype(np.float32)
    got = lstm_step(to_torch(params), *(torch.from_numpy(a) for a in (x, h, c)), hard=hard)
    want = jax_lstm_step(params, *(jnp.asarray(a) for a in (x, h, c)), hard=hard)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_cpu_tensors_take_the_plain_version(layer):
    """On the CPU the wrapper is the plain version and launches nothing."""
    params, x, h0, c0 = layer
    tp = to_torch(params)
    gx = torch.from_numpy(x) @ tp["w_ih"].t() + tp["b_ih"] + tp["b_hh"]
    args = (gx, tp["w_hh"], torch.from_numpy(h0), torch.from_numpy(c0), False)
    before = lstm_kernel.lstm_recurrence.launches
    got = lstm_kernel.lstm_recurrence(*args)
    want = lstm_kernel.lstm_recurrence_plain(*args)
    assert lstm_kernel.lstm_recurrence.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_quantize_is_not_ported(layer):
    """The quantized layer is ported (tests/test_torch_quantize.py holds it
    against JAX in full): on this layer it agrees with JAX's to the bit or
    within a few fp32 ulps, and runs without the recurrence kernel."""
    from tests.test_torch_quantize import close_in_bf_steps

    params, x, h0, c0 = layer
    want = jax_run_lstm_layer(params, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                              quantize=True)
    with mock.patch.object(lstm_kernel, "recurrence", side_effect=AssertionError("K1")):
        got = run_lstm_layer(to_torch(params), torch.from_numpy(x), torch.from_numpy(h0),
                             torch.from_numpy(c0), quantize=True)
    for g, w in zip(got, want):
        assert close_in_bf_steps(g.numpy(), w, "quantized layer") == 0
