"""The port's wavefront multi-layer LSTM forward
(``caiman_asr_tpu_torch/ops/wavefront.py`` over the plain version of K8-fwd)
against the JAX package's ``run_lstm_stack_wavefront`` in interpret mode, on
the same weights (carried over with ``export/from_jax.lstm_layers_from_jax``)
and the same inputs made with numpy from a seed.

Tolerances are the JAX package's own for the wavefront
(``tests/ops/test_pallas_wavefront.py``): fp32 2e-5 (sums in another
order); bf16 2e-2 (the port rounds layer 0's input product to bf16 before
its fp32 bias add, the JAX package after it, and a rounding that falls the
other way is carried through the following steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.ops.lstm import init_lstm_layer
from caiman_asr_tpu.ops.pallas_wavefront import run_lstm_stack_wavefront as jax_wavefront
from caiman_asr_tpu_torch.export.from_jax import lstm_layers_from_jax
from caiman_asr_tpu_torch.ops import wavefront_kernel
from caiman_asr_tpu_torch.ops.wavefront import dropout_masks, run_lstm_stack_wavefront

B, H, I0 = 5, 32, 24  # B and I0 unaligned


def make_stack(seed, G, I0=I0):
    """fp32 numpy weights; both packages cast them to the compute dtype."""
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    return [jax.tree.map(np.asarray, init_lstm_layer(keys[l], I0 if l == 0 else H, H))
            for l in range(G)]


def inputs(seed, G, T, state_scale=0.0, I0=I0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, I0)).astype(np.float32)
    h0 = (rng.normal(size=(G, B, H)) * state_scale).astype(np.float32)
    c0 = (rng.normal(size=(G, B, H)) * state_scale).astype(np.float32)
    return x, h0, c0


def both(params, x, h0, c0, dtype=(torch.float32, jnp.float32), **kw):
    """(port, JAX) outputs of the wavefront on the same numbers."""
    tdt, jdt = dtype
    got = run_lstm_stack_wavefront(
        lstm_layers_from_jax(params), torch.from_numpy(x).to(tdt),
        torch.from_numpy(h0).to(tdt), torch.from_numpy(c0).to(tdt), **kw)
    want = jax_wavefront([jax.tree.map(jnp.asarray, p) for p in params],
                         jnp.asarray(x, jdt), jnp.asarray(h0, jdt), jnp.asarray(c0, jdt),
                         interpret=True, **kw)
    return got, want


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("hard", [False, True])
def test_forward_matches_jax(G, hard):
    x, h0, c0 = inputs(G, G, 11)
    got, want = both(make_stack(0, G), x, h0, c0, hard=hard, t_blk=4)
    for g, w in zip(got, want):
        assert g.shape == (G, 11, B, H)
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=2e-5, atol=2e-5)


def test_nonzero_state_and_odd_t_blk():
    x, h0, c0 = inputs(7, 2, 9, state_scale=0.3, I0=H)
    got, want = both(make_stack(3, 2, I0=H), x, h0, c0, t_blk=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=2e-5, atol=2e-5)


def test_bf16_forward_matches_jax():
    x, h0, c0 = inputs(8, 3, 10, state_scale=0.2)
    got, want = both(make_stack(4, 3), x, h0, c0,
                     dtype=(torch.bfloat16, jnp.bfloat16))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(g), _f32(w), atol=2e-2)


def _port_stack(G, T=6, I0=I0):
    params = lstm_layers_from_jax(make_stack(5, G, I0=I0))
    x, h0, c0 = (torch.from_numpy(a) for a in inputs(9, G, T, 0.1, I0=I0))
    return params, x, h0, c0


@pytest.mark.parametrize("case", ["inner_width", "dropout_without_generator", "t_blk"])
def test_rejections(case):
    params, x, h0, c0 = _port_stack(3)
    kw = {}
    if case == "inner_width":
        params[2] = dict(params[2], w_ih=torch.zeros(4 * H, H + 8))
    elif case == "dropout_without_generator":
        kw = dict(dropout=0.1)
    else:
        kw = dict(t_blk=0)
    with pytest.raises(ValueError):
        run_lstm_stack_wavefront(params, x, h0, c0, **kw)


def test_dropout_masks_follow_the_generator():
    """The same seed gives the same output and another seed another; the
    kept share is near 1 - rate and every kept scale is 1/(1 - rate)."""
    params, x, h0, c0 = _port_stack(3)
    run = lambda seed: run_lstm_stack_wavefront(
        params, x, h0, c0, dropout=0.5, generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[0], run_lstm_stack_wavefront(params, x, h0, c0)[0][0])  # layer 0 raw
    m = dropout_masks(3, 6, B, H, 0.5, torch.float32, torch.Generator().manual_seed(0), "cpu")
    assert m.shape == (2, 6, B, H) and set(m.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (m != 0).float().mean() < 0.6


def test_rate_zero_draws_nothing_and_launches_nothing_on_the_cpu():
    params, x, h0, c0 = _port_stack(2)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    before = (wavefront_kernel.lstm_wavefront.launches,
              wavefront_kernel.lstm_wavefront_sg.launches)
    ys, _ = run_lstm_stack_wavefront(params, x, h0, c0, dropout=0.0, generator=gen)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(ys, run_lstm_stack_wavefront(params, x, h0, c0)[0])
    assert (wavefront_kernel.lstm_wavefront.launches,
            wavefront_kernel.lstm_wavefront_sg.launches) == before
