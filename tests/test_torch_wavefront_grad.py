"""Gradients of the port's wavefront multi-layer LSTM
(``caiman_asr_tpu_torch/ops/wavefront.py`` ``WavefrontLSTM`` over the plain
versions of K8-fwd and K8-bwd) against ``jax.grad`` of the JAX package's
``run_lstm_stack_wavefront`` in interpret mode, on the same weights and
inputs made with numpy from a seed; the wavefront against the port's own
per-layer stack; and each plain twin against a direct per-layer composition
of the single-layer plain versions.

Tolerances are the JAX package's own for the wavefront
(``tests/ops/test_pallas_wavefront.py``): fp32 2e-5 forward and 5e-4 for
gradients (the gradients are sums over the whole reverse recurrence and over
T·B rows, taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.ops.lstm import init_lstm_layer
from caiman_asr_tpu.ops.pallas_wavefront import run_lstm_stack_wavefront as jax_wavefront
from caiman_asr_tpu_torch.export.from_jax import lstm_layers_from_jax
from caiman_asr_tpu_torch.ops import lstm_kernel
from caiman_asr_tpu_torch.ops import wavefront_kernel as wk
from caiman_asr_tpu_torch.ops.lstm import run_lstm_layer
from caiman_asr_tpu_torch.ops.wavefront import (
    WavefrontLSTM, run_lstm_stack_wavefront, stack_operands,
)

T, B, H, I0 = 7, 5, 32, 24
FWD_TOL, GRAD_TOL = 2e-5, 5e-4
LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh")


def make_stack(seed, G):
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    return [jax.tree.map(np.asarray, init_lstm_layer(keys[l], I0 if l == 0 else H, H))
            for l in range(G)]


def arrays(seed, G, state_scale=0.2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, I0)).astype(np.float32)
    h0 = (rng.normal(size=(G, B, H)) * state_scale).astype(np.float32)
    c0 = (rng.normal(size=(G, B, H)) * state_scale).astype(np.float32)
    wy = rng.normal(size=(G, T, B, H)).astype(np.float32)
    wc = rng.normal(size=(G, T, B, H)).astype(np.float32)
    return x, h0, c0, wy, wc


def torch_leaves(params, x, h0, c0):
    """The port's layer dicts and x, h0, c0, each a leaf that wants a gradient."""
    layers = lstm_layers_from_jax(params)
    for p in layers:
        for t in p.values():
            t.requires_grad_()
    return layers, *(torch.from_numpy(a).requires_grad_() for a in (x, h0, c0))


def flat_grads(layers, *tensors):
    return [p[k].grad for p in layers for k in LEAVES] + [t.grad for t in tensors]


def jax_flat(g_params, *g_rest):
    return [g[k] for g in g_params for k in LEAVES] + list(g_rest)


def assert_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("store_gates", [True, False])
def test_every_gradient_matches_jax(G, store_gates):
    params = make_stack(7, G)
    x, h0, c0, wy, wc = arrays(8, G)

    def jloss(p, x, h0, c0):
        ys, cs = jax_wavefront(p, x, h0, c0, t_blk=4, interpret=True, store_gates=store_gates)
        return jnp.sum(ys * wy) + jnp.sum(cs * wc)

    jp = [jax.tree.map(jnp.asarray, p) for p in params]
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jp, jnp.asarray(x), jnp.asarray(h0),
                                                 jnp.asarray(c0))
    layers, xt, h0t, c0t = torch_leaves(params, x, h0, c0)
    ys, cs = run_lstm_stack_wavefront(layers, xt, h0t, c0t, store_gates=store_gates)
    ((ys * torch.from_numpy(wy)).sum() + (cs * torch.from_numpy(wc)).sum()).backward()
    assert_grads(flat_grads(layers, xt, h0t, c0t), jax_flat(*want))


def test_dropout_matches_jax_on_its_masks():
    """The JAX test's masks, built from its keys, fed to ``WavefrontLSTM``:
    the outputs and the gradients of the weights and x agree."""
    G, rate = 3, 0.4
    params = make_stack(13, G)
    x, h0, c0, _, _ = arrays(14, G, state_scale=0.0)
    rngs = [jax.random.PRNGKey(100 + i) for i in range(G - 1)]
    masks = np.stack([np.asarray(jnp.where(jax.random.bernoulli(k, 1.0 - rate, (T, B, H)),
                                           1.0 / (1.0 - rate), 0.0)) for k in rngs])

    def jloss(p, x):
        ys, cs = jax_wavefront(p, x, jnp.asarray(h0), jnp.asarray(c0), t_blk=4,
                               dropout=rate, rngs=rngs, interpret=True)
        return jnp.sum(ys * 0.01) + jnp.sum(cs * 0.02), ys

    jp = [jax.tree.map(jnp.asarray, p) for p in params]
    (_, jys), want = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    layers, xt, h0t, c0t = torch_leaves(params, x, h0, c0)
    ys, cs = WavefrontLSTM.apply(*stack_operands(layers, xt, h0t, c0t),
                                 torch.from_numpy(masks.astype(np.float32)), False, True)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=FWD_TOL, atol=FWD_TOL)
    (ys.sum() * 0.01 + cs.sum() * 0.02).backward()
    assert_grads(flat_grads(layers, xt), jax_flat(*want))


def test_last_layer_only_cotangent():
    """As an encoder uses it: the loss reads only the top layer's output."""
    G = 2
    params = make_stack(20, G)
    x, h0, c0, _, _ = arrays(21, G, state_scale=0.0)

    def jloss(p):
        ys, _ = jax_wavefront(p, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), t_blk=4,
                              interpret=True)
        return jnp.sum(jnp.tanh(ys[-1]))

    want = jax.grad(jloss)([jax.tree.map(jnp.asarray, p) for p in params])
    layers, xt, h0t, c0t = torch_leaves(params, x, h0, c0)
    ys, _ = run_lstm_stack_wavefront(layers, xt, h0t, c0t)
    torch.tanh(ys[-1]).sum().backward()
    assert_grads(flat_grads(layers), jax_flat(want))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dropout", [False, True])
def test_wavefront_matches_the_per_layer_stack(G, dropout):
    """The port's wavefront against its own per-layer ``run_lstm_layer``
    stack with the masks applied between layers, fp32, forward and every
    gradient."""
    params = make_stack(30 + G, G)
    x, h0, c0, wy, wc = arrays(31, G)
    masks = None
    if dropout and G > 1:
        rng = np.random.default_rng(32)
        masks = torch.from_numpy(
            np.where(rng.random((G - 1, T, B, H)) < 0.7, 1 / 0.7, 0.0).astype(np.float32))

    def loss(ys, cs):
        return (ys * torch.from_numpy(wy)).sum() + (cs * torch.from_numpy(wc)).sum()

    layers, xt, h0t, c0t = torch_leaves(params, x, h0, c0)
    ys, cs = WavefrontLSTM.apply(*stack_operands(layers, xt, h0t, c0t), masks, False, True)
    loss(ys, cs).backward()
    got = flat_grads(layers, xt, h0t, c0t)

    ref_layers, rx, rh0, rc0 = torch_leaves(params, x, h0, c0)
    out, all_y, all_c = rx, [], []
    for l, p in enumerate(ref_layers):
        if l > 0 and masks is not None:
            out = out * masks[l - 1]
        y, c = run_lstm_layer(p, out, rh0[l], rc0[l])
        all_y.append(y)
        all_c.append(c)
        out = y
    ref_ys, ref_cs = torch.stack(all_y), torch.stack(all_c)
    torch.testing.assert_close(ys, ref_ys, rtol=FWD_TOL, atol=FWD_TOL)
    torch.testing.assert_close(cs, ref_cs, rtol=FWD_TOL, atol=FWD_TOL)
    loss(ref_ys, ref_cs).backward()
    for g, w in zip(got, flat_grads(ref_layers, rx, rh0, rc0)):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def _twin_inputs(G, with_masks, seed=40):
    rng = np.random.default_rng(seed)
    mk = lambda *shape, s=1.0: torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))
    gx = mk(T, B, 4 * H, s=0.5)
    biases = mk(max(G - 1, 1), 4 * H, s=0.1)
    w0 = mk(4 * H, H, s=1 / np.sqrt(3 * H))
    w_cats = mk(G - 1, 4 * H, 2 * H, s=1 / np.sqrt(6 * H))
    h0, c0 = mk(G, B, H, s=0.1), mk(G, B, H, s=0.1)
    masks = (torch.from_numpy(np.where(rng.random((G - 1, T, B, H)) < 0.8, 1.25, 0.0)
                              .astype(np.float32)) if with_masks else None)
    return gx, biases, w0, w_cats, h0, c0, masks


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("with_masks", [False, True])
def test_plain_twins_match_a_per_layer_composition(G, with_masks):
    """K8-fwd's plain version against layer after layer of
    ``lstm_recurrence_sg_plain`` (an inner layer's gates_x being
    ``x @ w_ih^T + bias``); K8-bwd's against ``lstm_recurrence_bwd_plain``
    from the top layer down, each layer's dys taking the masked
    ``dgates^{l+1} @ w_ih^{l+1}`` from the layer above; fp32."""
    gx, biases, w0, w_cats, h0, c0, masks = _twin_inputs(G, with_masks)
    ys, cs, gs = wk.lstm_wavefront_plain(gx, biases, w0, w_cats, h0, c0, masks, False, True)
    w_hh = torch.cat([w0[None], w_cats[:, :, H:]])
    w_ih = w_cats[:, :, :H]
    ref, out = [], None
    for l in range(G):
        if l == 0:
            g_in = gx
        else:
            x = out if masks is None else out * masks[l - 1]
            g_in = x @ w_ih[l - 1].t() + biases[l - 1]
        ref.append(lstm_kernel.lstm_recurrence_sg_plain(g_in, w_hh[l], h0[l], c0[l], False))
        out = ref[-1][0]
    for k, got in enumerate((ys, cs, gs)):
        torch.testing.assert_close(got, torch.stack([r[k] for r in ref]), rtol=FWD_TOL,
                                   atol=FWD_TOL)

    rng = np.random.default_rng(41)
    dys = torch.from_numpy(rng.normal(size=(G, T, B, H)).astype(np.float32))
    dcs = torch.from_numpy((rng.normal(size=(G, T, B, H)) * 0.3).astype(np.float32))
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    dg, dh0, dc0 = wk.lstm_wavefront_bwd_plain(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih,
                                               False)
    ref = [None] * G
    for l in reversed(range(G)):
        dy = dys[l]
        if l < G - 1:
            above = ref[l + 1][0] @ w_ih[l]
            dy = dy + (above if masks is None else above * masks[l])
        ref[l] = lstm_kernel.lstm_recurrence_bwd_plain(gs[l], c_prev[l], cs[l], dy, dcs[l],
                                                       w_hh[l], False)
    for k, got in enumerate((dg, dh0, dc0)):
        torch.testing.assert_close(got, torch.stack([r[k] for r in ref]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
