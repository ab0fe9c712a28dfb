"""The port's LSTM training path (``caiman_asr_tpu_torch/ops/lstm_kernel.py``
K3a / K3b plain versions and ``LSTMRecurrence``, ``ops/lstm.py`` train-mode
``run_lstm``) against the JAX package's Pallas recurrence in interpret mode,
on the same inputs made with numpy from a seed.

Tolerances: fp32 2e-5 forward and 5e-5 for gradients (sums in another
order; the gradients are sums over the whole reverse recurrence); bf16 2e-2
of the largest magnitude (the compute dtype rounds gates, states and
dgates, and a rounding that falls the other way on one side is carried
through the following steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.ops.lstm import init_lstm
from caiman_asr_tpu.ops.lstm import run_lstm as jax_run_lstm
from caiman_asr_tpu.ops.pallas_lstm import _pallas_recurrence
from caiman_asr_tpu.ops.pallas_lstm import lstm_recurrence as jax_lstm_recurrence
from caiman_asr_tpu_torch.ops import lstm_kernel
from caiman_asr_tpu_torch.ops.lstm import run_lstm

T, B, H = 8, 8, 32  # T a multiple of the Pallas block of 4
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(dtype_name, scale=1.0, grad=False):
    if dtype_name == "float32":
        return (5e-5 if grad else 2e-5) * max(1.0, scale)
    return 2e-2 * max(1.0, scale)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    gx = (rng.normal(size=(T, B, 4 * H)) * 0.8).astype(np.float32)
    w_hh_t = (rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    h0 = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    c0 = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    dys = rng.normal(size=(T, B, H)).astype(np.float32)
    dcs = (rng.normal(size=(T, B, H)) * 0.3).astype(np.float32)
    return gx, w_hh_t, h0, c0, dys, dcs


def _cast(arrays, name):
    tdt, jdt = DTYPES[name]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("hard", [False, True])
def test_store_gates_plain_matches_pallas(inputs, name, hard):
    (gx, w_t, h0, c0), (jgx, jw_t, jh0, jc0) = _cast(inputs[:4], name)
    got = lstm_kernel.lstm_recurrence_sg_plain(gx, w_t.t().contiguous(), h0, c0, hard)
    want = _pallas_recurrence(jgx, jw_t, jh0, jc0, hard=hard, t_blk=4, interpret=True,
                              store_gates=True)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[name][0]
        np.testing.assert_allclose(_f32(g), _f32(w), atol=_tol(name, np.abs(_f32(w)).max()))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("store_gates", [True, False])
def test_recurrence_vjp_matches_jax(inputs, name, hard, store_gates):
    arrays, jarrays = _cast(inputs, name)
    gx, w_t, h0, c0, dys, dcs = arrays
    jgx, jw_t, jh0, jc0, jdys, jdcs = jarrays

    fwd = lambda a, b, c, d: jax_lstm_recurrence(a, b, c, d, hard, 4, True, True)
    (jys, jcs), vjp = jax.vjp(fwd, jgx, jw_t, jh0, jc0)
    j_grads = vjp((jdys, jdcs))

    leaves = [t.clone().requires_grad_() for t in (gx, w_t.t().contiguous(), h0, c0)]
    ys, cs = lstm_kernel.recurrence(*leaves, hard, store_gates)
    grads = torch.autograd.grad((ys, cs), leaves, (dys, dcs))
    for g, w in ((ys, jys), (cs, jcs)):
        np.testing.assert_allclose(_f32(g.detach()), _f32(w), atol=_tol(name))
    want = list(j_grads)
    want[1] = np.asarray(want[1], np.float32).T  # JAX's dW is w.r.t. w_hh^T
    for g, w in zip(grads, want):
        w = _f32(w)
        assert g.dtype == DTYPES[name][0]
        np.testing.assert_allclose(_f32(g), w, atol=_tol(name, np.abs(w).max(), grad=True))


def test_backward_plain_at_t0_and_cpu_dispatch(inputs):
    """An empty sequence gives zero dh0/dc0; CPU tensors launch nothing."""
    gx, w_t, h0, c0, dys, dcs = (torch.from_numpy(a) for a in inputs)
    w = w_t.t().contiguous()
    before = (lstm_kernel.lstm_recurrence_sg.launches, lstm_kernel.lstm_recurrence_bwd.launches)
    dg, dh0, dc0 = lstm_kernel.lstm_recurrence_bwd(gx[:0], c0[None][:0], c0[None][:0],
                                                   dys[:0], dcs[:0], w)
    assert dg.shape == (0, B, 4 * H) and not dh0.any() and not dc0.any()
    leaves = [t.clone().requires_grad_() for t in (gx, w, h0, c0)]
    ys, _ = lstm_kernel.recurrence(*leaves)
    ys.sum().backward()
    assert (lstm_kernel.lstm_recurrence_sg.launches,
            lstm_kernel.lstm_recurrence_bwd.launches) == before


@pytest.fixture(scope="module")
def stack():
    params = init_lstm(jax.random.PRNGKey(4), 16, H, 3)
    x = np.random.default_rng(5).normal(size=(T, B, 16)).astype(np.float32)
    return params, x


def test_train_mode_stack_gradients_match_jax(stack):
    """run_lstm(train=True) without dropout: output and every parameter's
    gradient against jax.grad of the JAX stack (scan path)."""
    params, x = stack
    wy = np.random.default_rng(6).normal(size=(T, B, H)).astype(np.float32)

    def jloss(p):
        out, _, _ = jax_run_lstm(p, jnp.asarray(x), train=True)
        return jnp.sum(out * wy)

    j_grads = jax.grad(jloss)(params)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    out, _, _ = run_lstm(tparams, torch.from_numpy(x), train=True)
    (out * torch.from_numpy(wy)).sum().backward()
    for layer, tensors in tparams.items():
        for k, t in tensors.items():
            want = np.asarray(j_grads[layer][k])
            np.testing.assert_allclose(t.grad.numpy(), want,
                                       atol=5e-5 * max(1.0, np.abs(want).max()))


def test_dropouts_are_inverted_and_seeded(stack):
    """Inter-layer and output dropout keep 1 - p and scale by 1/(1 - p);
    DropConnect masks w_hh; the same generator seed gives the same output;
    off outside training."""
    params, x = stack
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    xt = torch.from_numpy(x)
    run = lambda seed, **kw: run_lstm(tparams, xt, train=True, generator=torch.Generator()
                                      .manual_seed(seed), **kw)[0]
    a, b, c = run(0, dropout=0.5), run(0, dropout=0.5), run(1, dropout=0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = run_lstm(tparams, xt)[0]
    kept = a != 0
    assert 0.35 < kept.float().mean() < 0.65
    assert not torch.equal(run(0, rw_dropout=0.5), plain)
    assert torch.equal(run_lstm(tparams, xt, dropout=0.5, rw_dropout=0.5)[0], plain)
    with pytest.raises(ValueError):
        run_lstm(tparams, xt, train=True, dropout=0.1)


def test_training_a_batch_norm_stack_matches_jax(stack):
    """run_lstm(train=True, bn_updates=...) with batch-norm on every layer:
    the output, every gradient (scale and bias included; the running stats
    get none) and the collected (batch mean, unbiased batch variance) pairs
    against the JAX stack's, at the train-mode tolerances above (the stats
    rtol 1e-5). The recurrent state stays the raw h."""
    params, x = stack
    rng = np.random.default_rng(7)
    jparams = {name: dict(layer, bn={
        "scale": rng.uniform(0.5, 1.5, H).astype(np.float32),
        "bias": (rng.normal(size=H) * 0.1).astype(np.float32),
        "mean": (rng.normal(size=H) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, H).astype(np.float32)})
        for name, layer in params.items()}
    wy = rng.normal(size=(T, B, H)).astype(np.float32)

    def jloss(p):
        updates = []
        out, _, (all_h, _) = jax_run_lstm(p, jnp.asarray(x), train=True, bn_updates=updates)
        return jnp.sum(out * wy), (updates, all_h)

    (want_loss, (want_updates, want_h)), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jparams)
    for layer in tparams.values():
        for k in ("mean", "var"):
            layer["bn"][k].requires_grad_(False)
    updates = []
    out, _, (all_h, _) = run_lstm(tparams, torch.from_numpy(x), train=True, bn_updates=updates)
    loss = (out * torch.from_numpy(wy)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(all_h.detach().numpy(), np.asarray(want_h), atol=2e-5)
    assert len(updates) == len(want_updates) == 3
    for got, want in zip(updates, want_updates):
        for g, w in zip(got, want):
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    for name, layer in tparams.items():
        for k, t in list(layer.items()) + [(f"bn.{k}", v) for k, v in layer["bn"].items()]:
            if k == "bn":
                continue
            if k in ("bn.mean", "bn.var"):
                assert t.grad is None
                continue
            want = np.asarray(j_grads[name]["bn"][k[3:]] if k.startswith("bn.")
                              else j_grads[name][k])
            np.testing.assert_allclose(t.grad.numpy(), want,
                                       atol=5e-5 * max(1.0, np.abs(want).max()), err_msg=k)
    # eval (train=False) uses the running stats and collects nothing
    ev = []
    run_lstm(tparams, torch.from_numpy(x), bn_updates=ev)
    assert ev == []