"""The port's fused LAMB finish (``training/fused_finish.py``, through
``Lamb.update``) against the JAX package's ``fused_lamb_ema_update``.

On the CPU the three passes take their plain versions
(``ops/finish_kernel.py``); the kernels themselves are held against those on
the card (``tests/test_torch_kernel.py``). The same seeded numpy parameters,
EMA, moments and gradients go through both; the JAX optimizer state is read
with ``extract_opt_state``. The cases mirror
``tests/training/test_fused_finish.py``, with its tolerances (rtol 2e-5,
atol 2e-6 on the state, rtol 1e-6 on the gradient norm), then the port's
own: None gradients, an overwrite leaf, a zero-norm leaf, the saturating
counts, raw gradients through the train step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.training.fused_finish import extract_opt_state, fused_lamb_ema_update
from caiman_asr_tpu.training.optimizer import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training.optimizer import build_optimizer, fused_spec_for
from caiman_asr_tpu_torch.training.fused_finish import INT32_MAX
from caiman_asr_tpu_torch.training.optimizer import Lamb, LambState, OptimizerConfig
from caiman_asr_tpu_torch.training.tree import tree_items, tree_map

SPEC = {
    "encoder": {"w": (16, 24), "b": (24,)},
    "prediction": {"w": (8, 12)},
    "joint_fc": {"w": (12, 32), "b": (32,)},
}
FACTORS = {"encoder": 2.0, "prediction": 0.5}
SCHED = dict(warmup_steps=3, hold_steps=4, half_life_steps=5)
RTOL, ATOL, NORM_RTOL = 2e-5, 2e-6, 1e-6


def _np_tree(rng, scale=1.0):
    return {mod: {name: (rng.normal(size=shape) * scale).astype(np.float32)
                  for name, shape in leaves.items()} for mod, leaves in SPEC.items()}


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _grads(tree):
    """The port's gradient map (tree path -> tensor or None)."""
    return {path: None if g is None else torch.from_numpy(np.array(g, np.float32))
            for path, g in tree_items(tree)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _sides(clip_norm=1.0, factors=None, **opt):
    kw = {**SCHED, "clip_norm": clip_norm, **opt}
    tx = build_optimizer(JaxOptConfig(**kw), factors)
    jcfg, jfactors, schedule = fused_spec_for(tx)
    return tx, (jcfg, jfactors, schedule), Lamb(OptimizerConfig(**kw), factors)


def _leaves(tree):
    return {path: np.asarray(leaf, np.float64) for path, leaf in tree_items(tree)}


def assert_close(port, jax_tree, rtol=RTOL, atol=ATOL, what=""):
    got = {path: leaf.numpy().astype(np.float64) for path, leaf in tree_items(port)}
    want = _leaves(jax.tree.map(np.asarray, jax_tree))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path], want[path], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def assert_state_close(port, jax_side, **tol):
    (p, e, state), (jp, je, jopt) = port, jax_side
    adam, sched = extract_opt_state(jopt)
    assert_close(p, jp, what="params", **tol)
    assert_close(e, je, what="ema", **tol)
    assert_close(state.mu, adam.mu, what="mu", **tol)
    assert_close(state.nu, adam.nu, what="nu", **tol)
    assert state.count == int(adam.count) and state.sched_count == int(sched.count)


def _snapshot(p, e, state):
    return [t.clone() for tree in (p, e, state.mu, state.nu) for _, t in tree_items(tree)]


def _assert_bit_equal(a, b, what=""):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y), what


@pytest.mark.parametrize("clip_norm", [1.0, None])
@pytest.mark.parametrize("factors", [None, FACTORS])
def test_the_finish_matches_jax_over_steps(clip_norm, factors):
    tx, (jcfg, jfactors, schedule), opt = _sides(clip_norm, factors)
    rng = np.random.default_rng(0)
    params = _np_tree(rng)
    jp, je, jopt = _jax(params), _jax(params), tx.init(_jax(params))
    p, e = _torch_tree(params), _torch_tree(params)
    state = opt.init(p)
    for step in range(6):
        grads = _np_tree(rng)
        if step == 2:  # big gradients: the clip triggers on both sides
            grads = jax.tree.map(lambda g: g * 100.0, grads)
        jp, je, jopt, jnorm = fused_lamb_ema_update(
            jp, je, jopt, _jax(grads), jnp.asarray(True), jcfg, jfactors, schedule, jcfg.ema)
        state, norm = opt.update(p, e, state, _grads(grads), True, jcfg.ema)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=NORM_RTOL)
        assert_state_close((p, e, state), (jp, je, jopt))
    assert state.count == 6 and state.sched_count == 6


def _one_good_step(seed, clip_norm=1.0, ema_scale=0.9):
    """Both sides after one good step from the same params (EMA scaled)."""
    tx, (jcfg, jfactors, schedule), opt = _sides(clip_norm)
    rng = np.random.default_rng(seed)
    params = _np_tree(rng)
    ema = jax.tree.map(lambda a: a * np.float32(ema_scale), params)
    g1 = _np_tree(rng)
    jside = fused_lamb_ema_update(_jax(params), _jax(ema), tx.init(_jax(params)), _jax(g1),
                                  jnp.asarray(True), jcfg, jfactors, schedule, jcfg.ema)[:3]
    p, e = _torch_tree(params), _torch_tree(ema)
    state, _ = opt.update(p, e, opt.init(p), _grads(g1), True, jcfg.ema)
    assert_state_close((p, e, state), jside)
    return opt, (jcfg, jfactors, schedule), jside, (p, e, state), g1


def test_the_skip_freezes_everything():
    opt, (jcfg, jfactors, schedule), jside, (p, e, state), g1 = _one_good_step(1)
    bad = jax.tree.map(lambda g: g * np.float32(np.nan), g1)
    before = _snapshot(p, e, state)
    new, norm = opt.update(p, e, state, _grads(bad), False, jcfg.ema)
    _assert_bit_equal(_snapshot(p, e, new), before, "a skipped step changed the state")
    assert (new.count, new.sched_count) == (state.count, state.sched_count)
    jp, je, jopt, _ = fused_lamb_ema_update(*jside, _jax(bad), jnp.asarray(False), jcfg,
                                            jfactors, schedule, jcfg.ema)
    assert_state_close((p, e, new), (jp, je, jopt))
    assert float(norm) == 0.0  # nan_to_num: every entry is 0


def test_a_skip_with_inf_gradients_and_no_clip():
    """nan_to_num maps inf to the largest float, whose square overflows the
    second moment to inf: the skip must leave the moments finite."""
    opt, (jcfg, jfactors, schedule), jside, (p, e, state), g1 = _one_good_step(4, None)
    bad = jax.tree.map(lambda g: g * np.float32(np.inf), g1)
    before = _snapshot(p, e, state)
    new, norm = opt.update(p, e, state, _grads(bad), False, jcfg.ema)
    after = _snapshot(p, e, new)
    _assert_bit_equal(after, before, "a skipped step changed the state")
    assert all(bool(torch.isfinite(t).all()) for t in after)
    assert not np.isfinite(float(norm))
    jp, je, jopt, jnorm = fused_lamb_ema_update(*jside, _jax(bad), jnp.asarray(False), jcfg,
                                                jfactors, schedule, jcfg.ema)
    assert_state_close((p, e, new), (jp, je, jopt))
    assert float(norm) == float(jnorm)


def test_non_finite_gradients_do_not_poison_the_state():
    """NaN entries in a good step take nan_to_num's value on both sides."""
    tx, (jcfg, jfactors, schedule), opt = _sides()
    rng = np.random.default_rng(2)
    params = _np_tree(rng)
    grads = _np_tree(rng)
    grads["encoder"]["w"][0, 0] = np.nan
    grads["joint_fc"]["b"][3] = np.nan
    jp, je, jopt, jnorm = fused_lamb_ema_update(
        _jax(params), _jax(params), tx.init(_jax(params)), _jax(grads), jnp.asarray(True), jcfg,
        jfactors, schedule, jcfg.ema)
    p, e = _torch_tree(params), _torch_tree(params)
    state, norm = opt.update(p, e, opt.init(p), _grads(grads), True, jcfg.ema)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=NORM_RTOL)
    assert_state_close((p, e, state), (jp, je, jopt))
    assert all(bool(torch.isfinite(t).all()) for t in _snapshot(p, e, state))


# ------------------------------------------------------------ the port's own
def _port_state(seed, opt=None):
    rng = np.random.default_rng(seed)
    params = _np_tree(rng)
    p, e = _torch_tree(params), _torch_tree(params)
    opt = opt or Lamb(OptimizerConfig(**SCHED), FACTORS)
    return opt, p, e, opt.init(p), _np_tree(rng)


def test_none_gradients_equal_explicit_zeros_to_the_bit():
    runs = []
    for explicit in (False, True):
        opt, p, e, state, grads = _port_state(5)
        g = _grads(grads)
        for path in (("prediction", "w"), ("joint_fc", "b")):
            g[path] = torch.zeros(g[path].shape) if explicit else None
        if not explicit:
            del g[("joint_fc", "b")]  # a missing path is no gradient too
        for _ in range(3):
            state, norm = opt.update(p, e, state, g, True, 0.999)
        runs.append((_snapshot(p, e, state), norm))
    _assert_bit_equal(runs[0][0], runs[1][0], "None gradients differ from zeros")
    assert torch.equal(runs[0][1], runs[1][1])


def test_an_overwrite_leaf_reaches_the_ema():
    opt, p, e, state, grads = _port_state(6)
    path = ("encoder", "b")
    stat = torch.from_numpy(np.random.default_rng(7).normal(size=SPEC["encoder"]["b"])
                            .astype(np.float32))
    e_before = dict(tree_items(e))[path].clone()
    state, _ = opt.update(p, e, state, _grads(grads), True, 0.9, overwrite={path: stat})
    assert torch.equal(dict(tree_items(p))[path], stat)
    want = e_before + (0.1 * (stat - e_before))
    torch.testing.assert_close(dict(tree_items(e))[path], want, rtol=0, atol=1e-6)
    # the other leaves took their update
    opt2, p2, e2, state2, _ = _port_state(6)
    opt2.update(p2, e2, state2, _grads(grads), True, 0.9)
    for (q, a), (_, b) in zip(tree_items(p), tree_items(p2)):
        assert torch.equal(a, b) == (q != path)


def test_a_zero_norm_leaf_takes_trust_one():
    """A zero parameter (||p|| = 0) moves by lr * factor * u: the trust
    ratio falls back to 1, as optax's does."""
    tx, (jcfg, jfactors, schedule), opt = _sides(factors=FACTORS, warmup_steps=0)
    rng = np.random.default_rng(8)
    params = _np_tree(rng)
    params["prediction"]["w"][:] = 0.0
    grads = _np_tree(rng)
    jp, je, jopt, _ = fused_lamb_ema_update(
        _jax(params), _jax(params), tx.init(_jax(params)), _jax(grads), jnp.asarray(True), jcfg,
        jfactors, schedule, jcfg.ema)
    p, e = _torch_tree(params), _torch_tree(params)
    state, _ = opt.update(p, e, opt.init(p), _grads(grads), True, jcfg.ema)
    assert_state_close((p, e, state), (jp, je, jopt))
    path = ("prediction", "w")
    mu, nu = dict(tree_items(state.mu))[path], dict(tree_items(state.nu))[path]
    bc1, bc2 = float(1 - np.float32(0.9)), float(1 - np.float32(0.999))
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-9)  # weight decay times p = 0
    torch.testing.assert_close(dict(tree_items(p))[path], -opt.schedule(0) * 0.5 * u,
                               rtol=1e-5, atol=1e-9)


def test_the_counts_saturate():
    opt, p, e, state, grads = _port_state(9)
    state = LambState(state.mu, state.nu, INT32_MAX, INT32_MAX - 1)
    state, _ = opt.update(p, e, state, _grads(grads), True, 0.999)
    assert (state.count, state.sched_count) == (INT32_MAX, INT32_MAX)
    state, _ = opt.update(p, e, state, _grads(grads), True, 0.999)
    assert (state.count, state.sched_count) == (INT32_MAX, INT32_MAX)
    assert all(bool(torch.isfinite(t).all()) for t in _snapshot(p, e, state))


def test_raw_gradients_equal_cleaned_ones():
    """NaN, inf and None gradients give the state that their cleaned values
    (nan_to_num, zeros) give, to the bit."""
    runs = []
    for cleaned in (False, True):
        opt, p, e, state, grads = _port_state(10)
        g = _grads(grads)
        g[("encoder", "w")][2, 3] = float("nan")
        g[("encoder", "w")][0, 1] = float("inf")
        g[("joint_fc", "w")][4, 4] = float("-inf")
        g[("prediction", "w")] = None
        if cleaned:
            g = {path: torch.zeros(dict(tree_items(p))[path].shape) if t is None
                 else torch.nan_to_num(t) for path, t in g.items()}
        for _ in range(2):
            state, norm = opt.update(p, e, state, g, True, 0.999)
        runs.append((_snapshot(p, e, state), norm))
    _assert_bit_equal(runs[0][0], runs[1][0], "raw gradients differ from cleaned ones")
    assert torch.equal(runs[0][1], runs[1][1])


class _CleaningLamb(Lamb):
    """Lamb that cleans its gradients first, as the train step did before
    it handed them over raw: nan_to_num, zeros for None."""

    def update(self, params, ema_params, state, grads, *args, **kw):
        clean = {path: torch.zeros_like(leaf) if grads.get(path) is None
                 else torch.nan_to_num(grads[path]) for path, leaf in tree_items(params)}
        return super().update(params, ema_params, state, clean, *args, **kw)


def test_raw_gradients_through_the_step_equal_cleaned_ones():
    """The train step hands the optimizer its accumulated gradients as they
    are (a batch-norm model's running stats have none): two steps give the
    state, the loss and the gradient norm that cleaning them first gives, to
    the bit."""
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step
    from tests.test_torch_batch_norm_train import BN
    from tests.test_torch_train_step import BLANK, N_CLASSES, OPT, SCALARS, make_batch, to_torch

    runs = []
    for cls in (Lamb, _CleaningLamb):
        model = RNNT(RNNTModelConfig(**BN), N_CLASSES, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        opt = cls(OptimizerConfig(**OPT), model.param_lr_factors())
        state = init_train_state(model, opt, device="cpu")
        step = make_train_step(model, opt, BLANK, device="cpu")
        rng = np.random.default_rng(11)
        metrics = []
        for _ in range(2):
            state, m = step(state, to_torch(make_batch(rng)), None, SCALARS)
            metrics.append((float(m["loss"]), float(m["grad_norm"]), m["skipped"]))
        runs.append((_snapshot(state.params, state.ema_params, state.opt_state), metrics))
    assert runs[0][1] == runs[1][1] and runs[0][1][-1][2] == 0
    _assert_bit_equal(runs[0][0], runs[1][0], "the step's raw gradients differ from cleaned ones")
